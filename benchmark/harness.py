"""Runs one cell of the port's benchmark once and prints its result.

Set-up, inside `setup_s`: build the program's kernel, generate the data
from the seed (datasets/), load it through the program's DDL and bulk
load and pre-split its regions, start the program's MySQL server in
this process over its mock store, start the load process (loadgen.py),
which warms every statement of the cell's mix. The window then runs for
`--seconds`; with `--trace 1` the card is profiled and the host sampled
through it. After the window the device's peak memory is read, the
program is shut down and freed, and only then does the plain reference
(reference/<dataset>/<statement>.py) judge every answer. Every metric is
read by its own file (metrics/<name>.py) from the run's Readings; the
last line of standard output is the result.

Statement records are (name, send, recv, rows, error), as loadgen.py
makes them.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
import subprocess
import sys
import time

from benchmark import catalog, devtrace, loadgen
from benchmark.yardstick import percentile

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "tidb_tpu")
READY_TIMEOUT_S = 900.0
DONE_GRACE_S = 120.0
# the counters the per-layer metrics read (the program's metric names)
COUNTERS = ("tidb_tpu_hbm_cache_hits_total", "tidb_tpu_hbm_cache_misses_total")


def process_start() -> float:
    """This process's start on the time.perf_counter() clock, from
    /proc/self/stat; the interpreter's own clock where that is not
    there."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        up = time.clock_gettime(time.CLOCK_BOOTTIME)
        return time.perf_counter() - (up - started)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _counter_totals(snapshot: dict) -> dict:
    return {name: sum(v for k, v in snapshot.items()
                      if k == name or k.startswith(name + "{"))
            for name in COUNTERS}


def _digest_totals(meter, digests: set) -> dict:
    out = {"slot_wait_ns": 0, "statements": 0}
    for rec in meter.digests_snapshot():
        if rec["digest"] in digests:
            out["slot_wait_ns"] += rec["slot_wait_ns"]
            out["statements"] += rec["statements"]
    return out


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Readings:
    """What the metrics read (metrics/<name>.py)."""

    def __init__(self):
        self.setup_s = 0.0        # process start to the window's start
        self.window_s = 0.0       # the measured window's length
        self.latencies = []       # s, every analytic statement sent in it
        self.analytic = []        # records answered right within it
        self.input_rows = 0       # their base-table rows
        self.counters = {}        # counter deltas over the window
        self.h2d_bytes = 0        # host->device bytes over the window
        self.slot_wait = {}       # analytic digests' meter deltas
        self.ring = []            # retained trace records, analytic only
        self.device_ops = None    # (name, start, end) in the traced window
        self.traced_s = 0.0       # the traced window's length
        self.segsum_shapes = {}   # launches by shape over the window
        self.card = ""


class Run:
    """One run of one cell. `device` is "cuda" for a measured run; the
    CPU tests pass "cpu" and a small `scale`."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", scale: float | None = None):
        self.t_proc = process_start()
        self.cell = catalog.Cell(cell)
        self.cfg = dict(self.cell.config)
        if scale is not None:
            self.cfg["scale_factor"] = scale
        self.traffic = self.cell.traffic
        self.seed, self.seconds, self.trace = seed, float(seconds), trace
        self.device = device
        self.mix = [(n, self.cell.statement(n))
                    for n in self.traffic["analytic"]["statements"]]

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    # -- set-up -------------------------------------------------------------

    def _plan(self, port: int) -> dict:
        an = self.traffic["analytic"]
        clients = [{"offset": i % len(self.mix)}
                   for i in range(int(an["clients"]))]
        return {"port": port, "db": self.cfg["database"],
                "statements": self.mix, "clients": clients,
                "warm_runs": int(an["warm_runs"])}

    def execute(self) -> dict:
        import torch

        from tidb_tpu_torch import config as pconfig
        from tidb_tpu_torch import meter, metrics, perfschema
        from tidb_tpu_torch import trace as ptrace
        from tidb_tpu_torch.ops import runtime, segsum
        from tidb_tpu_torch.server import Server
        from tidb_tpu_torch.session import Session
        from tidb_tpu_torch.store.storage import new_mock_storage

        dev = torch.device(self.device)
        if dev.type == "cuda":
            t0 = time.perf_counter()
            segsum.build()
            self.log(f"build: segsum ready in {time.perf_counter() - t0:.3f}"
                     " s (the first run in a checkout compiles it)")
        t0 = time.perf_counter()
        data = self.cell.dataset.generate(self.cfg, self.seed)
        for name, value in self.cfg.get("sysvars", {}).items():
            pconfig.set_var(name, value)
        if self.trace:
            # retain every statement's span tree in the trace ring
            pconfig.set_var("tidb_tpu_trace_sample", 1)
        storage = new_mock_storage(device=dev)
        sess = Session(storage)
        loaded = self.cell.dataset.load(sess, storage, data, self.cfg,
                                        self.traffic["tables"])
        sess.close()
        self.log(f"setup: generated and loaded {loaded} in "
                 f"{time.perf_counter() - t0:.3f} s")
        server = Server(storage, port=0)
        server.start()
        mp = multiprocessing.get_context("spawn")
        parent, child = mp.Pipe()
        proc = mp.Process(target=loadgen.child_main,
                          args=(self._plan(server.port), child),
                          name="bench-load")
        proc.start()
        child.close()
        try:
            out = self._window(parent, proc, dev, meter, metrics, perfschema,
                               ptrace, runtime, segsum, torch)
        finally:
            if proc.is_alive():
                proc.join(DONE_GRACE_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
            parent.close()
        # the program's state goes before the reference runs
        server.close()
        del sess, server, storage
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return self._judge(out, data)

    def _recv(self, parent, proc, timeout: float):
        deadline = time.perf_counter() + timeout
        while not parent.poll(0.5):
            if not proc.is_alive() and not parent.poll(0):
                raise RuntimeError("the load process ended without a result "
                                   f"(exit code {proc.exitcode})")
            if time.perf_counter() > deadline:
                raise TimeoutError(f"no word from the load process in "
                                   f"{timeout:.0f} s")
        msg = parent.recv()
        if msg[0] == "error":
            raise RuntimeError("the load process failed:\n" + msg[1])
        return msg

    def _window(self, parent, proc, dev, meter, metrics, perfschema, ptrace,
                runtime, segsum, torch):
        _, warm = self._recv(parent, proc, READY_TIMEOUT_S)
        digests = {perfschema.sql_digest(sql)[0] for _n, sql in self.mix}
        tracer = sampler = None
        if self.trace:
            sampler = devtrace.HostSampler()
            sampler.start()
            if dev.type == "cuda":
                tracer = devtrace.DeviceTrace()
                tracer.start()
        start_at = time.perf_counter() + 0.5
        stop_at = start_at + self.seconds
        parent.send((start_at, stop_at))
        time.sleep(max(0.0, start_at - time.perf_counter()))
        w0 = time.time_ns()
        c0 = (_counter_totals(metrics.snapshot()), runtime.put_bytes(),
              _digest_totals(meter, digests), dict(segsum.shape_launches))
        time.sleep(max(0.0, stop_at - time.perf_counter()))
        w1 = time.time_ns()
        c1 = (_counter_totals(metrics.snapshot()), runtime.put_bytes(),
              _digest_totals(meter, digests), dict(segsum.shape_launches))
        if sampler is not None:
            sampler.stop()
        if tracer is not None:
            tracer.stop()
        _, records = self._recv(parent, proc, self.seconds + DONE_GRACE_S)
        proc.join(DONE_GRACE_S)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        ring = []
        if self.trace:
            sqls = {sql[:512] for _n, sql in self.mix}
            ring = [r for r in ptrace.ring_records() if r["sql"] in sqls
                    and w0 <= r["start_unix"] * 1e9 <= w1]
        return {"start_at": start_at, "stop_at": stop_at, "w0": w0,
                "w1": w1, "warm": warm, "records": records, "c0": c0,
                "c1": c1, "peak": peak, "tracer": tracer,
                "sampler": sampler, "ring": ring}

    # -- judging and reporting ---------------------------------------------

    def _judge(self, out, data) -> dict:
        refs = {n: self.cell.reference(n) for n, _sql in self.mix}
        want = {n: ref.answer(data) for n, ref in refs.items()}
        stop_at = out["stop_at"]
        r = Readings()
        r.setup_s = out["start_at"] - self.t_proc
        r.window_s = stop_at - out["start_at"]
        wrong = unanswered = 0
        for name, _t0, _t1, rows, err in out["warm"]:
            if err is not None:
                unanswered += 1
            elif [tuple(x) for x in rows] != want[name]:
                wrong += 1
        sent = [rec for client in out["records"] for rec in client]
        for rec in sent:
            name, t0, t1, rows, err = rec
            r.latencies.append(t1 - t0)
            if err is not None:
                unanswered += 1
            elif [tuple(x) for x in rows] != want[name]:
                wrong += 1
            elif t1 <= stop_at:
                r.analytic.append(rec)
                r.input_rows += data.counts[refs[name].BASE_TABLE]
        checks = {"wrong_answers": [wrong, 0], "unanswered": [unanswered, 0]}
        p95 = percentile(r.latencies, 95) * 1e3 if r.latencies else 0.0
        self.log(f"window: {len(sent)} analytic statements sent (the "
                 f"latency samples, p95 {p95!r} ms), {len(r.analytic)} "
                 f"answered right within {r.window_s:.3f} s")
        line = {"correct": all(v <= lim for v, lim in checks.values()),
                "attempted": len(sent),
                "failed": sum(1 for rec in sent if rec[4] is not None),
                "metrics": {}, "device": self._device(out)}
        if self.trace:
            self._traced(out, r, line)
        for m in self.cell.per_layer if self.trace else self.cell.end_to_end:
            value = catalog.metric_reader(m["name"])(r)
            if value is not None:
                line["metrics"][m["name"]] = {"value": value,
                                              "unit": m["unit"]}
        line["checks"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in checks.items()}
        return line

    def _device(self, out) -> dict:
        if self.device != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        import torch
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(out["peak"]),
                "power_limit": _power_limit()}

    def _traced(self, out, r, line) -> None:
        """The traced run's readings, and `busy_s`, `window_s` and the
        `breakdown` in the line."""
        c0, c1 = out["c0"], out["c1"]
        r.counters = {k: c1[0][k] - c0[0][k] for k in COUNTERS}
        r.h2d_bytes = c1[1] - c0[1]
        r.slot_wait = {k: c1[2][k] - c0[2][k] for k in c1[2]}
        r.segsum_shapes = {k: v - c0[3].get(k, 0) for k, v in c1[3].items()
                           if v - c0[3].get(k, 0)}
        r.ring = out["ring"]
        dev = line["device"]
        r.card = f"{dev['kind']}, {dev.get('power_limit', '')}"
        tracer = out["tracer"]
        if tracer is not None:
            r.device_ops = tracer.clipped(out["w0"], out["w1"])
            busy = devtrace.busy_intervals(r.device_ops)
            dev["busy_s"] = sum(e - s for s, e in busy) / 1e9
            dev["window_s"] = r.traced_s = (out["w1"] - out["w0"]) / 1e9
            line["breakdown"] = devtrace.breakdown(
                r.device_ops, out["w0"], out["w1"], out["sampler"])
