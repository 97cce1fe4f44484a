"""The port's bench entry: TPC-H Q1/Q3/Q5 end to end, rows/s per card,
and the JAX package's other `bench.py` legs.

    python -m tidb_tpu_torch.bench [--sf 1] [--iters 5] [--host-iters 2]
        [--seed 42] [--regions 4] [--device cuda] [--no-skew] [--no-serve]
        [--no-htap] [--no-chaos] [--no-kernel-micro]
    python -m tidb_tpu_torch.bench LEG [flags] [--device cuda]

The bare form is the port of `bench.py: main`, the north-star line. It
loads ScaledTpch into the port's `Session` on one mock store, then for
each query runs it with `tidb_tpu_device = 1` (one cold run that fills
the chunk and HBM caches, then the best of `iters` warm runs) and with
`tidb_tpu_device = 0` (the numpy host path, one fill run, then the best
of `host_iters`), on the same store. The two modes must return equal
rows (floats within 1e-9 relative), or the run exits non-zero. It prints
one JSON line with `bench.py`'s keys:

  * `metric`: tpch_q1_q3_q5_e2e_rows_per_sec_per_chip, `value` the
    geomean over the queries of the device path's input rows/s;
  * `unit`: rows/s; `vs_baseline`: the geomean of device/host speedups;
  * `detail`: per query the device and host seconds and rows/s,
    `device_scan_gbps` (input bytes in the columnar layout over the warm
    seconds) and `roofline_fraction` against the card's peak
    (`profiler.HBM_PEAK_GBPS`), cold/warm split, HBM cache traffic,
    superchunks and kernel launches; the iteration counts and the
    coprocessor mode (`copr_stream`: 1 streamed, 0 materialized); the
    card's `nvidia-smi` name and power limit; and the reference's
    blocks, each on unless its `--no-*` flag is given: `skew_join`
    (benchmarks/skewjoin.py, on the same store), `serve`, `htap`,
    `chaos` (each on a store of its own) and
    `kernel_only_q1_rows_per_sec` (benchmarks/kernelmicro.py). A block
    that raises is recorded as `<block>_error` (`kernel_only_error` for
    the micro); the line is still printed, and the run then exits 1
    (the reference exits 0).

LEG is one of serve, fleet, encoded, chaos, trace, profile, lintcheck,
multichip and htap: `benchmarks/<module>.run` with the flags of `LEGS`
(the reference's BENCH_* knobs, one for one, with their defaults),
printing `bench.py`'s line for that leg (the same `metric`, `unit`,
`value`, `vs_baseline` where the reference has it, and `detail`). After
printing it, the leg exits 1 when its `benchmarks/contracts.check_<leg>`
(the port of `scripts/<leg>_bench.sh`'s assertions, lintcheck's from
`scripts/lint_device_bench.sh`) fails, and names each failure on
stderr; the reference leaves that check to its script.

Unlike `bench.py`, it never falls back to the CPU: without CUDA it
exits non-zero unless `--device cpu` is given. It keeps no compile
cache (the reference's is XLA's) and runs no device prober. `run(...)`
takes a loaded session and store, so a caller (chip_smoke.py) can time
the same store it already holds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from tidb_tpu_torch.benchmarks.common import (geomean, hbm_counters,
                                              progress_printer, query_bytes,
                                              rows_equal, time_query)

__all__ = ["KEYS", "LEGS", "rows_equal", "run", "run_leg", "main"]

METRIC = "tpch_q1_q3_q5_e2e_rows_per_sec_per_chip"
# the keys of bench.py's JSON line
KEYS = ("metric", "value", "unit", "vs_baseline", "detail")

def card() -> dict | None:
    """The card as `nvidia-smi` names it: name and power limit (None
    where there is no nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    name, _, limit = out.rpartition(",")
    return {"nvidia_smi": out, "name": name.strip(),
            "power_limit": limit.strip()}


def _superchunks(session) -> dict:
    coll = session.last_collector
    ops = [o for o in coll.ops() if o.loops] if coll is not None else []
    fill = sum(o.superchunk_fill_rows for o in ops)
    bucket = sum(o.superchunk_bucket_rows for o in ops)
    return {"count": sum(o.superchunks for o in ops),
            "coalesced_chunks": sum(o.coalesced_chunks for o in ops),
            "fill_ratio": round(fill / bucket, 4) if bucket else 0.0,
            "pipeline_stall_ns": sum(o.pipeline_stall_ns for o in ops)}


def run(session, storage, data, iters: int = 5, host_iters: int = 2,
        progress=None) -> dict:
    """Time Q1/Q3/Q5 on a loaded `session` over `storage` (tables of
    `data`, a ScaledTpch) in both modes. -> bench.py's line as a dict.
    Raises RuntimeError when the device and host rows differ. Leaves
    `tidb_tpu_device` as it found it."""
    from tidb_tpu_torch import config, profiler
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.ops import segsum

    def note(msg):
        if progress is not None:
            progress(msg)

    iters, host_iters = max(1, int(iters)), max(1, int(host_iters))
    roof_gbps, roof_src = profiler.platform_peak_gbps()
    detail: dict = {
        "sf": data.sf, "iters": iters, "host_iters": host_iters,
        # 1 streamed (the default), 0 the materialized coprocessor: the
        # two read a selection region differently, and their rows/s differ
        "copr_stream": int(session.sys_vars.get(
            "tidb_tpu_copr_stream",
            config.get_var("tidb_tpu_copr_stream"))),
        "device": str(storage.device),
        "baseline_kind": "measured numpy host executor (the port's "
                         "tidb_tpu_device = 0 path, same plans and store)",
        "memory_roofline_gbps": round(roof_gbps, 1),
        "memory_roofline_source": roof_src,
        "host_cpus": os.cpu_count(), "card": card()}
    speedups, device_rps, rooflines = [], [], []
    prev = config.get_var("tidb_tpu_device")
    try:
        for qname, sql in tpch.QUERIES.items():
            in_rows = sum(data.counts[t] for t in tpch.QUERY_TABLES[qname])
            in_bytes = query_bytes(data, qname)
            config.set_var("tidb_tpu_device", 1)
            hbm0 = hbm_counters()
            launches0 = segsum.launches
            t0 = time.perf_counter()
            session.query(sql)     # chunk + HBM cache fill
            cold = time.perf_counter() - t0
            sc = _superchunks(session)
            hbm_cold = hbm_counters()
            note(f"{qname}: device cold {cold:.3f}s")
            d_secs, d_rows = time_query(session, sql, iters)
            hbm_warm = hbm_counters()
            launches = segsum.launches - launches0
            config.set_var("tidb_tpu_device", 0)
            session.query(sql)     # the same cache fill for the host
            h_secs, h_rows = time_query(session, sql, host_iters)
            note(f"{qname}: device best {d_secs:.4f}s, host best "
                 f"{h_secs:.4f}s")
            if not rows_equal(d_rows, h_rows):
                raise RuntimeError(
                    f"{qname}: device and host disagree: {d_rows[:3]} vs "
                    f"{h_rows[:3]}")
            d_rps, h_rps = in_rows / d_secs, in_rows / h_secs
            d_gbps = in_bytes / d_secs / 1e9
            speedups.append(d_rps / h_rps)
            device_rps.append(d_rps)
            rooflines.append(d_gbps / roof_gbps)
            detail[qname] = {
                "input_rows": in_rows, "input_bytes": in_bytes,
                "device_secs": d_secs, "host_secs": h_secs,
                "device_rows_per_sec": d_rps, "host_rows_per_sec": h_rps,
                "device_scan_gbps": d_gbps,
                "roofline_fraction": d_gbps / roof_gbps,
                "speedup": d_rps / h_rps,
                "cold_secs": cold, "warm_secs": d_secs,
                "cold_rows_per_sec": in_rows / cold,
                "hbm_cache": {
                    "cold": {k: hbm_cold[k] - hbm0[k] for k in hbm0},
                    "warm": {k: hbm_warm[k] - hbm_cold[k] for k in hbm0}},
                "segsum_launches": launches,
                "result_rows": len(d_rows),
                "superchunk": sc}
    finally:
        config.set_var("tidb_tpu_device", prev)
    detail["hbm_cache_totals"] = hbm_counters()
    detail["roofline_fraction_geomean"] = geomean(rooflines)
    return {"metric": METRIC, "value": geomean(device_rps),
            "unit": "rows/s", "vs_baseline": geomean(speedups),
            "detail": detail}


# LEG -> (module under benchmarks/, its flags: (name, type, default))
LEGS = {
    "serve": ("serve", (("clients", int, 8), ("rounds", int, 2),
                        ("lookups", int, 8), ("sf", float, 0.02))),
    "fleet": ("fleetbench", (("servers", int, 4), ("clients", int, 8),
                             ("rounds", int, 2), ("lookups", int, 8),
                             ("sf", float, 0.02))),
    "encoded": ("encoded", (("sf", float, 0.05), ("iters", int, 3))),
    "chaos": ("chaos", (("seed", int, 20260804), ("clients", int, 4),
                        ("secs", float, 15.0), ("sf", float, 0.01),
                        ("writes_per_sec", float, 25.0),
                        ("timeout_ms", int, 3000),
                        ("stuck_secs", float, 90.0))),
    "trace": ("tracing", (("sf", float, 0.02), ("iters", int, 3),
                          ("lookups", int, 16))),
    "profile": ("profiling", (("sf", float, 0.02), ("iters", int, 3))),
    "lintcheck": ("lintcheck", (("sf", float, 0.02), ("iters", int, 2))),
    "multichip": ("multichip", (("devs", "ints", "1,2,4,8"),
                                ("sf", float, 0.05), ("iters", int, 3),
                                ("serve_rounds", int, 32))),
    "htap": ("htap", (("rows", int, 60000), ("secs", float, 5.0),
                      ("rates", "ints", "0,20,100"))),
}


def _ints(text: str) -> tuple:
    return tuple(int(x) for x in str(text).split(",") if x.strip())


def run_leg(leg: str, progress=None, device="cuda", **knobs) -> tuple:
    """Run one leg. -> (its line, the contract's failures)."""
    import importlib
    from tidb_tpu_torch.benchmarks import contracts
    mod = importlib.import_module(
        f"tidb_tpu_torch.benchmarks.{LEGS[leg][0]}")
    line = mod.line(mod.run(progress, device=device, **knobs))
    return line, contracts.check(leg, line)


def _resolve(name: str):
    from tidb_tpu_torch.ops.runtime import resolve_device
    try:
        return resolve_device(name)
    except RuntimeError as e:
        print(f"[bench] cannot run: {e}", file=sys.stderr, flush=True)
        return None


def leg_main(leg: str, argv) -> int:
    """`python -m tidb_tpu_torch.bench LEG [flags]`: the leg's line on
    stdout; exit 1 when the leg raised or its contract failed, 2 where
    the device cannot be used."""
    _mod, flags = LEGS[leg]
    p = argparse.ArgumentParser(prog=f"tidb_tpu_torch.bench {leg}")
    for name, typ, default in flags:
        p.add_argument("--" + name.replace("_", "-"),
                       type=_ints if typ == "ints" else typ,
                       default=_ints(default) if typ == "ints" else default)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the port "
                        "on the host, never chosen by itself)")
    args = vars(p.parse_args(argv))
    device = _resolve(args.pop("device"))
    if device is None:
        return 2
    try:
        line, failures = run_leg(leg, progress_printer(leg), str(device),
                                 **args)
    except RuntimeError as e:
        print(f"[{leg}] FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(line), flush=True)
    for f in failures:
        print(f"[{leg}] FAIL: {f}", file=sys.stderr, flush=True)
    return 1 if failures else 0


def _blocks(args, detail, session, storage, data, device, progress) -> None:
    """bench.py's advisory blocks (bench.py:2843-2897) into `detail`;
    a block that raises leaves `<block>_error`."""
    from tidb_tpu_torch.benchmarks import (chaos, htap, kernelmicro, serve,
                                           skewjoin)
    from tidb_tpu_torch.util import failpoint
    dev = str(device)
    blocks = [
        ("skew_join", args.skew, lambda: skewjoin.run(
            session, storage, data.sf, args.iters, args.host_iters,
            progress)),
        ("serve", args.serve, lambda: serve.run(progress, device=dev)),
        ("htap", args.htap, lambda: htap.run(progress, device=dev)),
        ("chaos", args.chaos, lambda: chaos.run(progress, device=dev)),
        ("kernel_only_q1_rows_per_sec", args.kernel_micro,
         lambda: kernelmicro.run(device=dev)["rows_per_sec"]),
    ]
    for key, on, fn in blocks:
        if not on:
            continue
        progress(f"{key}: block")
        try:
            detail[key] = fn()
        except Exception as e:  # noqa: BLE001 - recorded, exits 1 below
            err = "kernel_only_error" if key.startswith("kernel_only") \
                else f"{key}_error"
            detail[err] = f"{type(e).__name__}: {e}"
            progress(f"{key}: raised {detail[err]}")
        finally:
            if key == "chaos":
                failpoint.disable_all()


BLOCK_ERRORS = ("skew_join_error", "serve_error", "htap_error",
                "chaos_error", "kernel_only_error")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in LEGS:
        return leg_main(argv[0], argv[1:])
    p = argparse.ArgumentParser(prog="tidb_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--sf", type=float, default=1.0)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--host-iters", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--regions", type=int, default=4,
                   help="regions per table for lineitem and orders")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the port "
                        "on the host, never chosen by itself)")
    for block in ("skew", "serve", "htap", "chaos", "kernel-micro"):
        p.add_argument(f"--no-{block}", dest=block.replace("-", "_"),
                       action="store_false",
                       help=f"leave out the {block} block")
    args = p.parse_args(argv)
    device = _resolve(args.device)
    if device is None:
        return 2
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage

    progress = progress_printer("bench")
    progress(f"generating TPC-H sf={args.sf} on {device}")
    data = tpch.ScaledTpch(args.sf, args.seed)
    storage = new_mock_storage(device=device)
    session = Session(storage)
    try:
        session.execute("CREATE DATABASE tpch")
        session.execute("USE tpch")
        t0 = time.perf_counter()
        total = tpch.load(session, storage, data,
                          regions_per_table=args.regions)
        load_secs = time.perf_counter() - t0
        progress(f"loaded {total} rows in {load_secs:.1f}s")
        line = run(session, storage, data, args.iters, args.host_iters,
                   progress)
        line["detail"].update(rows_loaded=total, load_secs=load_secs)
        _blocks(args, line["detail"], session, storage, data, device,
                progress)
    except RuntimeError as e:
        print(f"[bench] {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        session.close()
        storage.close()
    print(json.dumps(line), flush=True)
    errors = [k for k in BLOCK_ERRORS if k in line["detail"]]
    for k in errors:
        print(f"[bench] FAIL: {k}: {line['detail'][k]}", file=sys.stderr,
              flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
