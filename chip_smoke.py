"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--sf 10] [--seed 42] [--profile]

Phases, one JSON line each:
  env     torch and CUDA versions, the card's name and power limit
  build   builds every hand-written kernel from the sources in the repo,
          with ptxas's registers and spills per variant and the atomic
          instructions of the SASS
  q1      TPC-H Q1's aggregation (tidb_tpu_torch.executor.agg.run_q1) at
          scale factor --sf, cold (with transfers) and hot (columns resident
          on the card), each held exactly against a numpy truth; the
          kernels' launch counts are read around each run
  q3, q5  TPC-H Q3 and Q5 (run_q3, run_q5) at the same scale factor over
          the same generated tables, twice each, held exactly against
          numpy truths (Q3 in every group before its TopN too); the phase
          asserts the segment-sum kernel launched, the lineitem join took
          the hybrid path, Q5's fused fragment dispatched, no fallback, and
          no host sync inside the first JoinKernel / ProbeAggKernel /
          HashAggKernel dispatch of the run
  kernel  each kernel against its plain torch version on the card, over
          dtypes, masks and shapes (checked before q1); then, at every
          shape the cold Q1 run and the first Q3 and Q5 runs gave it (their
          calls recorded by segsum_bench.record_calls), held again on those
          very inputs and timed: device time beside its host time per
          call, the plain version, one PyTorch library call and the bound;
          timed after the queries, since launches slow down in a process
          that torch.profiler has traced
  kernels one line listing every kernel at each of those shapes, with its
          launches there on its path, its parity and its times
With --profile, each of q1, q3 and q5 adds torch.profiler tables of one
more run: device time by kernel, host time by op, device idle share.
The card's name and power limit (as nvidia-smi gives them) stand on a
line of their own, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero, before that line. Without CUDA, or
without the rest of the repository beside it, it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def segsum_case(rng, dtype, n, k, c, mask, dev, ids=None):
    """Inputs for one parity case: ids with ~2% out of range (or `ids`
    as given), int64 values near 2^60, NaN under dead masks for float
    lanes."""
    if ids is None:
        ids = rng.integers(0, c, n).astype(np.int32)
        bad = rng.random(n) < 0.02
        ids[bad] = rng.choice(np.array([-1, c, c + 5, -(1 << 30)],
                                       np.int32), int(bad.sum()))
    if dtype == torch.int64:
        vals = rng.integers((1 << 60) - (1 << 40), 1 << 60, (n, k))
        vals[rng.random((n, k)) < 0.5] *= -1
    else:
        vals = rng.normal(size=(n, k)) * 1e3
    valid = None
    if mask == "row":
        valid = rng.random(n) < 0.7
        dead = ~valid[:, None] & np.ones((n, k), bool)
    elif mask == "lane":
        valid = rng.random((n, k)) < 0.7
        dead = ~valid
    if valid is not None and dtype != torch.int64:
        vals = np.where(dead & (rng.random((n, k)) < 0.3), np.nan, vals)
    v = torch.from_numpy(vals).to(dev, dtype)
    i = torch.from_numpy(np.asarray(ids, np.int32)).to(dev)
    m = None if valid is None else torch.from_numpy(valid).to(dev)
    return v, i, m


def hold(got, v, i, c, m, where, worst) -> None:
    """One parity check against segment_sum_plain: int64 exactly
    (two's-complement wrap included); float64 within 1e-12 and float32
    within 1e-5 of each segment's sum of |v| (atomic order varies from
    run to run)."""
    from tidb_tpu_torch.ops import segsum
    want = segsum.segment_sum_plain(v, i, c, valid=m)
    torch.cuda.synchronize()
    if v.dtype == torch.int64:
        if not torch.equal(got, want):
            raise AssertionError(f"segsum {where}: int64 sums differ")
        return
    if not torch.isfinite(got).all():
        raise AssertionError(f"segsum {where}: NaN/inf")
    scale = segsum.segment_sum_plain(torch.nan_to_num(v).abs(), i, c,
                                     valid=m)
    rtol = 1e-5 if v.dtype == torch.float32 else 1e-12
    err = (got - want).abs()
    if bool((err > rtol * scale + 1e-30).any()):
        raise AssertionError(f"segsum {where}: max err {err.max().item()} "
                             "over tolerance")
    name = str(v.dtype).removeprefix("torch.")
    worst[name] = max(worst[name], err.max().item())


def edge_ids(case, n, c, window):
    """Ids of the cases that aim at the kernel's warp grouping, the dead
    slot C-1 and the edge of the table's window of W slots."""
    r = np.arange(n)
    if case == "one id per warp":
        return np.full(n, min(3, c - 1))
    if case == "alternating":
        return r % min(2, c)
    if case == "all at C-1":
        return np.full(n, c - 1)
    if case == "window edge":
        near = np.array([window - 2, window - 1, window, window + 1,
                         c - 2, c - 1, 0, -1, c])
        return np.where(r % 3 == 0, near[r % near.size],
                        np.clip(window - 32 + r % 64, -1, c))
    raise ValueError(case)


def check_segsum(dev) -> dict:
    """The kernel vs segment_sum_plain on the card, with the tolerances of
    `hold`, all through segment_sum and its own launch plan. First the 109
    cases of the first version; then edge cases: ids grouped in warps, at
    C-1 and on both sides of the window W (at C = 4096 and at C = W + 1),
    K in {1, 3, 5, 12, 13}, n around the tile and the warp, C = 1 and
    C = 2^20 (no table fits)."""
    from tidb_tpu_torch.ops import segsum
    rng = np.random.default_rng(2026)
    worst = {"float32": 0.0, "float64": 0.0, "int64": 0}
    cases = 0
    for dtype in (torch.float32, torch.float64, torch.int64):
        for n in (1000, 1 << 18, 1 << 20):
            for k in (1, 12):
                for c in (6, 4096):
                    for mask in ("none", "row", "lane"):
                        v, i, m = segsum_case(rng, dtype, n, k, c, mask, dev)
                        got = segsum.segment_sum(v, i, c, valid=m)
                        hold(got, v, i, c, m, f"{dtype} n={n} k={k} c={c} "
                             f"mask={mask}", worst)
                        cases += 1
    # 1-D values -> 1-D result
    v, i, m = segsum_case(rng, torch.int64, 5000, 1, 6, "row", dev)
    got = segsum.segment_sum(v[:, 0].contiguous(), i, 6, valid=m)
    assert got.shape == (6,)
    assert torch.equal(got, segsum.segment_sum_plain(v[:, 0], i, 6, m))
    cases += 1

    modes = {"none": 0, "row": 1, "lane": 2}
    for dtype in (torch.float32, torch.float64, torch.int64):
        for mask, mode in modes.items():
            def plan(k, c):
                return segsum.plan_for(dtype, c, k, mode, dev)

            def run(n, k, c, ids=None, label=""):
                nonlocal cases
                if callable(ids):
                    ids = ids(n, c, plan(k, c).window)
                v, i, m = segsum_case(rng, dtype, n, k, c, mask, dev, ids)
                got = segsum.segment_sum(v, i, c, valid=m)
                hold(got, v, i, c, m, f"{dtype} {label} n={n} k={k} "
                     f"c={c} mask={mask} {plan(k, c)}", worst)
                cases += 1
            for case in ("one id per warp", "alternating", "all at C-1",
                         "window edge"):
                run(20000, 12, 4096, lambda n, c, w, case=case:
                    edge_ids(case, n, c, w), case)
            run(5000, 12, 16, lambda n, c, w: edge_ids(
                "one id per warp", n, c, w), "one id per warp")
            run(20000, 12, plan(12, 4096).window + 1, lambda n, c, w:
                edge_ids("window edge", n, c, w), "window edge")
            for k in (1, 3, 5, 12, 13):
                tile = plan(k, 4096).tile
                for n in (1, 31, 33, tile - 1, tile + 1, 3 * tile + 5):
                    run(n, k, 4096)
            run(3000, 5, 1)
            run(1 << 16, 12, 1 << 20)
            run(1 << 16, 12, 1 << 20, lambda n, c, w: edge_ids(
                "window edge", n, c, w), "window edge")
    return {"cases": cases, "max_abs_err": max(worst.values()),
            "max_abs_err_by_dtype": worst}


def build_phase(root: str) -> dict:
    """Builds the kernel with nvcc from the repo's source, then reports
    what ptxas gave each variant and the atomic instructions in its SASS
    (cuobjdump, where the toolkit has it)."""
    from tidb_tpu_torch.ops import segsum
    t0 = time.perf_counter()
    lib = segsum.build(force=True)
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "kernels": {"segsum": str(lib.relative_to(root))},
           "ptxas": segsum.ptxas_report(segsum.build_log)}
    if not out["ptxas"]:
        raise AssertionError("no ptxas report for the segsum variants:\n"
                             + segsum.build_log)
    from tidb_tpu_torch.benchmarks import segsum_bench
    out["sass_atomics"] = segsum_bench.sass_atomics(lib)
    return out


def sync_free_dispatch(chunk, dev) -> None:
    """One Q1 dispatch (transfer included) under sync-debug "error": any
    host sync inside dispatch raises."""
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.chunk import Chunk
    from tidb_tpu_torch.ops.hashagg import kernel_for
    k = kernel_for(*tpch.q1_plan(), device=dev)
    fresh = Chunk(chunk.columns)             # no device memo: transfers
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = k.dispatch(fresh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    k.finalize(fresh, pending)


def generate(args):
    """ScaledTpch(--sf) once, and the scan chunks of all six tables, shared
    by the q1, q3 and q5 phases. -> (data, tables, seconds)."""
    from tidb_tpu_torch.benchmarks import tpch
    t0 = time.perf_counter()
    d = tpch.ScaledTpch(args.sf, args.seed)
    tables = tpch.table_chunks(d, tpch.QUERY_TABLES["q5"], 1 << 18)
    return d, tables, time.perf_counter() - t0


def run_q1_phase(args, dev, d, chunks, gen_s, recorded) -> dict:
    """Q1 cold and hot; the cold run's segment_sum calls go to
    recorded["q1"] (segsum_bench.record_calls)."""
    from tidb_tpu_torch.benchmarks import segsum_bench, tpch
    from tidb_tpu_torch.executor.agg import run_q1
    from tidb_tpu_torch.ops import segsum
    t0 = time.perf_counter()
    truth = tpch.q1_truth(d)
    truth_s = time.perf_counter() - t0
    nrows = d.counts["lineitem"]
    sync_free_dispatch(chunks[0], dev)
    out = {"phase": "q1", "sf": args.sf, "seed": args.seed,
           "lineitem_rows": nrows, "superchunk_rows": 1 << 18,
           "superchunks": len(chunks), "generate_s": gen_s,
           "truth_s": truth_s, "sync_free_dispatch": True}
    for name in ("cold", "hot"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with (segsum_bench.record_calls() if name == "cold"
              else contextlib.nullcontext()) as rec:
            segsum.launches = 0
            res = run_q1(device=dev, chunks=chunks)
            launches = segsum.launches
        if rec is not None:
            recorded["q1"] = recorded_path("q1", rec, launches)
        if res.rows != truth:
            raise AssertionError(f"q1 {name}: rows differ from the numpy "
                                 f"truth:\n{res.rows}\n{truth}")
        if launches <= 0:
            raise AssertionError(f"q1 {name}: segment-sum kernel never "
                                 "launched")
        if res.stats.fallbacks:
            raise AssertionError(f"q1 {name}: {res.stats.fallbacks} "
                                 "host fallbacks")
        out[name] = {"seconds": res.seconds,
                     "rows_per_s": nrows / res.seconds,
                     "segsum_launches": launches,
                     "device_batches": res.stats.device_batches,
                     "host_batches": res.stats.host_batches,
                     "fallbacks": res.stats.fallbacks,
                     "max_memory_allocated": torch.cuda.max_memory_allocated(
                         dev)}
    out["rows"] = [[str(x) for x in r] for r in truth]
    if args.profile:
        from tidb_tpu_torch.chunk import Chunk
        out["profile_hot"] = profile_run(
            lambda: run_q1(device=dev, chunks=chunks))
        # fresh Chunk objects carry no device memo: every column copies
        out["profile_cold"] = profile_run(lambda: run_q1(
            device=dev, chunks=[Chunk(c.columns) for c in chunks]))
    return out


class SyncFreeFirstDispatch:
    """Runs the first call of each wrapped `dispatch` method under
    torch.cuda.set_sync_debug_mode("error"), so a host sync inside it
    raises; records which classes were checked."""

    def __init__(self, *classes):
        self.classes = classes
        self.checked = []

    def __enter__(self):
        self.saved = [(cls, cls.dispatch) for cls in self.classes]
        for cls, orig in self.saved:
            def wrapped(obj, *a, _cls=cls, _orig=orig, **kw):
                if _cls.__name__ in self.checked:
                    return _orig(obj, *a, **kw)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = _orig(obj, *a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                self.checked.append(_cls.__name__)
                return out
            cls.dispatch = wrapped
        return self

    def __exit__(self, *exc):
        for cls, orig in self.saved:
            cls.dispatch = orig
        return False


def recorded_path(path, rec, launches):
    """A run's recorded segment_sum calls, which must account for every
    launch of the run."""
    if rec.calls() != launches:
        raise AssertionError(f"{path}: recorded {rec.calls()} segment_sum "
                             f"calls, {launches} launches")
    return rec


def run_query_phase(name, args, dev, d, tables, recorded) -> dict:
    """`name` (q3 or q5) twice over the shared tables, each run held
    exactly against the numpy truth (Q3 also in every group before its
    TopN), with the phase's assertions; the first run's segment_sum
    calls go to recorded[name]."""
    from tidb_tpu_torch.benchmarks import programs_bench, segsum_bench, tpch
    from tidb_tpu_torch.executor import agg
    from tidb_tpu_torch.ops import fragment, hashagg, join, segsum
    run = {"q3": agg.run_q3, "q5": agg.run_q5}[name]
    programs = programs_bench.capture()
    t0 = time.perf_counter()
    truth = {"q3": tpch.q3_truth, "q5": tpch.q5_truth}[name](d)
    groups = tpch.q3_groups_truth(d) if name == "q3" else None
    truth_s = time.perf_counter() - t0
    qtables = {t: tables[t] for t in tpch.QUERY_TABLES[name]}
    nrows = sum(d.counts[t] for t in tpch.QUERY_TABLES[name])
    out = {"phase": name, "sf": args.sf, "seed": args.seed,
           "input_rows": nrows, "superchunk_rows": 1 << 18,
           "truth_s": truth_s, "runs": []}
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with SyncFreeFirstDispatch(join.JoinKernel, fragment.ProbeAggKernel,
                                   hashagg.HashAggKernel) as sync_check, \
                (programs if i == 1 else segsum_bench.record_calls()) as rec:
            segsum.launches = 0
            res = run(device=dev, tables=qtables)
            launches = segsum.launches
        if i == 0:
            recorded[name] = recorded_path(name, rec, launches)
        st = res.stats
        if res.rows != truth:
            raise AssertionError(f"{name} run {i}: rows differ from the "
                                 f"numpy truth:\n{res.rows}\n{truth}")
        if groups is not None and sorted(res.groups) != groups:
            raise AssertionError(
                f"{name} run {i}: the HashAgg's {len(res.groups)} groups "
                f"differ from the numpy truth's {len(groups)}")
        if launches <= 0:
            raise AssertionError(f"{name}: segment-sum kernel never "
                                 "launched")
        if st.join_paths.get("lineitem") != "hybrid":
            raise AssertionError(f"{name}: the lineitem join took "
                                 f"{st.join_paths}, not the hybrid path")
        if name == "q5" and not st.fused_dispatches:
            raise AssertionError("q5: the fused fragment never dispatched")
        if st.fallbacks:
            raise AssertionError(f"{name}: fallbacks {st.fallback_reasons}")
        need = {"JoinKernel"} | ({"ProbeAggKernel"} if name == "q5"
                                 else {"HashAggKernel"})
        if not need <= set(sync_check.checked):
            raise AssertionError(f"{name}: sync-free dispatch checked only "
                                 f"{sync_check.checked}")
        out["runs"].append({
            "seconds": res.seconds, "rows_per_s": nrows / res.seconds,
            "segsum_launches": launches, "groups": len(res.groups),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "host_max_rss_kb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss,
            "sync_free_dispatch": sync_check.checked,
            "stats": {k: v for k, v in vars(st).items()}})
    out["rows"] = [[str(x) for x in r] for r in truth]
    # the torch programs of the second run, replayed at its shapes
    out["programs"] = [
        {"program": prog, "shape": list(shape), "calls_per_run": calls,
         "calls_per_run_all_shapes": sum(
             n for (p2, _s), (_o, _a, n) in programs.calls.items()
             if p2 == prog),
         **programs_bench.time_program(prog, obj, a)}
        for prog, shape, obj, a, calls in programs.most_called()]
    if args.profile:
        out["profile"] = profile_run(lambda: run(device=dev, tables=qtables))
    return out


def profile_run(fn) -> dict:
    """One more run of `fn` (a run_q* call) under torch.profiler and
    cProfile: device time by kernel, host time by torch op and by Python
    function (numpy's work shows under its callers), and the device's busy
    share of the run's wall time (both profilers' overhead is in it)."""
    import cProfile
    import pstats
    from torch.profiler import ProfilerActivity, profile
    py = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        py.enable()
        try:
            res = fn()
        finally:
            py.disable()
    funcs = sorted(((tt, ct, n, f"{os.path.basename(f)}:{line}:{name}")
                    for (f, line, name), (_cc, n, tt, ct, _c)
                    in pstats.Stats(py).stats.items()), reverse=True)
    device, host = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        on_device = getattr(e, "device_type", None) is not None and \
            "CUDA" in str(e.device_type)
        if us > 0 and on_device:
            device.append((us, e.key, e.count))
        elif not on_device and e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total, e.key, e.count))
    device.sort(reverse=True)
    host.sort(reverse=True)
    busy_us = sum(us for us, _k, _c in device)
    wall_us = res.seconds * 1e6
    return {"wall_s": res.seconds, "device_kernels_seen": len(device),
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": max(0.0, 1 - busy_us / wall_us),
            "top": [{"kernel": k[:90], "calls": c, "device_ms": us / 1e3}
                    for us, k, c in device[:12]],
            "top_host": [{"op": k[:60], "calls": c, "self_cpu_ms": us / 1e3}
                         for us, k, c in host[:12]],
            "top_python": [{"function": k[:80], "calls": n, "self_s": tt,
                            "cumulative_s": ct}
                           for tt, ct, n, k in funcs[:20]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor (default 10)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", action="store_true",
                    help="add one more run of each query under "
                         "torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tidb_tpu_torch.ops import segsum     # raises outside the repo

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})

    root = os.path.dirname(os.path.abspath(__file__))
    emit(build_phase(root))

    parity = check_segsum(dev)
    d, tables, gen_s = generate(args)
    recorded = {}
    emit(run_q1_phase(args, dev, d, tables["lineitem"], gen_s, recorded))
    for name in ("q3", "q5"):
        emit(run_query_phase(name, args, dev, d, tables, recorded))

    # the kernel at every shape the three paths gave it, on their own
    # recorded inputs: held against the plain version, then timed
    from tidb_tpu_torch.benchmarks import segsum_bench
    entries = []
    for path, rec in recorded.items():
        for (n, k, c, dtype, mask), ent in rec.shapes.items():
            where = f"{path}: {n}x{k} {dtype}, C={c}, {mask} mask"
            worst = {"float32": 0.0, "float64": 0.0, "int64": 0}
            for v, i, m, _c in ent["inputs"]:
                hold(segsum.segment_sum(v, i, c, valid=m), v, i, c, m,
                     where, worst)
            entries.append((where, path, ent["calls"], max(worst.values()),
                            len(ent["inputs"]),
                            segsum_bench.time_shape(ent["inputs"])))
    emit({"phase": "kernel", "name": "segment_sum", **parity,
          "timing": {where: {"launches": calls, "inputs_held": held, **t}
                     for where, _p, calls, _e, held, t in entries}})

    emit({"kernels": [{
        "name": f"segment_sum ({where})", "route": "cuda",
        "source": "tidb_tpu_torch/csrc/segsum.cu",
        "replaces": "tidb_tpu/ops/pallas_agg.py:147",
        "launches": calls, "path": path, "max_abs_err": err,
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}
        for where, path, calls, err, _h, t in entries]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
