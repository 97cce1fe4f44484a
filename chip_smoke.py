"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--sf 10] [--seed 42]

Phases, one JSON line each:
  env     torch and CUDA versions, the card's name and power limit
  build   builds every hand-written kernel from the sources in the repo,
          with ptxas's registers and spills per variant and the atomic
          instructions of the SASS
  q1      TPC-H Q1's aggregation (tidb_tpu_torch.executor.agg.run_q1) at
          scale factor --sf, cold (with transfers) and hot (columns resident
          on the card), each held exactly against a numpy truth; the
          kernels' launch counts are read around each run
  kernel  each kernel against its plain torch version on the card, over
          dtypes, masks and shapes (checked before q1), then its device
          time at the main path's shapes
          (tidb_tpu_torch/benchmarks/segsum_bench.py: Q1's own calls, and
          the same calls with spread ids) beside its host time per call,
          the plain version, one PyTorch library call and the bound; timed
          after q1, since launches slow down in a process that
          torch.profiler has traced
  kernels one line listing every kernel with its parity and times
The card's name and power limit (as nvidia-smi gives them) stand on a
line of their own, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero, before that line. Without CUDA, or
without the rest of the repository beside it, it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
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


def run_q1_phase(args, dev) -> dict:
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.executor.agg import run_q1
    from tidb_tpu_torch.ops import segsum
    t0 = time.perf_counter()
    d = tpch.ScaledTpch(args.sf, args.seed)
    chunks = tpch.lineitem_chunks(d, 1 << 18)
    gen_s = time.perf_counter() - t0
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
        segsum.launches = 0
        res = run_q1(device=dev, chunks=chunks)
        launches = segsum.launches
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
        out["profile_hot"] = profile_q1(chunks, dev)
        # fresh Chunk objects carry no device memo: every column copies
        out["profile_cold"] = profile_q1([Chunk(c.columns) for c in chunks],
                                         dev)
    return out


def profile_q1(chunks, dev) -> dict:
    """One more Q1 run under torch.profiler: device time by kernel, host
    time by op, and the device's busy share of the run's wall time (the
    profiler's own overhead is in that wall time)."""
    from torch.profiler import ProfilerActivity, profile
    from tidb_tpu_torch.executor.agg import run_q1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_q1(device=dev, chunks=chunks)
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
                         for us, k, c in host[:12]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of Q1's lineitem (default 10)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", action="store_true",
                    help="add one hot Q1 run under torch.profiler")
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
    q1 = run_q1_phase(args, dev)
    emit(q1)

    from tidb_tpu_torch.benchmarks import segsum_bench
    q1_inputs = segsum_bench.q1_inputs(dev)
    shapes = {"q1": q1_inputs,
              "spread": segsum_bench.spread_inputs(q1_inputs)}
    timing = {name: segsum_bench.time_shape(inputs)
              for name, inputs in shapes.items()}
    emit({"phase": "kernel", "name": "segment_sum", **parity,
          "timing": timing})

    emit({"kernels": [{
        "name": f"segment_sum ({name} ids)", "route": "cuda",
        "source": "tidb_tpu_torch/csrc/segsum.cu",
        "replaces": "tidb_tpu/ops/pallas_agg.py:147",
        "launches": q1["cold"]["segsum_launches"],
        "max_abs_err": parity["max_abs_err"],
        "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]} for name, t in timing.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
