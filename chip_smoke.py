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
          the hybrid path, Q5's fused fragment dispatched, no fallback, no
          host sync inside the first JoinKernel / ProbeAggKernel /
          HashAggKernel dispatch of the run, and the statement's ledger
          back at 0 after it; Q3 then runs once more under
          tidb_tpu_mem_quota_query set from the first run's ledger peak,
          so the hybrid build's quota spill fires: the rows still equal
          the truth, partitions spilled, staged probe rows drained, and
          the ledger reads 0 afterwards
  analyze ANALYZE of six lineitem columns at --sf (60,012,150 rows each
          at SF 10): statistics.build_column_stats sorts each on the card
          (ops/stats.device_sort, one torch.sort); that sort must equal
          np.sort, and the statistics' NDV, NULL count and totals must
          equal np.sort's; per column, the device time of the sort alone,
          the time of the build's device_sort with its transfers, and the
          host time of the rest
  q18     TPC-H Q18's inner block at SF 1 (Q18_SF, or --sf where that is
          smaller): ANALYZE of l_orderkey,
          the NDV rule must pick the stream agg, run_q18_inner's rows and
          every group before the HAVING must equal numpy truths
          (np.bincount); the segment-sum kernel launched, the sorter
          spilled runs to disk, no fallback, no host sync in the first
          SegmentAggKernel dispatch, and the ledger reads 0 afterwards
  store   TPC-H Q1 served from the mock TiKV store at SF 1 (STORE_SF, or
          --sf where smaller): ScaledTpch bulk-loaded (tpch.load_store,
          lineitem and orders in 4 regions), then run_q1_store five times
          at the default sysvars (streaming cop, chunk cache, 2 GiB HBM
          block cache, fused scan, delta store): cold (framed scan and
          decode, a dispatch per frame, chunk-cache fill at the stream's
          end); first warm (one HBM block filled per region, one fused
          dispatch each); second warm (every region a hit, no host->device
          byte); after an OLTP batch of 4,000 updates, 1,000 inserts (one
          with an l_returnflag the block's dictionary lacks) and 1,000
          deletes in one region (that block patched on the card, the rest
          hits); after 4,000 more updates (past tidb_tpu_delta_merge_rows:
          the delta store merges; the written region re-fills, the three
          untouched ones stay hot in both caches). Every run equals
          an exact numpy truth over the mutated arrays and leaves the
          statement's ledger at 0. Between the hot run and the first
          batch, TPC-H Q3 and Q5 from the same store (run_q3_store,
          run_q5_store: TableReader leaves through the coprocessor,
          materialized), cold then warm from the chunk cache, each equal
          to its numpy truth (Q3 in every group before its TopN), with
          their join paths, chunk-cache hits and misses, host->device
          bytes, kernel launches and ledger peak; then the kernel-profile
          registry (profiler.snapshot: dispatches, busy ms, bytes and
          roofline fraction per kernel family against the card's
          datasheet peak). Before them, on a store of its own at
          SF 0.1 (CHECK_SF) fanned out on one thread, the process's first
          fused dispatch and first patch (of a 64-row batch) run under
          sync-debug "error"; the patch's device program (B11) is timed
          by CUDA events, the whole patch by the host clock; the
          hbm-cache ledger node returns to 0 at shed()
  sql     TPC-H Q1, Q3 and Q5 as SQL text through the port's Session
          (tidb_tpu_torch.session) at SF 1 (STORE_SF, or --sf where
          smaller): CREATE DATABASE tpch, USE tpch, tpch.load (the DDL
          through the DDL and meta layers, lineitem and orders in 4
          regions); Q1 cold, warm (HBM fill) and hot, then Q3 and Q5
          cold and warm with the materialized coprocessor; each equal to
          its numpy truth as the session formats it, with the seconds of
          each run, its parse/plan/execute/format split and the load's
          seconds; the phase asserts the segment-sum kernel launched in
          every run, the hot Q1 read 4 HBM hits and no host->device
          byte, Q3's lineitem join took the hybrid path, Q5's fragment
          dispatched fused, no fallback, and every statement's ledger at
          0 after it; its session and store carry on into htap
  htap    writes and transactions through SQL on the sql phase's store
          (htap_phase): TPC-H lineitem batches as SQL (tpch.sql_batch;
          4,000 updates, 1,000 inserts, 1,000 deletes): 500 statements
          rolled back (hot Q1 unmoved: 4 hits, no patch, no H->D byte),
          the batch committed in one transaction (Q1 equal to Q1Mirror's
          truth, the blocks patched on the card; a snapshot from before
          the COMMIT still reads the old truth), 4,000 autocommit UPDATEs
          past the merge threshold (Q1 merged equal to its truth), a
          FOR UPDATE whose COMMIT after a conflicting write raises the
          retryable conflict; the JAX package's HTAP mix
          (benchmarks/htap.py) over HTAP_ROWS stock rows, swept at 0, 20
          and 100 writes/s, its final rows equal to the numpy replay of
          the logged writes and to the host path, a dirty transaction's
          aggregate through the union scan on the card; CREATE INDEX on
          customer (backfill seconds and batches), a covering aggregate
          over IndexReader, a row fetch and an aggregate over
          IndexLookUp, a join on c_custkey that the planner turns into
          IndexJoin or MergeJoin (named), each equal to a numpy truth;
          DROP INDEX, TRUNCATE TABLE stock and one GC tick, which drains
          the delete ranges
  faults  the device plane under injected faults, on Q1 from a store of
          its own at SF 0.1 (CHECK_SF) on one fan-out thread: a dispatch
          fault once (retried on the card, no fallback), then in every
          dispatch for three statements (each degrades to the host with
          `fault` fallbacks; the device is quarantined, its HBM blocks
          shed, the hbm-cache ledger at 0, the third statement served
          under `quarantine`), the quarantine probe readmitting the card
          (blocks refilled, then hit), and the dispatch watchdog at
          tidb_tpu_dispatch_timeout_ms = 120 against a 400 ms finalize
          delay (the retryable DispatchTimeoutError, then a clean replay)
  kernel  each kernel against its plain torch version on the card, over
          dtypes, masks and shapes (checked before q1); then, at every
          shape the cold Q1 run, the first Q3 and Q5 runs, the Q18 run,
          the store's cold, first warm and patched runs and its cold Q3
          and Q5 runs, and the sql phase's cold and warm Q1 and cold Q3
          and Q5 and the htap phase's patched and merged Q1, analytic,
          union-scan, index-reader, index-lookup and index-join
          statements gave it (their calls recorded by
          segsum_bench.record_calls),
          held again on those
          very inputs and timed: device time beside its host time per
          call, the plain version, one PyTorch library call and the bound;
          timed after the queries, since launches slow down in a process
          that torch.profiler has traced
  kernels one line listing every kernel at each of those shapes, with its
          launches there on its path, its parity and its times
With --profile, each of q1, q3 and q5 adds torch.profiler tables of one
more run: device time by kernel, host time by op, device idle share; the
store phase adds one more warm run of its Q3 and Q5 and a hot and a
cold Q1 run so profiled (Q1 fanned out on one thread).
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


# Q18's inner block merges its ~1.5 M groups per scale factor one by one
# on the host (HashAggregator), as the JAX package does: the q18 phase
# runs at SF 1 (SF 1 took 47 s, ANALYZE included; PERF.md), cut from SF 2
# so that the whole smoke, its htap phase included, stays under 16
# minutes on the card
Q18_SF = 1.0

# The store phase loads TPC-H into the mock TiKV store (every KV pair a
# Python object) and decodes each lineitem row of the cold scan on the
# host, so it runs at SF 1 (STORE_SF, or --sf where smaller): the JAX
# package's own scale for this path, where the four resident lineitem
# blocks (2,097,152 padded rows x 12 columns) fit the 2 GiB block cache
STORE_SF = 1.0
# The store phase's host-sync checks run first, on a store of their own
# at this scale factor (or --sf where smaller): sync-debug mode is
# process-wide, so they fan out on one thread, and one-time work they do
# (the host chunks' dictionary encodes, a block's first-patch position
# map) must not land ahead of the timed runs
CHECK_SF = 0.1
# The htap phase's stock table: the JAX package's bench.py htap loads
# 60,000 rows; raised so that the card holds a real block (2^20 rows,
# one region), with the reference's 5 s windows
HTAP_ROWS = 1 << 20
HTAP_WINDOW_S = 5.0
# The sql phase's hot Q1 runs this many rounds of (SQL, run_q1_store) in
# turn over one storage, so that its cost over the store path is told
# apart from the host clock's run-to-run spread
HOT_ROUNDS = 7


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
    """One parity check against segment_sum_plain
    (segsum_bench.parity_error: int64 exactly, float64 within 1e-12 and
    float32 within 1e-5 of each segment's sum of |v|), the worst error
    per dtype kept in `worst`."""
    from tidb_tpu_torch.benchmarks import segsum_bench
    torch.cuda.synchronize()
    err, ok = segsum_bench.parity_error(got, v, i, c, m)
    if not ok:
        raise AssertionError(f"segsum {where}: max err {err} over "
                             "tolerance")
    name = str(v.dtype).removeprefix("torch.")
    worst[name] = max(worst[name], err)


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
    """Runs the first call of each wrapped `dispatch` method (or of the
    method named `method`) under torch.cuda.set_sync_debug_mode("error"),
    so a host sync inside it raises; records which classes were
    checked."""

    def __init__(self, *classes, method="dispatch"):
        self.classes = classes
        self.method = method
        self.checked = []

    def __enter__(self):
        self.saved = [(cls, getattr(cls, self.method))
                      for cls in self.classes]
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
            setattr(cls, self.method, wrapped)
        return self

    def __exit__(self, *exc):
        for cls, orig in self.saved:
            setattr(cls, self.method, orig)
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
        if st.mem_left:
            raise AssertionError(f"{name} run {i}: the statement's ledger "
                                 f"still holds {st.mem_left} bytes")
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
    if name == "q3":
        out["quota_run"] = run_quota(run, dev, qtables, truth,
                                     out["runs"][0]["stats"])
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


def run_quota(run, dev, qtables, truth, first: dict) -> dict:
    """One more run under tidb_tpu_mem_quota_query = the first run's
    ledger peak less a quarter of the device bytes it held at that peak:
    the statement crosses the quota late in its lineitem probe, when the
    hybrid build's cold partitions are resident, and their spill brings
    it back under without a cancel."""
    from tidb_tpu_torch import config, metrics
    quota = first["mem_peak"] - first["mem_device_at_peak"] // 4
    key = metrics.JOIN_SPILL_PARTITIONS
    before = metrics.snapshot().get(key, 0)
    with config.session_overlay({"tidb_tpu_mem_quota_query": quota}):
        res = run(device=dev, tables=qtables)
    st = res.stats
    counted = metrics.snapshot().get(key, 0) - before
    if res.rows != truth:
        raise AssertionError(f"q3 under quota {quota}: rows differ from "
                             f"the numpy truth:\n{res.rows}\n{truth}")
    if st.spilled_partitions <= 0 or counted <= 0:
        raise AssertionError(f"q3 under quota {quota}: no partition "
                             f"spilled ({st.spilled_partitions}, counter "
                             f"{counted})")
    if st.staged_probe_rows <= 0 or \
            st.drained_probe_rows != st.staged_probe_rows:
        raise AssertionError(f"q3 under quota {quota}: staged "
                             f"{st.staged_probe_rows} probe rows, drained "
                             f"{st.drained_probe_rows}")
    if st.mem_left != 0:
        raise AssertionError(f"q3 under quota {quota}: the ledger still "
                             f"holds {st.mem_left} bytes")
    if st.fallbacks:
        raise AssertionError(f"q3 under quota: fallbacks "
                             f"{st.fallback_reasons}")
    return {"quota": quota, "first_peak": first["mem_peak"],
            "first_device_at_peak": first["mem_device_at_peak"],
            "seconds": res.seconds, "mem_peak": st.mem_peak,
            "spilled_partitions": st.spilled_partitions,
            "join_spill_partitions_counted": counted,
            "staged_probe_rows": st.staged_probe_rows,
            "drained_probe_rows": st.drained_probe_rows,
            "join_paths": st.join_paths, "mem_left": st.mem_left}


def analyze_phase(args, dev, tables) -> dict:
    """ANALYZE of six lineitem columns on the card. The sort that each
    build_column_stats call makes on the card must equal np.sort, and the
    statistics' NDV, NULL count and row totals must equal np.sort's
    output (the histogram and CMSketch are held against the JAX package
    in tests/test_torch_stats.py)."""
    from tidb_tpu_torch import statistics
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.ops import stats
    out = {"phase": "analyze", "sf": args.sf, "columns": {}}
    for name in ("l_quantity", "l_discount", "l_tax", "l_shipdate",
                 "l_commitdate", "l_receiptdate"):
        col = tpch.table_column(tables["lineitem"], "lineitem", name)
        # the sort alone, on a column already on the card
        x = torch.from_numpy(stats.pad_for_sort(col.data)).to(dev)
        torch.sort(x)
        t = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t[0].record()
        torch.sort(x)
        t[1].record()
        torch.cuda.synchronize()
        del x
        t0 = time.perf_counter()
        want = np.sort(col.data[col.valid])
        host_sort_s = time.perf_counter() - t0
        # the build's own device_sort call, copies in and out included
        sorts = []
        device_sort = stats.device_sort

        def timed(data, device):
            t0 = time.perf_counter()
            s = device_sort(data, device)
            sorts.append((s, time.perf_counter() - t0))
            return s
        stats.device_sort = timed
        try:
            t0 = time.perf_counter()
            cs = statistics.build_column_stats(col, device=dev)
            build_s = time.perf_counter() - t0
        finally:
            stats.device_sort = device_sort
        if len(sorts) != 1 or not np.array_equal(sorts[0][0], want):
            raise AssertionError(f"analyze {name}: {len(sorts)} device "
                                 "sorts, or the sort differs from np.sort")
        ndv = 1 + int(np.count_nonzero(want[1:] != want[:-1]))
        nulls = int((~col.valid).sum())
        h = cs.hist
        got = (h.ndv, h.null_count, h.total, cs.cms.count)
        if got != (ndv, nulls, want.size, want.size):
            raise AssertionError(f"analyze {name}: ndv, nulls and totals "
                                 f"{got}; np.sort gives {ndv}, {nulls}, "
                                 f"{want.size}")
        out["columns"][name] = {
            "rows": int(col.data.size), "ndv": h.ndv,
            "buckets": h.num_buckets,
            "sort_device_ms": t[0].elapsed_time(t[1]),
            "device_sort_with_transfers_s": sorts[0][1],
            "build_column_stats_s": build_s,
            "host_rest_s": build_s - sorts[0][1], "np_sort_s": host_sort_s}
    return out


def q18_phase(args, dev, d, tables, recorded) -> dict:
    """Q18's inner block at min(--sf, Q18_SF): ANALYZE, the NDV rule,
    StreamAgg over the spill sorter, the HAVING; its segment_sum calls go
    to recorded["q18"]."""
    from tidb_tpu_torch.benchmarks import segsum_bench, tpch
    from tidb_tpu_torch.executor import agg
    from tidb_tpu_torch.ops import segsum, streamagg
    sf = min(args.sf, Q18_SF)
    t0 = time.perf_counter()
    if sf != args.sf:
        d = tpch.ScaledTpch(sf, args.seed)
        tables = tpch.table_chunks(d, ["lineitem"], 1 << 18)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    truth = tpch.q18_inner_truth(d)
    keys, sums = tpch.q18_groups_truth(d)
    truth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs = tpch.analyze_columns(None, ["l_orderkey"], dev,
                              chunks=tables["lineitem"])["l_orderkey"]
    analyze_s = time.perf_counter() - t0
    plan, _having = tpch.q18_inner_plan()
    algo = agg.agg_algorithm([cs], plan.aggs)
    if algo != "stream":
        raise AssertionError(f"q18: NDV {cs.hist.ndv} chose {algo}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with SyncFreeFirstDispatch(streamagg.SegmentAggKernel) as sync_check, \
            segsum_bench.record_calls() as rec:
        segsum.launches = 0
        res = agg.run_q18_inner(device=dev, tables=tables, group_stats=[cs])
        launches = segsum.launches
    recorded["q18"] = recorded_path("q18", rec, launches)
    st = res.stats
    got = np.array([r[0] for r in res.rows], dtype=np.int64)
    if not np.array_equal(got, truth):
        raise AssertionError(f"q18: {got.size} rows differ from the numpy "
                             f"truth's {truth.size}")
    if not (np.array_equal(res.groups[0], keys) and
            np.array_equal(res.groups[1], sums)):
        raise AssertionError(f"q18: the StreamAgg's {res.groups[0].size} "
                             f"groups differ from the numpy truth's "
                             f"{keys.size}")
    if st.agg_algorithm != "stream" or launches <= 0:
        raise AssertionError(f"q18: {st.agg_algorithm} agg, {launches} "
                             "segment-sum launches")
    if st.fallbacks:
        raise AssertionError(f"q18: fallbacks {st.fallback_reasons}")
    if "SegmentAggKernel" not in sync_check.checked:
        raise AssertionError(f"q18: sync-free dispatch checked only "
                             f"{sync_check.checked}")
    if st.sort_spilled_runs <= 0:
        raise AssertionError("q18: the sorter spilled no run")
    if st.mem_left != 0:
        raise AssertionError(f"q18: the ledger still holds {st.mem_left} "
                             "bytes")
    nrows = d.counts["lineitem"]
    return {"phase": "q18", "sf": sf, "seed": args.seed,
            "lineitem_rows": nrows, "generate_s": gen_s,
            "truth_s": truth_s, "analyze_s": analyze_s,
            "l_orderkey_ndv": cs.hist.ndv, "agg_algorithm": algo,
            "seconds": res.seconds, "rows_per_s": nrows / res.seconds,
            "groups": int(keys.size), "rows": int(got.size),
            "segsum_launches": launches,
            "sort_spilled_runs": st.sort_spilled_runs,
            "superchunks": st.superchunks,
            "device_batches": st.device_batches,
            "host_batches": st.host_batches, "fallbacks": st.fallbacks,
            "ledger_peak": st.mem_peak, "ledger_left": st.mem_left,
            "sync_free_dispatch": sync_check.checked,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "host_max_rss_kb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss}


class TimedPatches:
    """Times each delta patch: DeviceCache._patch_locked by the host
    clock (the position index, the dictionary extension, the launch of
    the device program), and its device program (device_cache.
    scatter_block, B11: the clones and index copies with their one
    pinned copy) by a CUDA event pair around it, read by `finish()`
    after the run, so the patch itself never waits for the card."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from tidb_tpu_torch.store import device_cache
        self.orig = orig = device_cache.DeviceCache._patch_locked
        self.orig_scatter = scatter = device_cache.scatter_block

        # _patch_locked runs under the cache's lock, so one patch (and
        # its scatter) runs at a time
        def timed_scatter(cols, *a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = scatter(cols, *a, **kw)
            ev[1].record()
            self.events = ev
            self.lane_bytes = sum(d.numel() * d.element_size() + v.numel()
                                  for d, v in cols)
            return out

        def timed(cache, *a, **kw):
            self.events = self.lane_bytes = None
            t0 = time.perf_counter()
            out = orig(cache, *a, **kw)
            self.calls.append({"host_ms": (time.perf_counter() - t0) * 1e3,
                               "events": self.events,
                               "lane_bytes": self.lane_bytes,
                               "patched": out is not None})
            return out
        device_cache.DeviceCache._patch_locked = timed
        device_cache.scatter_block = timed_scatter
        return self

    def __exit__(self, *exc):
        from tidb_tpu_torch.store import device_cache
        device_cache.DeviceCache._patch_locked = self.orig
        device_cache.scatter_block = self.orig_scatter
        return False

    def finish(self) -> list:
        """Each patch's device program time from its event pair, once
        the run has ended."""
        torch.cuda.synchronize()
        for c in self.calls:
            ev = c.pop("events")
            c["scatter_device_ms"] = ev[0].elapsed_time(ev[1]) if ev \
                else None
        return self.calls


def store_sync_checks(args, dev) -> dict:
    """The process's first fused dispatch and first delta patch under
    sync-debug "error", on a store of their own at min(--sf, CHECK_SF),
    fanned out on one thread: a cold run fills the chunk cache, a warm
    run fills the HBM blocks and dispatches fused over them, then a
    64-row batch in the last region and a run that patches its block.
    Each run's rows equal the numpy truth and its ledger ends at 0."""
    from tidb_tpu_torch import config
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.executor.agg import run_q1_store
    from tidb_tpu_torch.ops import hashagg
    from tidb_tpu_torch.store import device_cache
    from tidb_tpu_torch.store.storage import new_mock_storage
    sf = min(args.sf, CHECK_SF)
    d = tpch.ScaledTpch(sf, args.seed)
    storage = new_mock_storage(device=dev)
    storage.async_commit_secondaries = False
    tpch.load_store(storage, d)
    mirror = tpch.Q1Mirror(d)
    cache = storage.device_cache
    out = {"sf": sf}

    def run(name, check):
        with check as chk:
            res = run_q1_store(device=dev, storage=storage)
        if res.rows != mirror.truth() or res.stats.mem_left:
            raise AssertionError(f"store sync check {name}: rows differ "
                                 "from the truth or the ledger holds "
                                 f"{res.stats.mem_left} B")
        out[name] = chk.checked if chk is not None else None

    try:
        with config.session_overlay({"tidb_tpu_cop_concurrency": 1}):
            run("cold", contextlib.nullcontext())
            run("fill", SyncFreeFirstDispatch(hashagg.HashAggKernel))
            if len(cache) != 4 or out["fill"] != ["HashAggKernel"]:
                raise AssertionError(f"store sync check: the fused "
                                     f"dispatch went unchecked, {out}")
            n = d.counts["lineitem"]
            b0 = tpch.write_batch(d, np.arange(3 * (n // 4), n),
                                  args.seed + 3, 64)
            tpch.commit_batch(storage, b0)
            mirror.apply(b0)
            run("patch", SyncFreeFirstDispatch(device_cache.DeviceCache,
                                               method="_patch_locked"))
            if cache.patches != 1 or out["patch"] != ["DeviceCache"]:
                raise AssertionError(f"store sync check: the patch went "
                                     f"unchecked, {out}")
    finally:
        storage.close()
    return out


def store_phase(args, dev, recorded) -> dict:
    """TPC-H Q1 served from the mock TiKV store at min(--sf, STORE_SF):
    load, five run_q1_store runs at the default sysvars around two OLTP
    write batches, each held exactly against the numpy truth of the
    mutated arrays; the cold, first warm and patched runs' segment_sum
    calls go to recorded["store-*"]. The host-sync checks run first, on
    a store of their own (store_sync_checks)."""
    from tidb_tpu_torch import config, metrics
    from tidb_tpu_torch.benchmarks import segsum_bench, tpch
    from tidb_tpu_torch.executor.agg import run_q1_store
    from tidb_tpu_torch.ops import runtime, segsum
    from tidb_tpu_torch.store import delta, device_cache
    from tidb_tpu_torch.store.storage import new_mock_storage
    sf = min(args.sf, STORE_SF)
    t0 = time.perf_counter()
    d = tpch.ScaledTpch(sf, args.seed)
    gen_s = time.perf_counter() - t0
    storage = new_mock_storage(device=dev)
    # a batch's secondaries commit before commit() returns: the next run
    # reads the whole batch through the delta journal (under the default
    # asynchronous secondaries, a read straight after a commit meets
    # their locks and scans that region instead)
    storage.async_commit_secondaries = False
    t0 = time.perf_counter()
    loaded = tpch.load_store(storage, d)
    load_s = time.perf_counter() - t0
    mirror = tpch.Q1Mirror(d)
    cache = storage.device_cache
    node = device_cache.tracker()
    n = d.counts["lineitem"]
    regions = 4
    out = {"phase": "store", "sf": sf, "seed": args.seed,
           "lineitem_rows": n, "rows_loaded": loaded, "generate_s": gen_s,
           "load_s": load_s, "regions": regions,
           "sync_checks": store_sync_checks(args, dev), "runs": {}}

    def counter(name):
        """A counter's value summed over its label sets."""
        return sum(v for k, v in metrics.snapshot().items()
                   if k == name or k.startswith(name + "{"))

    def run(name, record=False, patch_timer=None):
        before = {k: counter(k) for k in (metrics.HBM_CACHE_HITS,
                                          metrics.HBM_CACHE_MISSES,
                                          metrics.CACHE_DELTA_SERVES)}
        put0, patches0 = runtime.put_bytes(), cache.patches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with (patch_timer or contextlib.nullcontext()), \
                (segsum_bench.record_calls() if record
                 else contextlib.nullcontext()) as rec:
            segsum.launches = 0
            res = run_q1_store(device=dev, storage=storage)
            launches = segsum.launches
        if rec is not None:
            recorded[f"store-{name}"] = recorded_path(f"store {name}", rec,
                                                      launches)
        truth = mirror.truth()
        st = res.stats
        if res.rows != truth:
            raise AssertionError(f"store {name}: rows differ from the numpy "
                                 f"truth:\n{res.rows}\n{truth}")
        if launches <= 0:
            raise AssertionError(f"store {name}: segment-sum kernel never "
                                 "launched")
        if st.fallbacks:
            raise AssertionError(f"store {name}: fallbacks "
                                 f"{st.fallback_reasons}")
        if st.mem_left:
            raise AssertionError(f"store {name}: the statement's ledger "
                                 f"still holds {st.mem_left} bytes")
        got = {"seconds": res.seconds, "rows_per_s": n / res.seconds,
               "hbm_hits": counter(metrics.HBM_CACHE_HITS) -
               before[metrics.HBM_CACHE_HITS],
               "hbm_misses": counter(metrics.HBM_CACHE_MISSES) -
               before[metrics.HBM_CACHE_MISSES],
               "hbm_patches": cache.patches - patches0,
               "delta_serves": counter(metrics.CACHE_DELTA_SERVES) -
               before[metrics.CACHE_DELTA_SERVES],
               "h2d_bytes": runtime.put_bytes() - put0,
               "segsum_launches": launches, "ledger_peak": st.mem_peak,
               "ledger_left": st.mem_left,
               "hbm_blocks": len(cache), "hbm_resident": node.device,
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
               "host_max_rss_kb": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss}
        out["runs"][name] = got
        return got

    cold = run("cold", record=True)
    if cold["hbm_hits"] or len(cache):
        raise AssertionError(f"store cold: HBM blocks at a cold run {cold}")
    warm = run("warm", record=True)
    if warm["hbm_misses"] != regions or len(cache) != regions or \
            warm["hbm_hits"]:
        raise AssertionError(f"store warm: expected {regions} fills, {warm}")
    hot = run("hot")
    if hot["hbm_hits"] != regions or hot["hbm_misses"] or \
            hot["h2d_bytes"]:
        raise AssertionError(f"store hot: expected {regions} hits and no "
                             f"host->device byte, {hot}")
    if node.device != cache.resident_bytes() or not node.device:
        raise AssertionError(f"store: hbm-cache node {node.device} B, "
                             f"cache {cache.resident_bytes()} B")
    # Q3 and Q5 on the loaded data, before the first batch changes it
    out["queries"] = store_query_runs(args, dev, storage, d, recorded)
    out["kernel_profile"] = kernel_profile()
    # the first batch: all in the last region (its handles run past n)
    lo = (regions - 1) * (n // regions)
    b1 = tpch.write_batch(d, np.arange(lo, n), args.seed + 1, 4000, 1000,
                          1000, next_handle=n, new_flag="X")
    t0 = time.perf_counter()
    tpch.commit_batch(storage, b1)
    out["batch1_s"] = time.perf_counter() - t0
    mirror.apply(b1)
    if storage.delta_store.rows_current() != 6000:
        raise AssertionError(f"store: {storage.delta_store.rows_current()} "
                             "journaled rows after the first batch")
    timer = TimedPatches()
    patched = run("patched", record=True, patch_timer=timer)
    out["patch"] = timer.finish()
    if patched["hbm_patches"] != 1 or patched["hbm_hits"] != regions or \
            patched["hbm_misses"] or not patched["delta_serves"]:
        raise AssertionError(f"store patched: expected one device patch "
                             f"and {regions} hits, {patched}")
    if len(timer.calls) != 1 or timer.calls[0]["scatter_device_ms"] is None:
        raise AssertionError(f"store patched: patch calls {timer.calls}")
    # the patch's device program clones every lane of the block and
    # writes the delta rows: bytes bound = each resident lane byte read
    # once and written once
    out["patch_bound_ms"] = 2 * timer.calls[0]["lane_bytes"] / \
        segsum_bench.H100_BYTES_PER_S * 1e3
    live = np.setdiff1d(np.arange(lo, n), b1.deletes)
    merged0 = counter(metrics.DELTA_MERGES)
    b2 = tpch.write_batch(d, live, args.seed + 2, 4000)
    t0 = time.perf_counter()
    tpch.commit_batch(storage, b2)
    storage.delta_store.join()
    out["batch2_s"] = time.perf_counter() - t0
    mirror.apply(b2)
    out["merges"] = counter(metrics.DELTA_MERGES) - merged0
    if out["merges"] != 1:
        raise AssertionError(f"store: {out['merges']} delta merges after "
                             "the second batch")
    out["journal_rows_after_merge"] = storage.delta_store.rows_current()
    merged = run("merged")
    # the merge re-stamped the three regions no write touched: every
    # region still hits the HBM cache (the written one through a patch)
    if merged["hbm_hits"] != regions or merged["hbm_misses"]:
        raise AssertionError(f"store merged: untouched regions went cold "
                             f"{merged}")
    out["rows"] = [[str(x) for x in r] for r in mirror.truth()]
    if args.profile:
        # one thread, so cProfile sees the regions' work; the regions the
        # merge re-colded fill their blocks first, so the profiled hot
        # run hits in every region; then a cold run from empty caches
        with config.session_overlay({"tidb_tpu_cop_concurrency": 1}):
            run_q1_store(device=dev, storage=storage)
            out["profile_hot"] = profile_run(
                lambda: run_q1_store(device=dev, storage=storage))
            storage.chunk_cache.clear()
            cache.shed()
            out["profile_cold"] = profile_run(
                lambda: run_q1_store(device=dev, storage=storage))
    out["hbm_resident_before_shed"] = node.device
    storage.close()
    out["hbm_resident_after_shed"] = node.device
    out["delta_staged_after_close"] = delta.tracker().host
    if node.device or delta.tracker().host:
        raise AssertionError(f"store: ledger nodes hold {node.device} B "
                             f"(hbm-cache), {delta.tracker().host} B "
                             "(delta-store) after shed")
    return out


def store_query_runs(args, dev, storage, d, recorded) -> dict:
    """run_q3_store and run_q5_store over the store phase's storage, each
    twice with the materialized coprocessor (tidb_tpu_copr_stream = 0):
    cold (every region scanned, decoded and put in the chunk cache;
    lineitem's regions may already be there from Q1, the same columns),
    then warm from the chunk cache. Streamed, a selection plan's region
    bigger than one frame (4 MiB) is re-scanned from the store on every
    run, as in the JAX package, so only the materialized path reads the
    chunk cache at SF 1. Each run equals the numpy truth (Q3 in every
    group before its TopN too), launched the segment-sum kernel and
    leaves the ledger at 0; the warm run misses the chunk cache nowhere.
    The cold runs' segment_sum calls go to recorded["store-q3" /
    "store-q5"]."""
    from tidb_tpu_torch import config
    from tidb_tpu_torch.benchmarks import segsum_bench, tpch
    from tidb_tpu_torch.executor.agg import run_q3_store, run_q5_store
    from tidb_tpu_torch.ops import runtime, segsum
    cc = storage.chunk_cache
    out = {}
    for name, run in (("q3", run_q3_store), ("q5", run_q5_store)):
        truth = {"q3": tpch.q3_truth, "q5": tpch.q5_truth}[name](d)
        groups = tpch.q3_groups_truth(d) if name == "q3" else None
        runs = {}
        for label in ("cold", "warm"):
            hits0, misses0, put0 = cc.hits, cc.misses, runtime.put_bytes()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            with (segsum_bench.record_calls() if label == "cold"
                  else contextlib.nullcontext()) as rec, \
                    config.session_overlay({"tidb_tpu_copr_stream": 0}):
                segsum.launches = 0
                res = run(device=dev, storage=storage)
                launches = segsum.launches
            if rec is not None:
                recorded[f"store-{name}"] = recorded_path(
                    f"store {name}", rec, launches)
            st = res.stats
            where = f"store {name} {label}"
            if res.rows != truth:
                raise AssertionError(f"{where}: rows differ from the numpy "
                                     f"truth:\n{res.rows}\n{truth}")
            if groups is not None and sorted(res.groups) != groups:
                raise AssertionError(
                    f"{where}: the HashAgg's {len(res.groups)} groups "
                    f"differ from the numpy truth's {len(groups)}")
            if launches <= 0:
                raise AssertionError(f"{where}: segment-sum kernel never "
                                     "launched")
            if st.fallbacks or st.mem_left:
                raise AssertionError(f"{where}: fallbacks "
                                     f"{st.fallback_reasons}, ledger left "
                                     f"{st.mem_left} B")
            if label == "warm" and (cc.misses != misses0 or
                                    cc.hits == hits0):
                raise AssertionError(f"{where}: {cc.misses - misses0} "
                                     "chunk-cache misses in the warm run")
            runs[label] = {
                "seconds": res.seconds, "join_paths": st.join_paths,
                "chunk_cache_hits": cc.hits - hits0,
                "chunk_cache_misses": cc.misses - misses0,
                "h2d_bytes": runtime.put_bytes() - put0,
                "segsum_launches": launches, "ledger_peak": st.mem_peak,
                "ledger_device_at_peak": st.mem_device_at_peak,
                "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                "groups": len(res.groups),
                "stats": {k: v for k, v in vars(st).items()}}
        out[name] = {"runs": runs,
                     "rows": [[str(x) for x in r] for r in truth]}
        if args.profile:
            with config.session_overlay({"tidb_tpu_copr_stream": 0}):
                out[name]["profile"] = profile_run(
                    lambda: run(device=dev, storage=storage))
    return out


def sql_phase(args, dev, recorded) -> tuple[dict, dict]:
    """TPC-H Q1, Q3 and Q5 as SQL text through the port's Session at
    min(--sf, STORE_SF): CREATE DATABASE, USE and tpch.load (the DDL
    through the DDL and meta layers, lineitem and orders in 4 regions),
    then Q1 cold, warm (HBM fill) and hot, and Q3 and Q5 cold and warm
    with the materialized coprocessor (SET @@tidb_tpu_copr_stream = 0,
    as store_query_runs). Every result equals the numpy truth formatted
    as the session formats it; every run launched the segment-sum kernel
    (the count set to 0 just before the statement and read just after),
    fell back nowhere (operators and coprocessor) and left its
    statement's ledger at 0; the hot Q1 read 4 HBM hits and no
    host->device byte; Q3's lineitem join took the hybrid path; Q5's
    fragment dispatched fused. The cold runs' and the warm Q1's
    segment_sum calls go to recorded["sql-*"]. -> (the phase's line, the
    session, storage, data and loaded rows, which the htap phase
    reuses)."""
    from tidb_tpu_torch import metrics
    from tidb_tpu_torch.benchmarks import segsum_bench, tpch
    from tidb_tpu_torch.ops import runtime, segsum
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    sf = min(args.sf, STORE_SF)
    d = tpch.ScaledTpch(sf, args.seed)
    storage = new_mock_storage(device=dev)
    sess = Session(storage)
    ledgers = {}

    def statement(sql):
        res = sess.execute(sql)
        ledgers[sql] = sess.last_mem_left
        if sess.last_mem_left:
            raise AssertionError(f"sql {sql!r}: the statement's ledger "
                                 f"still holds {sess.last_mem_left} B")
        return res

    statement("CREATE DATABASE tpch")
    statement("USE tpch")
    t0 = time.perf_counter()
    loaded = tpch.load(sess, storage, d)
    load_s = time.perf_counter() - t0
    if sess.last_mem_left:
        raise AssertionError("sql load: the last DDL statement's ledger "
                             f"holds {sess.last_mem_left} B")
    regions = 4
    out = {"phase": "sql", "sf": sf, "seed": args.seed,
           "rows_loaded": loaded, "load_s": load_s, "regions": regions,
           "runs": {}}

    def counter(name):
        return sum(v for k, v in metrics.snapshot().items()
                   if k == name or k.startswith(name + "{"))

    def run(name, label, record=False):
        where = f"sql {name} {label}"
        truth = tpch.as_session_rows(
            name, {"q1": tpch.q1_truth, "q3": tpch.q3_truth,
                   "q5": tpch.q5_truth}[name](d))
        hits0 = counter(metrics.HBM_CACHE_HITS)
        misses0 = counter(metrics.HBM_CACHE_MISSES)
        put0 = runtime.put_bytes()
        torch.cuda.synchronize()
        with (segsum_bench.record_calls() if record
              else contextlib.nullcontext()) as rec:
            segsum.launches = 0
            t0 = time.perf_counter()
            res = sess.query(getattr(tpch, name.upper()))
            seconds = time.perf_counter() - t0
            launches = segsum.launches
        if rec is not None:
            recorded[f"sql-{name}-{label}"] = recorded_path(where, rec,
                                                            launches)
        st, coll = sess.last_stats, sess.last_collector
        if coll is None:
            raise AssertionError(f"{where}: the session kept no "
                                 "runtime-stats collector")
        op_fallbacks = {op.name: op.fallback_reasons for op in coll.ops()
                        if op.fallbacks}
        if res.rows != truth:
            raise AssertionError(f"{where}: rows differ from the numpy "
                                 f"truth:\n{res.rows}\n{truth}")
        if launches <= 0:
            raise AssertionError(f"{where}: segment-sum kernel never "
                                 "launched")
        if st.fallbacks or op_fallbacks:
            raise AssertionError(f"{where}: fallbacks "
                                 f"{st.fallback_reasons} {op_fallbacks}")
        if sess.last_mem_left or st.mem_left:
            raise AssertionError(f"{where}: the statement's ledger still "
                                 f"holds {sess.last_mem_left} B")
        got = {"seconds": seconds,
               "phases_ms": {k: v / 1e6
                             for k, v in sess.last_phases.items()},
               "hbm_hits": counter(metrics.HBM_CACHE_HITS) - hits0,
               "hbm_misses": counter(metrics.HBM_CACHE_MISSES) - misses0,
               "h2d_bytes": runtime.put_bytes() - put0,
               "segsum_launches": launches, "join_paths": st.join_paths,
               "fused_dispatches": st.fused_dispatches,
               "hybrid_tasks": st.hybrid_tasks,
               "ledger_peak": st.mem_peak, "ledger_left": st.mem_left}
        out["runs"][f"{name}_{label}"] = got
        return got

    run("q1", "cold", record=True)
    warm = run("q1", "warm", record=True)
    if warm["hbm_misses"] != regions:
        raise AssertionError(f"sql q1 warm: expected {regions} HBM fills, "
                             f"{warm}")
    hot = run("q1", "hot")
    if hot["hbm_hits"] != regions or hot["hbm_misses"] or hot["h2d_bytes"]:
        raise AssertionError(f"sql q1 hot: expected {regions} HBM hits and "
                             f"no host->device byte, {hot}")
    out["q1_hot_against_store"] = hot_q1_against_store(
        sess, storage, d, regions, counter)
    statement("SET @@tidb_tpu_copr_stream = 0")
    for name in ("q3", "q5"):
        cold = run(name, "cold", record=True)
        run(name, "warm")
        if name == "q3" and cold["join_paths"].get("lineitem") != "hybrid":
            raise AssertionError(f"sql q3: the lineitem join took "
                                 f"{cold['join_paths']}, not the hybrid "
                                 "path")
        if name == "q5" and not cold["fused_dispatches"]:
            raise AssertionError(f"sql q5: no fused dispatch, {cold}")
    out["explain"] = {name: [r[0] for r in sess.query(
        "EXPLAIN " + getattr(tpch, name.upper())).rows]
        for name in ("q1", "q3", "q5")}
    statement("SET @@tidb_tpu_copr_stream = 1")
    return out, {"sess": sess, "storage": storage, "d": d,
                 "counter": counter}


def hot_q1_against_store(sess, storage, d, regions, counter) -> dict:
    """Hot Q1 as SQL against run_q1_store over the same storage and the
    same HBM blocks (run_q1_store reads the TableInfo that CREATE TABLE
    made), HOT_ROUNDS rounds in turn, each run held to the truth, 4 HBM
    hits and no host->device byte; then one more run of each under
    cProfile, whose port functions by their own time show where the SQL
    path's extra host time goes (on the profiling thread: the
    coprocessor's pool workers are not in it)."""
    import cProfile
    import pstats
    from tidb_tpu_torch import metrics
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.executor.agg import run_q1_store
    from tidb_tpu_torch.ops import runtime
    lineitem = sess.domain.info_schema().table("tpch", "lineitem")
    raw = tpch.q1_truth(d)
    truth = {"sql": tpch.as_session_rows("q1", raw), "store": raw}

    def sql():
        t0 = time.perf_counter()
        rows = sess.query(tpch.Q1).rows
        return rows, time.perf_counter() - t0

    def store():
        res = run_q1_store(storage=storage, lineitem=lineitem)
        return res.rows, res.seconds

    def once(side, fn):
        hits0 = counter(metrics.HBM_CACHE_HITS)
        put0 = runtime.put_bytes()
        torch.cuda.synchronize()
        rows, seconds = fn()
        hits = counter(metrics.HBM_CACHE_HITS) - hits0
        if rows != truth[side]:
            raise AssertionError(f"sql hot q1 ({side}): rows differ from "
                                 "the numpy truth")
        if hits != regions or runtime.put_bytes() != put0:
            raise AssertionError(f"sql hot q1 ({side}): {hits} HBM hits, "
                                 f"{runtime.put_bytes() - put0} H->D bytes")
        return seconds

    out = {"rounds": HOT_ROUNDS, "sql_s": [], "sql_execute_ms": [],
           "sql_front_end_ms": [], "store_s": []}
    for _ in range(HOT_ROUNDS):
        out["sql_s"].append(once("sql", sql))
        ph = sess.last_phases
        out["sql_execute_ms"].append(ph["execute"] / 1e6)
        out["sql_front_end_ms"].append(
            (ph["parse"] + ph["plan"] + ph["format"]) / 1e6)
        out["store_s"].append(once("store", store))
    for side, fn in (("sql", sql), ("store", store)):
        py = cProfile.Profile()
        py.enable()
        try:
            once(side, fn)
        finally:
            py.disable()
        top = sorted(((tt, n, f"{os.path.basename(f)}:{line}:{name}")
                      for (f, line, name), (_cc, n, tt, _ct, _c)
                      in pstats.Stats(py).stats.items()
                      if f"{os.sep}tidb_tpu_torch{os.sep}" in f),
                     reverse=True)
        out[f"{side}_profile_self_ms"] = [
            {"function": k[:80], "calls": n, "self_ms": tt * 1e3}
            for tt, n, k in top[:15]]
    return out


def htap_phase(args, dev, recorded, sess, storage, d, counter) -> dict:
    """Writes and transactions through SQL on the sql phase's session and
    store (no third TPC-H load), in an order where no DDL re-colds
    lineitem before its checks (a DDL or GC commit re-colds every cache).

    1. TPC-H writes as SQL (tpch.sql_batch, the store phase's batch
       sizes), with synchronous secondaries: the batch's first 500
       statements rolled back (hot Q1 equals the old truth: 4 hits, no
       patch, no host->device byte), a second session's BEGIN before the
       COMMIT of the whole batch (its Q1 afterwards equals the old
       truth), Q1 after the commit (equal to Q1Mirror's truth, blocks
       patched on the card, the kernel launched), 4,000 autocommit
       single-row UPDATEs past tidb_tpu_delta_merge_rows (Q1 merged
       equals its truth), and a SELECT ... FOR UPDATE whose COMMIT after
       a conflicting UPDATE raises the retryable conflict.
    2. The reference's HTAP mix (benchmarks/htap.py) at HTAP_ROWS stock
       rows with the reference's default asynchronous secondaries: warm
       twice, sweep rates 0, 20 and 100 writes/s in 5 s windows (the
       writer on a second session and thread); every analytic read's
       COUNT sums to the rows, the kernel launched in every window, no
       fallback, every ledger at 0; the final rows equal the numpy
       replay of the logged writes and the host path's. Then a
       transaction's three UPDATEs read back by the analytic statement
       through the union scan on the card, equal to the numpy truth,
       and rolled back.
    3. Indexes and online DDL: CREATE INDEX i_c_nation ON customer
       (c_nationkey) (backfill seconds and batches) and i_s_nation on
       supplier; a covering aggregate (IndexReader), a row fetch and an
       aggregate over IndexLookUp, and after ANALYZE a join on c_custkey
       (the planner's choice, named), each equal to a numpy truth; then
       DROP INDEX, TRUNCATE TABLE stock and one GC tick: the delete
       ranges drained, stock empty; what the tick re-colds is reported
       (the cache misses of an aggregate over customer warmed before
       it), not asserted.
    The segment_sum calls of the new shapes go to recorded["htap-*"]."""
    from decimal import Decimal

    from tidb_tpu_torch import kv, metrics
    from tidb_tpu_torch.benchmarks import htap, segsum_bench, tpch
    from tidb_tpu_torch.ddl import worker as ddl_worker
    from tidb_tpu_torch.ops import runtime, segsum
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store import device_cache
    from tidb_tpu_torch.store.gcworker import GCWorker
    cache = storage.device_cache
    node = device_cache.tracker()
    regions = 4
    n = d.counts["lineitem"]
    mirror = tpch.Q1Mirror(d)
    out = {"phase": "htap", "sf": min(args.sf, STORE_SF),
           "lineitem_rows": n, "steps": {}}

    def execute(s, sql):
        res = s.execute(sql)
        if s.last_mem_left:
            raise AssertionError(f"htap {sql[:60]!r}: the statement's "
                                 f"ledger holds {s.last_mem_left} B")
        return res

    def query(name, sql, truth, record=None, s=None, same=None,
              profile=False):
        """One statement held to `truth` (by `same`, else ==), with its
        seconds, HBM counters, patches, H->D bytes and launches; under
        cProfile with `profile` (the port's functions by own time)."""
        import cProfile
        import pstats
        s = s or sess
        py = cProfile.Profile() if profile else None
        hits0 = counter(metrics.HBM_CACHE_HITS)
        misses0 = counter(metrics.HBM_CACHE_MISSES)
        put0, patches0 = runtime.put_bytes(), cache.patches
        chunk0 = (storage.chunk_cache.hits, storage.chunk_cache.misses)
        torch.cuda.synchronize()
        with (segsum_bench.record_calls() if record
              else contextlib.nullcontext()) as rec:
            segsum.launches = 0
            if py is not None:
                py.enable()
            t0 = time.perf_counter()
            rows = s.query(sql).rows
            seconds = time.perf_counter() - t0
            if py is not None:
                py.disable()
            launches = segsum.launches
        if rec is not None:
            recorded[record] = recorded_path(record, rec, launches)
        st, coll = s.last_stats, s.last_collector
        op_fallbacks = {op.name: op.fallback_reasons for op in coll.ops()
                        if op.fallbacks}
        if not (same(rows, truth) if same else rows == truth):
            raise AssertionError(f"htap {name}: rows differ from the "
                                 f"truth:\n{rows}\n{truth}")
        if st.fallbacks or op_fallbacks:
            raise AssertionError(f"htap {name}: fallbacks "
                                 f"{st.fallback_reasons} {op_fallbacks}")
        if s.last_mem_left:
            raise AssertionError(f"htap {name}: the statement's ledger "
                                 f"holds {s.last_mem_left} B")
        got = {"seconds": seconds,
               "hbm_hits": counter(metrics.HBM_CACHE_HITS) - hits0,
               "hbm_misses": counter(metrics.HBM_CACHE_MISSES) - misses0,
               "hbm_patches": cache.patches - patches0,
               "chunk_cache_hits": storage.chunk_cache.hits - chunk0[0],
               "chunk_cache_misses": storage.chunk_cache.misses - chunk0[1],
               "h2d_bytes": runtime.put_bytes() - put0,
               "segsum_launches": launches,
               "join_paths": st.join_paths}
        if py is not None:
            top = sorted(((tt, c, f"{os.path.basename(f)}:{line}:{fn}")
                          for (f, line, fn), (_cc, c, tt, _ct, _c)
                          in pstats.Stats(py).stats.items()
                          if f"{os.sep}tidb_tpu_torch{os.sep}" in f),
                         reverse=True)
            got["profile_self_ms"] = [
                {"function": k[:80], "calls": c, "self_ms": tt * 1e3}
                for tt, c, k in top[:12]]
        out["steps"][name] = got
        return got

    def q1(name, record=None, s=None):
        return query(name, tpch.Q1, tpch.as_session_rows("q1",
                                                         mirror.truth()),
                     record=record, s=s)

    # -- 1. TPC-H writes through SQL, in transactions -----------------------
    storage.async_commit_secondaries = False
    hot = q1("q1_hot_before")
    if hot["hbm_hits"] != regions or hot["hbm_misses"]:
        raise AssertionError(f"htap: Q1 not hot before the writes {hot}")
    lo = (regions - 1) * (n // regions)
    b1 = tpch.write_batch(d, np.arange(lo, n), args.seed + 1, 4000, 1000,
                          1000, next_handle=n, new_flag="X")
    stmts = tpch.sql_batch(b1)
    journal0 = storage.delta_store.rows_current()
    execute(sess, "BEGIN")
    t0 = time.perf_counter()
    for sql in stmts[:500]:
        execute(sess, sql)
    rb_s = time.perf_counter() - t0
    execute(sess, "ROLLBACK")
    out["rollback"] = {"statements": 500, "seconds": rb_s,
                       "statements_per_s": 500 / rb_s,
                       "journal_rows": storage.delta_store.rows_current()}
    rolled = q1("q1_after_rollback")
    if rolled["hbm_hits"] != regions or rolled["hbm_patches"] or \
            rolled["h2d_bytes"] or rolled["hbm_misses"] or \
            storage.delta_store.rows_current() != journal0:
        raise AssertionError(f"htap: the rolled-back batch moved Q1 "
                             f"{rolled}")
    old_truth = tpch.as_session_rows("q1", mirror.truth())
    other = Session(storage, db="tpch")
    execute(other, "BEGIN")
    execute(sess, "BEGIN")
    t0 = time.perf_counter()
    for sql in stmts:
        execute(sess, sql)
    stmt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    execute(sess, "COMMIT")
    commit_s = time.perf_counter() - t0
    mirror.apply(b1)
    out["commit"] = {"statements": len(stmts), "seconds": stmt_s,
                     "statements_per_s": len(stmts) / stmt_s,
                     "commit_ms": commit_s * 1e3,
                     "journal_rows": storage.delta_store.rows_current() -
                     journal0}
    if out["commit"]["journal_rows"] != 6000:
        raise AssertionError(f"htap: {out['commit']} journaled rows after "
                             "the committed batch (6,000 expected)")
    query("q1_snapshot_before_commit", tpch.Q1, old_truth, s=other)
    execute(other, "COMMIT")
    timer = TimedPatches()
    with timer:
        patched = q1("q1_patched", record="htap-q1-patched")
    out["patch"] = timer.finish()
    if patched["hbm_patches"] < 1 or patched["hbm_misses"] or \
            patched["segsum_launches"] <= 0:
        raise AssertionError(f"htap: the committed batch was not patched "
                             f"on the card {patched}")
    live = np.setdiff1d(np.arange(lo, n), b1.deletes)
    b2 = tpch.write_batch(d, live, args.seed + 2, 4000)
    merges0 = counter(metrics.DELTA_MERGES)
    t0 = time.perf_counter()
    for sql in tpch.sql_batch(b2):
        execute(sess, sql)
    auto_s = time.perf_counter() - t0
    storage.delta_store.join()
    mirror.apply(b2)
    out["autocommit"] = {"statements": 4000, "seconds": auto_s,
                         "statements_per_s": 4000 / auto_s,
                         "merges": counter(metrics.DELTA_MERGES) - merges0}
    if not out["autocommit"]["merges"]:
        raise AssertionError(f"htap: no delta merge after 4,000 UPDATEs "
                             f"{out['autocommit']}")
    q1("q1_merged", record="htap-q1-merged")
    h = int(live[0])
    execute(sess, "BEGIN")
    sess.query(f"SELECT l_quantity FROM lineitem WHERE l_id = {h} "
               "FOR UPDATE")
    execute(other, f"UPDATE lineitem SET l_tax = l_tax WHERE l_id = {h}")
    try:
        sess.execute("COMMIT")
    except kv.RetryableError as e:
        out["for_update_conflict"] = type(e).__name__
    else:
        raise AssertionError("htap: a FOR UPDATE transaction committed "
                             "over a conflicting write")
    other.close()

    # -- 2. the reference's HTAP mix ----------------------------------------
    storage.async_commit_secondaries = True
    execute(sess, "CREATE DATABASE htap")
    execute(sess, "USE htap")
    t0 = time.perf_counter()
    stock = htap.setup(sess, storage, HTAP_ROWS)
    out["stock_load_s"] = time.perf_counter() - t0

    def same(rows, truth):
        return htap.same_rows(rows, truth)

    query("analytic_cold", htap.ANALYTIC, stock.truth(), same=same)
    query("analytic_warm", htap.ANALYTIC, stock.truth(), same=same)
    res = htap.sweep(sess, storage, HTAP_ROWS, (0, 20, 100), HTAP_WINDOW_S)
    for seq, i in res.pop("committed"):
        stock.apply(seq, i)
    for rate, r in res["rates"].items():
        if r["errors"] or r["segsum_launches"] <= 0 or r["fallbacks"] or \
                r["ledger_left_max"]:
            raise AssertionError(f"htap sweep at {rate}/s: {r}")
    out["sweep"] = res
    query("analytic_after_sweep", htap.ANALYTIC, stock.truth(),
          record="htap-analytic", same=same)
    # the sweep's writes after the last read: one read under cProfile
    # serves the stock block with them (where a read under writes goes)
    for i, sql in enumerate(htap.write_statements(10 ** 6, HTAP_ROWS)):
        execute(sess, sql)
        stock.apply(10 ** 6, i)
    query("analytic_profiled", htap.ANALYTIC, stock.truth(), same=same,
          profile=True)
    execute(sess, "SET @@tidb_tpu_device = 0")
    try:
        query("analytic_host", htap.ANALYTIC, stock.truth(), same=same)
    finally:
        execute(sess, "SET @@tidb_tpu_device = 1")
    execute(sess, "BEGIN")
    mine = htap.StockMirror(stock.cols)
    for k in (3, HTAP_ROWS // 2, HTAP_ROWS - 1):
        execute(sess, f"UPDATE stock SET s_qty = s_qty + 5, "
                      f"s_cnt = 999999 WHERE s_id = {k}")
        mine.cols["s_qty"][k] += 5
        mine.cols["s_cnt"][k] = 999999
    dirty = query("analytic_in_txn", htap.ANALYTIC, mine.truth(),
                  record="htap-union-scan", same=same)
    execute(sess, "ROLLBACK")
    if dirty["segsum_launches"] <= 0:
        raise AssertionError(f"htap: the union scan's aggregate did not "
                             f"launch the kernel {dirty}")

    # -- 3. secondary indexes and online DDL --------------------------------
    execute(sess, "USE tpch")
    batches = []
    real_init = ddl_worker.DDLWorker.__init__

    def counting_init(self, *a, **kw):
        real_init(self, *a, **kw)
        self.on_backfill_batch = lambda jb, cnt: batches.append(cnt)
    ddl_worker.DDLWorker.__init__ = counting_init
    try:
        t0 = time.perf_counter()
        execute(sess, "CREATE INDEX i_c_nation ON customer (c_nationkey)")
        out["backfill"] = {"seconds": time.perf_counter() - t0,
                           "batches": len(batches), "rows": sum(batches)}
        execute(sess, "CREATE INDEX i_s_nation ON supplier (s_nationkey)")
    finally:
        ddl_worker.DDLWorker.__init__ = real_init
    if out["backfill"]["rows"] != d.counts["customer"]:
        raise AssertionError(f"htap: the backfill wrote {out['backfill']}")
    c_nation = d.c_nationkey
    s_nation = d.s_nationkey
    cover = ("SELECT n, COUNT(*) FROM (SELECT s_nationkey AS n FROM "
             "supplier WHERE s_nationkey < 10) x GROUP BY n ORDER BY n")
    lookup = ("SELECT c_custkey, c_mktsegment FROM customer "
              "WHERE c_nationkey = 7 ORDER BY c_custkey")
    lookup_agg = ("SELECT m, COUNT(*) FROM (SELECT c_mktsegment AS m FROM "
                  "customer WHERE c_nationkey = 7) x GROUP BY m ORDER BY m")
    segs = np.array(tpch.SEGMENTS, dtype=object)[d.c_mktsegment]
    sel = np.flatnonzero(c_nation == 7)
    truths = {
        "index_reader": [(int(v), int((s_nation == v).sum()))
                         for v in np.unique(s_nation[s_nation < 10])],
        "index_lookup": [(int(i), str(segs[i])) for i in sel],
        "index_lookup_agg": [(str(m), int((segs[sel] == m).sum()))
                             for m in sorted(set(segs[sel]))]}
    plans = {}
    for name, sql, op, record in (
            ("index_reader", cover, "IndexReader", "htap-index-reader"),
            ("index_lookup", lookup, "IndexLookUp", None),
            ("index_lookup_agg", lookup_agg, "IndexLookUp",
             "htap-index-lookup")):
        plans[name] = [r[0] for r in sess.query("EXPLAIN " + sql).rows]
        if not any(op in line for line in plans[name]):
            raise AssertionError(f"htap {name}: no {op} in {plans[name]}")
        query(name, sql, truths[name], record=record)
    execute(sess, "ANALYZE TABLE customer, orders")
    # 1 % of the orders: a lookup per outer row costs less than the scan
    outer = d.counts["orders"] // 100
    join = ("SELECT c_mktsegment, COUNT(*) FROM orders, customer "
            f"WHERE o_custkey = c_custkey AND o_orderkey < {outer} "
            "GROUP BY c_mktsegment ORDER BY c_mktsegment")
    jsegs = segs[d.o_custkey[:outer]]
    plans["join"] = [r[0] for r in sess.query("EXPLAIN " + join).rows]
    picked = [op for op in ("IndexJoin", "MergeJoin")
              if any(op in line for line in plans["join"])]
    if not picked:
        raise AssertionError(f"htap join: neither IndexJoin nor MergeJoin "
                             f"{plans['join']}")
    out["join_algorithm"] = picked[0]
    query("index_join", join, [(str(m), int((jsegs == m).sum()))
                               for m in sorted(set(jsegs))],
          record="htap-index-join")
    out["plans"] = plans
    execute(sess, "DROP INDEX i_c_nation ON customer")
    execute(sess, "TRUNCATE TABLE htap.stock")
    # a small aggregate warmed after the DDL: what the GC tick re-colds
    scan = "SELECT COUNT(*), SUM(c_nationkey) FROM customer"
    scan_truth = [(d.counts["customer"], Decimal(int(c_nation.sum())))]
    query("customer_cold", scan, scan_truth)
    query("customer_warm", scan, scan_truth)
    time.sleep(0.05)     # the sealed ranges strictly below the safepoint
    t0 = time.perf_counter()
    gc = GCWorker(storage, gc_life_time_ms=0).run_once()
    out["gc"] = {**gc, "seconds": time.perf_counter() - t0}
    if not gc.get("advanced") or gc.get("delete_ranges", 0) < 2:
        raise AssertionError(f"htap gc: delete ranges not drained {gc}")
    query("stock_after_gc", "SELECT COUNT(*) FROM htap.stock", [(0,)])
    query("customer_after_gc", scan, scan_truth)
    sess.close()
    storage.close()
    out["hbm_resident_after_shed"] = node.device
    if node.device:
        raise AssertionError(f"htap: the hbm-cache node holds {node.device} "
                             "B after shed")
    return out


def kernel_profile() -> dict:
    """The kernel-profile registry (tidb_tpu_torch.profiler) as the
    process's runs left it: per kernel family and plan, dispatches, busy
    ms (dispatch enqueue plus the blocking readback, host clock), bytes
    and the roofline fraction against the card's datasheet peak."""
    from tidb_tpu_torch import profiler
    peak, src = profiler.platform_peak_gbps()
    rows = [{"family": r["family"], "fingerprint": r["fingerprint"],
             "dispatches": r["dispatches"], "busy_ms": r["busy_ns"] / 1e6,
             "bytes_in": r["bytes_in"], "achieved_gbps": r["achieved_gbps"],
             "roofline_fraction": r["roofline_fraction"],
             "escalations": r["escalations"],
             "fallbacks": r["fallback_reasons"]}
            for r in profiler.snapshot()]
    if not any(r["dispatches"] for r in rows):
        raise AssertionError(f"kernel profile: no dispatch recorded {rows}")
    return {"peak_gbps": peak, "peak_source": src, "rows": rows}


def faults_phase(args, dev) -> dict:
    """The device plane's fault handling on Q1 from a store of its own at
    min(--sf, CHECK_SF), fanned out on one thread so the fault order is
    the same in every run. After a cold and a warm run (4 HBM blocks):
    `device/dispatch` raising once (the retry serves it: equal rows, no
    fallback); raising in every dispatch for three statements (each
    degrades to the host path with `fault` fallbacks; the device is
    quarantined, every HBM block shed, the hbm-cache ledger at 0, later
    tasks fall back under `quarantine`); then, past the quarantine
    window, the probe readmits the device, that run refills the blocks
    and the next hits them. Last, tidb_tpu_dispatch_timeout_ms = 120
    against a 400 ms `device/finalize` delay: the watchdog raises the
    retryable DispatchTimeoutError, and the replay is clean. No failure
    is caught but that one expected error."""
    from tidb_tpu_torch import config, metrics, sched
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.executor.agg import run_q1_store
    from tidb_tpu_torch.store import device_cache
    from tidb_tpu_torch.store.storage import new_mock_storage
    from tidb_tpu_torch.util import failpoint
    sf = min(args.sf, CHECK_SF)
    d = tpch.ScaledTpch(sf, args.seed)
    truth = tpch.q1_truth(d)
    storage = new_mock_storage(device=dev)
    t0 = time.perf_counter()
    tpch.load_store(storage, d)
    out = {"phase": "faults", "sf": sf, "seed": args.seed,
           "load_s": time.perf_counter() - t0, "runs": {}}
    node = device_cache.tracker()
    health = sched.device_health()
    regions = 4

    def hbm_hits():
        return metrics.snapshot().get(metrics.HBM_CACHE_HITS, 0)

    def run(name):
        hits0 = hbm_hits()
        t0 = time.perf_counter()
        res = run_q1_store(device=dev, storage=storage)
        got = {"seconds": time.perf_counter() - t0,
               "fallbacks": dict(res.stats.fallback_reasons),
               "degraded": res.stats.fault_degraded,
               "hbm_hits": hbm_hits() - hits0,
               "hbm_blocks": len(storage.device_cache),
               "hbm_resident": node.device,
               "health": health.snapshot()}
        out["runs"][name] = got
        if res.rows != truth or res.stats.mem_left:
            raise AssertionError(f"faults {name}: rows differ from the "
                                 "truth or the ledger holds "
                                 f"{res.stats.mem_left} B: {got}")
        return got

    def expect(name, ok):
        if not ok:
            raise AssertionError(f"faults {name}: {out['runs'].get(name)}")

    window = sched._QUARANTINE_S
    # the probe window opens only where the phase rewinds it below: a
    # statement may outlast the 1 s window
    sched._QUARANTINE_S = 600.0
    try:
        with config.session_overlay({"tidb_tpu_cop_concurrency": 1}):
            run("cold")
            warm = run("warm")
            expect("warm", warm["hbm_blocks"] == regions)
            failpoint.enable("device/dispatch", "1*raise(DeviceFaultError)")
            once = run("dispatch once")
            failpoint.disable("device/dispatch")
            expect("dispatch once", not once["fallbacks"] and
                   not once["degraded"] and once["health"]["faults"] == 1
                   and once["hbm_hits"] >= regions)
            failpoint.enable("device/dispatch", "raise(DeviceFaultError)")
            try:
                names = [f"dispatch persistent {i}" for i in (1, 2, 3)]
                for name in names:
                    got = run(name)
                    expect(name, got["degraded"] or
                           got["fallbacks"].get("quarantine"))
            finally:
                failpoint.disable("device/dispatch")
            first, last = (out["runs"][n] for n in (names[0], names[-1]))
            expect(names[0], first["fallbacks"].get("fault", 0) > 0 and
                   first["degraded"])
            expect(names[-1], last["health"]["quarantined"] and
                   last["health"]["quarantines"] == 1 and
                   last["fallbacks"] == {"quarantine": regions} and
                   last["hbm_resident"] == 0 and last["hbm_blocks"] == 0)
            health._probe_at = time.monotonic() - 0.01
            probe = run("probe")
            expect("probe", not probe["health"]["quarantined"] and
                   not probe["fallbacks"] and
                   probe["hbm_blocks"] == regions)
            again = run("after readmit")
            expect("after readmit", again["hbm_hits"] == regions and
                   not again["fallbacks"])
            timeouts0 = metrics.snapshot().get(metrics.DISPATCH_TIMEOUTS, 0)
            config.set_var("tidb_tpu_dispatch_timeout_ms", 120)
            failpoint.enable("device/finalize", "delay(400)")
            try:
                run_q1_store(device=dev, storage=storage)
                raise AssertionError("faults watchdog: the 400 ms finalize "
                                     "ran past 120 ms unstopped")
            except failpoint.DispatchTimeoutError as e:
                out["watchdog"] = {"error": str(e), "retryable":
                                   isinstance(e, failpoint.DeviceFaultError)}
            finally:
                failpoint.disable("device/finalize")
                config.set_var("tidb_tpu_dispatch_timeout_ms", 0)
            out["watchdog"]["timeouts"] = metrics.snapshot().get(
                metrics.DISPATCH_TIMEOUTS, 0) - timeouts0
            expect("watchdog", out["watchdog"]["timeouts"] >= 1)
            replay = run("replay")
            expect("replay", not replay["fallbacks"])
            out["scheduler"] = sched.stats()
            if out["scheduler"]["scheduler"]["inflight"]:
                raise AssertionError(f"faults: slots left {out['scheduler']}")
    finally:
        sched._QUARANTINE_S = window
        failpoint.disable_all()
        storage.close()
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
    emit(analyze_phase(args, dev, tables))
    emit(q18_phase(args, dev, d, tables, recorded))
    del d, tables
    emit(store_phase(args, dev, recorded))
    out, kept = sql_phase(args, dev, recorded)
    emit(out)
    emit(htap_phase(args, dev, recorded, **kept))
    emit(faults_phase(args, dev))

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
