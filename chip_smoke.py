"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--sf 2] [--seed 42] [--profile]

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
          the same generated tables, once each (a second run, which held
          the same, was cut for time), held exactly against numpy truths
          (Q3 in every group before its TopN too); the phase
          asserts the segment-sum kernel launched, the lineitem join took
          the hybrid path, Q5's fused fragment dispatched, no fallback, no
          host sync inside the first JoinKernel / ProbeAggKernel /
          HashAggKernel dispatch of the run, and the statement's ledger
          back at 0 after it; Q3 then runs once more under
          tidb_tpu_mem_quota_query set from the first run's ledger peak,
          so the hybrid build's quota spill fires: the rows still equal
          the truth, partitions spilled, staged probe rows drained, and
          the ledger reads 0 afterwards
  analyze ANALYZE of six lineitem columns at --sf (12,002,430 rows each
          at SF 2): statistics.build_column_stats sorts each on the card
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
  sql     TPC-H Q1, Q3 and Q5 as SQL text through the port's Session
          (tidb_tpu_torch.session) at SF 0.5 (STORE_SF, or --sf where
          smaller): CREATE DATABASE tpch, USE tpch, tpch.load (the DDL
          through the DDL and meta layers, lineitem and orders in 4
          regions); Q1 cold, warm (HBM fill) and hot, then Q3 and Q5
          cold with the materialized coprocessor (their warm runs cut for
          time); each equal to
          its numpy truth as the session formats it, with the seconds of
          each run, its parse/plan/execute/format split and the load's
          seconds; the phase asserts the segment-sum kernel launched in
          every run, the hot Q1 read 4 HBM hits and no host->device
          byte, Q3's lineitem join took the hybrid path, Q5's fragment
          dispatched fused, no fallback, and every statement's ledger at
          0 after it; its session and store carry on into mesh, store
          and htap
  mesh    the device plane on the sql phase's store (mesh_phase):
          enable_mesh(4) puts a plane of 4 shards on the one card and,
          with tidb_tpu_stream_rows = 524,288, Q1, Q3 and Q5 run as
          SQL through the plane's operators (EXPLAIN: MeshAgg,
          MeshLookupAgg), a join whose build keys repeat through
          HashJoin and the plane's shuffle kernel, and on an SSB store of
          its own (benchmarks/ssb.setup at SF 0.5, 3,000,000 rows x 13
          BIGINT columns in 16 regions; BASELINE's SF 30 cut, the mock
          store holds every KV pair as a Python object) SSB Q1.1 (the
          coprocessor's fused path, as the reference routes a scalar
          aggregate) and its grouped query (MeshAgg); each equal to a
          numpy truth and to the rows of tidb_tpu_device = 0 with the
          plane off, the kernel launched (counted per statement), more
          than one batch with overlapped launches where it streams, no
          fallback, the ledger at 0 and the hbm-cache node equal to the
          caches' resident bytes; then disable_mesh() restores ndev = 1
          and Q1 is planned anew; with two or more cards Q1, Q3 and Q5
          run once more on a plane over them ("cross_card"), else the
          line says "not run: 1 card"
  bench   the port's bench entry (tidb_tpu_torch.bench.run) on the sql
          phase's store, Q3 and Q5 through the materialized coprocessor:
          Q1/Q3/Q5 with tidb_tpu_device = 1 and = 0, which must agree;
          its line (bench.py's keys, the north-star metric) is printed
          as it is
  store   the hand-built store plans on the sql phase's store (no load
          of their own; tpch.table_infos() where they equal the
          TableInfos CREATE TABLE made, else the store's): run_q1_store
          warm (its HBM blocks shed first: one fill per region) and hot
          (every region a hit, no host->device byte, the hbm-cache node
          equal to the cache's resident bytes), run_q3_store and
          run_q5_store warm and hot from the chunk cache (the hot run
          misses nowhere), each equal to its numpy truth (Q3 in every
          group before its TopN), with the kernel launched, no fallback
          and the ledger at 0; then the kernel-profile registry
          (profiler.snapshot). Before them, on a store of its own at
          SF 0.1 (CHECK_SF) fanned out on one thread, the process's first
          fused dispatch and first patch (of a 64-row batch) run under
          sync-debug "error". The write batches with Q1 patched and
          merged are the htap phase's
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
          the delete ranges. The patched Q1 reads 4 HBM hits and delta
          serves (its patch's device program timed against its bytes
          bound), the merged Q1 4 hits and no miss
  sqlrest the rest of the SQL stack on the htap phase's store
          (sqlrest_phase): TPC-H Q18 (an uncorrelated Apply), NOT IN, a
          correlated scalar subquery, UNION ALL and UNION, the cross
          join, Q3 and Q5 with per-chunk device aggregation, LOAD DATA
          through the native scanner (ScaledTpch lineitem at LOAD_SF),
          SPLIT TABLE and Q1 over the loaded table, ADMIN, EXPLAIN
          ANALYZE with the runtime-stats overhead on hot Q1, TRACE with
          the trace ring, /trace/<id>/chrome and the memtables, and the
          binlog of a 1,000-UPDATE transaction; each held against a
          numpy truth or the host path, with its ledger at 0
  server  the MySQL server on the htap phase's store (server_phase): the
          port's Server and StatusServer in-process, driven over TCP by a
          minimal client of its own (WireClient, over server/packet.py):
          accounts (CREATE USER, GRANT SELECT, 1142 for a denied UPDATE,
          1045 for a wrong password); Q1, Q3 and Q5 as text, cold after
          the bootstrap's re-cold and warm, equal to an in-process
          Session.query formatted as the server formats it and to the
          connection's rows under tidb_tpu_device = 0, the kernel
          launched in each; hot Q1 over the wire against in-process in
          turns; prepared Q1 and Q3 over the binary protocol, three
          parameter sets each, equal to the text protocol's literals;
          SERVER_CLIENTS connections for SERVER_WINDOW_S (a prepared Q1
          loop beside writers that update and read back c_acctbal);
          KILL QUERY of a running Q3 after /shed (1317, the connection
          still answers) and KILL CONNECTION; 4 Q3s under a server quota
          below Q3's digest peak (rows or the retryable 9008, never
          8175); /status, /metrics, /metrics/history, /shed (the next Q1
          misses and refills every block), the digest summary; then
          `python -m tidb_tpu_torch` as a child serving 65,536 rows and
          exiting 0 on SIGTERM
  fleet   the fleet on the card (fleet_phase): a store-plane process
          that loads a snapshot of an SF 0.05 store (FLEET_SF) and two
          SQL members, each a fresh interpreter with its own chunk and
          HBM caches, driven over the wire: cold and hot Q1 on each
          member (4 HBM hits, no host->device byte hot; the other
          member's counters unmoved), Q3 and Q5; a 64-row batch
          committed on one member patches the other's blocks from the
          journal window (window pulls and patched rows climb, no
          chunk-cache or HBM miss), equal to Q1Mirror's truth and to the
          host path; Q1 with tidb_tpu_fleet_local_cache = 0 runs on the
          store plane's device; cluster_members, a TRACE id above
          0xFFFFFF found as a store-plane record of
          cluster_statement_traces, /fleet/top; SIGKILL of member 0
          (the survivor serves, cluster_processlist returns partial rows
          with an "unreachable" warning), its restart and rejoin; each
          process's own /status shows the kernel launched in it, by
          shape; Fleet.stop() leaves no child
  legs    bench.py's other legs on the card (legs_phase), each as
          `python -m tidb_tpu_torch.bench LEG` runs it
          (tidb_tpu_torch.bench.run_leg) at the reference's defaults:
          encoded, trace, profile, lintcheck (the port's lint run clean as a
          child process, 22 rules, and warm Q1/Q3 constructing no kernel
          past the lint's static model), serve and chaos in process, each on
          a store of its own; the north-star line's skew_join block on a
          store of its own at SF 1's sizes (400,000 facts, 20,000 dimension
          rows), device against host; the kernel-only Q1
          micro at 2^20 rows, held against numpy; multichip over planes
          of 1, 2, 4 and 8 shards on the card; the fleet leg with four
          SQL members (each process's launches from its /status); `python
          -m tidb_tpu_torch.bench trace` once as a child (the CLI and its
          exit code); and check_htap's verdict on the htap phase's
          sweep. One line per leg: seconds, launches, headline numbers,
          the contract's (benchmarks/contracts.py) failed invariants and
          floors. An invariant fails the phase (a wrong result, a
          non-retryable error, a stuck statement, an OOM cancel, a
          ledger or slot left, an encoding or mesh fallback, an
          unbalanced trace tree, an empty kernel profile, a lint that
          is not clean or a kernel family constructing past its static
          model, attribution coverage outside [0.9, 1.1], a leg or a
          fleet member that never launched the segment-sum kernel); the
          performance floors (the fleet's 2.0x scaling, htap's 0.5
          vs_read_only, multichip's 0.75 ratio and serve_scales) print
          their verdicts only
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
          shape the cold Q1 run, the Q3 and Q5 runs, the Q18 run, the
          sql phase's cold and warm Q1 and cold Q3 and Q5, the mesh
          phase's statements (each shard's local call and the gathered
          re-reduce), the store's
          warm Q1, Q3 and Q5 runs, the htap phase's patched and merged
          Q1, analytic, union-scan, index-reader, index-lookup and
          index-join statements, the sqlrest phase's Q18, UNION ALL,
          cross join, per-chunk Q3 and Q5 and the loaded table's Q1, and
          the server phase's cold, warm and prepared Q1 and cold Q3 and
          Q5 over the wire, and the legs phase's in-process legs (path
          "legs": encoded, trace, profile, lintcheck, serve, chaos,
          skew_join, the kernel-only micro and multichip) gave it
          (their calls recorded by segsum_bench.record_calls), and the
          fleet's processes and the legs' fleet members reported (a shape no
          other path recorded is held and timed on seeded inputs of that
          shape), held again on those
          very inputs and timed: device time beside its host time per
          call, the plain version, one PyTorch library call and the bound
          (a shape that an earlier path already timed in the run carries
          that timing, `timed_on`); timed after the queries, since
          launches slow down in a process that torch.profiler has traced
  kernels one line listing every kernel at each of those shapes, with its
          launches there on its path (the legs' as "legs" and
          "legs-fleet-<member>"), its parity and its times
With --profile, each of q1, q3 and q5 adds torch.profiler tables of one
more run: device time by kernel, host time by op, device idle share; the
store phase adds one more hot run of its Q3 and Q5 and a hot and a
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


# The chunk-fed Q1, Q3, Q5 and ANALYZE's scale factor (--sf's default):
# cut from 10 to 2 when the mesh phase came, with LOAD_SF, HTAP_WINDOW_S
# and SERVER_WINDOW_S below, so that the whole smoke keeps a margin
# inside its time limit (at SF 5 it took 984-1,139 s of command); not to
# 1, where the Q3 quota run stages no probe row
DEFAULT_SF = 2.0

# Q18's inner block merges its ~1.5 M groups per scale factor one by one
# on the host (HashAggregator), as the JAX package does: the q18 phase
# runs at SF 1 (SF 1 took 47 s, ANALYZE included; PERF.md), cut from SF 2
# so that the whole smoke, its htap phase included, stays under 16
# minutes on the card
Q18_SF = 1.0

# The store phase loads TPC-H into the mock TiKV store (every KV pair a
# Python object) and decodes each lineitem row of the cold scan on the
# host, so it runs at SF 0.5 (STORE_SF, or --sf where smaller): cut from
# SF 1, the JAX package's own scale for this path, when the legs phase
# came (the sql, mesh, bench, store, htap, sqlrest and server phases
# run on this store, and at SF 1 the smoke projected to ~1,100 s of
# command); the four resident lineitem blocks fit the 2 GiB block cache
STORE_SF = 0.5
# The store phase's host-sync checks run first, on a store of their own
# at this scale factor (or --sf where smaller): sync-debug mode is
# process-wide, so they fan out on one thread, and one-time work they do
# (the host chunks' dictionary encodes, a block's first-patch position
# map) must not land ahead of the timed runs
CHECK_SF = 0.1
# The htap phase's stock table: the JAX package's bench.py htap loads
# 60,000 rows; raised so that the card holds a real block (2^20 rows,
# one region); the windows cut from the reference's 5 s to 3 s
HTAP_ROWS = 1 << 20
HTAP_WINDOW_S = 3.0
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
    """`name` (q3 or q5) once over the shared tables (its second run was
    cut for the time budget: it held what the first holds), held exactly
    against the numpy truth (Q3 also in every group before its TopN),
    with the phase's assertions; the run's segment_sum calls go to
    recorded[name] and its torch programs to the programs capture."""
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with SyncFreeFirstDispatch(join.JoinKernel, fragment.ProbeAggKernel,
                               hashagg.HashAggKernel) as sync_check, \
            programs, segsum_bench.record_calls() as rec:
        segsum.launches = 0
        res = run(device=dev, tables=qtables)
        launches = segsum.launches
    recorded[name] = recorded_path(name, rec, launches)
    st = res.stats
    if res.rows != truth:
        raise AssertionError(f"{name}: rows differ from the "
                             f"numpy truth:\n{res.rows}\n{truth}")
    if groups is not None and sorted(res.groups) != groups:
        raise AssertionError(
            f"{name}: the HashAgg's {len(res.groups)} groups "
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
        raise AssertionError(f"{name}: the statement's ledger "
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
    # the torch programs of the run, replayed at its shapes
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


def store_infos(sess) -> tuple[dict, bool]:
    """The TableInfos the hand-built store plans read on the sql phase's
    store: tpch.table_infos() (ids 3-13, the JAX DDL's) where they equal
    the ones CREATE TABLE made there, else the store's InfoSchema's.
    -> ({table: TableInfo}, whether the hand-built ones were equal)."""
    from tidb_tpu_torch.benchmarks import tpch
    ischema = sess.domain.info_schema()
    hand = tpch.table_infos()
    ddl = {name: ischema.table("tpch", name) for name in hand}
    same = all(hand[name] == ddl[name] for name in hand)
    return (hand if same else ddl), same


def store_phase(args, dev, recorded, sess, storage, d, counter) -> dict:
    """The hand-built store plans on the sql phase's store (no load of
    their own): run_q1_store warm (its HBM blocks shed first, so each
    region fills one) and hot (every region a hit, no host->device
    byte, the hbm-cache node equal to the cache's resident bytes), then
    run_q3_store and run_q5_store warm and hot from the chunk cache with
    the materialized coprocessor (store_query_runs). Every run equals the
    numpy truth, launched the segment-sum kernel, fell back nowhere and
    leaves its ledger at 0; the warm runs' segment_sum calls go to
    recorded["store-*"]. The host-sync checks run first, on a store of
    their own (store_sync_checks). The write batches with Q1 patched and
    merged are the htap phase's, which holds them."""
    from tidb_tpu_torch import config, metrics
    from tidb_tpu_torch.benchmarks import segsum_bench, tpch
    from tidb_tpu_torch.executor.agg import run_q1_store
    from tidb_tpu_torch.ops import runtime, segsum
    from tidb_tpu_torch.store import device_cache
    infos, same = store_infos(sess)
    truth = tpch.Q1Mirror(d).truth()
    cache = storage.device_cache
    node = device_cache.tracker()
    n = d.counts["lineitem"]
    regions = 4
    out = {"phase": "store", "sf": min(args.sf, STORE_SF),
           "seed": args.seed, "lineitem_rows": n, "regions": regions,
           "hand_built_infos_equal_ddl": same,
           "sync_checks": store_sync_checks(args, dev), "runs": {}}

    def run(name, record=False):
        before = {k: counter(k) for k in (metrics.HBM_CACHE_HITS,
                                          metrics.HBM_CACHE_MISSES)}
        put0 = runtime.put_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        with (segsum_bench.record_calls() if record
              else contextlib.nullcontext()) as rec:
            segsum.launches = 0
            res = run_q1_store(device=dev, storage=storage,
                               lineitem=infos["lineitem"])
            launches = segsum.launches
        if rec is not None:
            recorded[f"store-{name}"] = recorded_path(f"store {name}", rec,
                                                      launches)
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
               "h2d_bytes": runtime.put_bytes() - put0,
               "segsum_launches": launches, "ledger_peak": st.mem_peak,
               "ledger_left": st.mem_left,
               "hbm_blocks": len(cache), "hbm_resident": node.device,
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
               "host_max_rss_kb": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss}
        out["runs"][name] = got
        return got

    cache.shed()
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
    out["queries"] = store_query_runs(args, dev, storage, d, infos,
                                      recorded)
    out["kernel_profile"] = kernel_profile()
    out["rows"] = [[str(x) for x in r] for r in truth]
    if args.profile:
        # one thread, so cProfile sees the regions' work: a hot run, then
        # a cold one from empty caches, then a warm one that refills the
        # blocks, so the htap phase starts hot as without --profile
        with config.session_overlay({"tidb_tpu_cop_concurrency": 1}):
            out["profile_hot"] = profile_run(
                lambda: run_q1_store(device=dev, storage=storage,
                                     lineitem=infos["lineitem"]))
            storage.chunk_cache.clear()
            cache.shed()
            out["profile_cold"] = profile_run(
                lambda: run_q1_store(device=dev, storage=storage,
                                     lineitem=infos["lineitem"]))
            run_q1_store(device=dev, storage=storage,
                         lineitem=infos["lineitem"])
    return out


def store_query_runs(args, dev, storage, d, infos, recorded) -> dict:
    """run_q3_store and run_q5_store over the sql phase's storage, each
    twice with the materialized coprocessor (tidb_tpu_copr_stream = 0,
    as the sql phase ran its Q3 and Q5): warm (whatever of the regions
    the chunk cache lacks is scanned, decoded and put there) and hot
    (from the chunk cache: no miss). Each run equals the numpy truth (Q3
    in every group before its TopN too), launched the segment-sum kernel
    and leaves the ledger at 0. The warm runs' segment_sum calls go to
    recorded["store-q3" / "store-q5"]."""
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
        for label in ("warm", "hot"):
            hits0, misses0, put0 = cc.hits, cc.misses, runtime.put_bytes()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            with (segsum_bench.record_calls() if label == "warm"
                  else contextlib.nullcontext()) as rec, \
                    config.session_overlay({"tidb_tpu_copr_stream": 0}):
                segsum.launches = 0
                res = run(device=dev, storage=storage, infos=infos)
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
            if label == "hot" and (cc.misses != misses0 or
                                   cc.hits == hits0):
                raise AssertionError(f"{where}: {cc.misses - misses0} "
                                     "chunk-cache misses in the hot run")
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
                    lambda: run(device=dev, storage=storage, infos=infos))
    return out


def sql_phase(args, dev, recorded) -> tuple[dict, dict]:
    """TPC-H Q1, Q3 and Q5 as SQL text through the port's Session at
    min(--sf, STORE_SF): CREATE DATABASE, USE and tpch.load (the DDL
    through the DDL and meta layers, lineitem and orders in 4 regions),
    then Q1 cold, warm (HBM fill) and hot, and Q3 and Q5 cold with the
    materialized coprocessor (SET @@tidb_tpu_copr_stream = 0, as
    store_query_runs). Every result equals the numpy truth formatted
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
        # one run each (a warm one, which held the same, was cut for
        # time: the store phase runs Q3 and Q5 warm and hot)
        cold = run(name, "cold", record=True)
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


# The mesh phase: a plane of MESH_SHARDS shards on the one card (the
# port's counterpart of the reference's virtual multi-device mesh), the
# TPC-H statements and SSB streaming in batches of MESH_STREAM_ROWS rows.
# SSB runs at SF 0.5 (SSB_SF; BASELINE's SF 30 cut: the mock store holds
# every KV pair as a Python object; cut from SF 1, whose load took 64-84
# s, when the legs phase came) in SSB_REGIONS regions.
MESH_SHARDS = 4
# halved with STORE_SF (PR 13), so that orders (750,000 rows at SF 0.5)
# still streams in more than one batch
MESH_STREAM_ROWS = 1 << 19
SSB_SF = 0.5
SSB_REGIONS = 16
# a join whose build keys repeat on both sides, too few pairs to make
# the host's gather of the joined rows the phase's cost: the shuffle
SHUFFLE_JOIN = ("SELECT o_custkey, COUNT(*) FROM orders, lineitem "
                "WHERE o_custkey = l_suppkey AND l_quantity = 1 "
                "AND l_discount = 0.05 GROUP BY o_custkey "
                "ORDER BY o_custkey")


def shuffle_join_truth(d) -> list[tuple]:
    """SHUFFLE_JOIN's rows from the generated columns (numpy): per
    customer key c, (orders of c) x (filtered lineitems of supplier c)."""
    m = (d.l_quantity == 1) & (d.l_discount == 5)
    n = max(d.counts["customer"], d.counts["supplier"])
    cnt = np.bincount(d.o_custkey, minlength=n) * \
        np.bincount(d.l_suppkey[m], minlength=n)
    return [(int(c), int(cnt[c])) for c in np.flatnonzero(cnt)]


def mesh_phase(args, dev, recorded, sess, storage, d, counter) -> dict:
    """The device plane on the sql phase's store: enable_mesh(MESH_SHARDS)
    puts a plane of 4 shards on the one card, and with
    tidb_tpu_stream_rows = MESH_STREAM_ROWS (and the materialized
    coprocessor) Q1, Q3 and Q5 run as SQL (EXPLAIN: MeshAgg for Q1,
    MeshLookupAgg over dims [orders,customer] for Q3 and a lookup chain
    for Q5, as the reference's route_mesh gives), SHUFFLE_JOIN through
    HashJoin and the plane's shuffle kernel, then on an SSB store of its
    own (benchmarks/ssb.setup at SSB_SF, SSB_REGIONS regions) Q1.1 (a
    scalar aggregate, which route_mesh leaves on the coprocessor's fused
    path, as the reference does) and the grouped query (MeshAgg). Every
    statement equals its numpy truth and the rows of tidb_tpu_device = 0
    with the plane off; launched the segment-sum kernel (the count set
    to 0 just before it, read just after; its calls go to
    recorded["mesh-*"]); fell back nowhere (operators, coprocessor and
    the plane's per-batch fallback); left its ledger at 0; and the
    hbm-cache node equals the caches' resident bytes. The streamed
    statements ran more than one batch with overlapped launches; the
    shuffle kernel ran on more than one probe super-batch. After them,
    disable_mesh() restores ndev = 1 and the next Q1 is planned anew
    (a plan-cache miss) without a plane operator. With two or more
    cards, Q1, Q3 and Q5 run once more on a plane over the real cards;
    with one, the line says so."""
    from tidb_tpu_torch import devplane
    from tidb_tpu_torch.benchmarks import segsum_bench, ssb, tpch
    from tidb_tpu_torch.executor import mesh as mesh_exec
    from tidb_tpu_torch.ops import meshshuffle, segsum
    from tidb_tpu_torch.store import device_cache
    from tidb_tpu_torch.store.storage import new_mock_storage
    t_phase = time.perf_counter()
    out = {"phase": "mesh", "shards": MESH_SHARDS,
           "stream_rows": MESH_STREAM_ROWS, "runs": {}}
    n_ssb = int(6_000_000 * min(args.sf, SSB_SF))
    t0 = time.perf_counter()
    ssb_storage = new_mock_storage(device=dev)
    ssb_sess, cols, _load = ssb.setup(ssb_storage, n_ssb, SSB_REGIONS)
    out["ssb"] = {"sf": n_ssb / 6_000_000, "rows": n_ssb,
                  "regions": SSB_REGIONS,
                  "load_s": time.perf_counter() - t0}
    ssb_truth = ssb.truth(cols)
    del cols
    statements = {
        "q1": (sess, tpch.Q1, tpch.as_session_rows("q1", tpch.q1_truth(d)),
               "MeshAgg", True),
        "q3": (sess, tpch.Q3, tpch.as_session_rows("q3", tpch.q3_truth(d)),
               "MeshLookupAgg dims:[orders,customer]", True),
        "q5": (sess, tpch.Q5, tpch.as_session_rows("q5", tpch.q5_truth(d)),
               "MeshLookupAgg dims:[", True),
        "shuffle_join": (sess, SHUFFLE_JOIN, shuffle_join_truth(d),
                         "HashJoin", False),
        "ssb_q11": (ssb_sess, ssb.Q11, ssb_truth["q11"], None, False),
        "ssb_qgrp": (ssb_sess, ssb.QGRP + " ORDER BY lo_discount",
                     ssb_truth["qgrp"], "MeshAgg", True)}
    sessions = (sess, ssb_sess)
    caches = (storage.device_cache, ssb_storage.device_cache)
    node = device_cache.tracker()
    shuffle_calls = []
    real_call = meshshuffle.MeshShuffleJoinKernel.__call__

    def counting_call(self, *a, **kw):
        got = real_call(self, *a, **kw)
        shuffle_calls.append(len(a[0][0][0]))
        return got

    def plain(rows):
        """Session rows -> python ints where the value is integral (the
        SSB sums come back as DECIMAL)."""
        return [tuple(int(v) if not isinstance(v, (str, float)) and
                      v == int(v) else v for v in r) for r in rows]

    def run(name):
        s, sql, truth, op, streams = statements[name]
        where = f"mesh {name}"
        plan = "\n".join(r[0] for r in s.query("EXPLAIN " + sql).rows)
        if op is None:
            if "Mesh" in plan:
                raise AssertionError(f"{where}: routed onto the plane:\n"
                                     f"{plan}")
        elif op not in plan or (op == "HashJoin" and "Mesh" in plan):
            raise AssertionError(f"{where}: EXPLAIN lacks {op!r}:\n{plan}")
        mesh_exec.reset_stream_stats()
        shuffle_calls.clear()
        torch.cuda.synchronize()
        with segsum_bench.record_calls() as rec:
            segsum.launches = 0
            t0 = time.perf_counter()
            res = s.query(sql)
            seconds = time.perf_counter() - t0
            launches = segsum.launches
        recorded[f"mesh-{name}"] = recorded_path(where, rec, launches)
        st, coll = s.last_stats, s.last_collector
        op_fallbacks = {o.name: o.fallback_reasons for o in coll.ops()
                        if o.fallbacks} if coll is not None else {}
        stats = mesh_exec.stream_stats()
        rows = plain(res.rows) if name.startswith("ssb") else res.rows
        if rows != truth:
            raise AssertionError(f"{where}: rows differ from the numpy "
                                 f"truth:\n{rows[:10]}\n{truth[:10]}")
        if launches <= 0:
            raise AssertionError(f"{where}: segment-sum kernel never "
                                 "launched")
        if st.fallbacks or op_fallbacks or stats["host_batches"]:
            raise AssertionError(f"{where}: fallbacks {st.fallback_reasons}"
                                 f" {op_fallbacks} {stats}")
        if s.last_mem_left or st.mem_left:
            raise AssertionError(f"{where}: the statement's ledger still "
                                 f"holds {s.last_mem_left} B")
        if streams and (stats["batches"] < 2 or
                        stats["overlapped_launches"] < 1):
            raise AssertionError(f"{where}: did not stream with overlap: "
                                 f"{stats}")
        if name == "shuffle_join" and (len(shuffle_calls) < 2 or
                                       st.join_paths.get("orders") !=
                                       "shuffle" and
                                       st.join_paths.get("lineitem") !=
                                       "shuffle"):
            raise AssertionError(f"{where}: the shuffle kernel ran on "
                                 f"{shuffle_calls} probe batches, paths "
                                 f"{st.join_paths}")
        resident = sum(c.resident_bytes() for c in caches)
        if node.device != resident:
            raise AssertionError(f"{where}: hbm-cache node {node.device} B,"
                                 f" caches {resident} B")
        out["runs"][name] = {
            "seconds": seconds, "segsum_launches": launches,
            "stream": stats, "shuffle_batches": list(shuffle_calls),
            "join_paths": st.join_paths, "ledger_peak": st.mem_peak,
            "hbm_resident": resident, "explain": plan.split("\n")}
        return res.rows

    meshshuffle.MeshShuffleJoinKernel.__call__ = counting_call
    # the session-scope values this phase sets, put back as they were
    # after it (a session value left behind would shadow the registry
    # that later phases set: the bench step's tidb_tpu_device = 0)
    knobs = ("tidb_tpu_stream_rows", "tidb_tpu_copr_stream",
             "tidb_tpu_device")
    saved = [{k: s.sys_vars[k] for k in knobs if k in s.sys_vars}
             for s in sessions]
    for s in sessions:
        s.execute(f"SET @@tidb_tpu_stream_rows = {MESH_STREAM_ROWS}")
        s.execute("SET @@tidb_tpu_copr_stream = 0")
    devplane.enable_mesh(MESH_SHARDS, device=dev)
    try:
        if devplane.ndev() != MESH_SHARDS:
            raise AssertionError(f"mesh: ndev {devplane.ndev()}")
        device_rows = {name: run(name) for name in statements}
        out["cross_card"] = "not run: 1 card"
        if torch.cuda.device_count() >= 2:
            devplane.enable_mesh(None, device="cuda")
            out["cross_card"] = {"ndev": devplane.ndev()}
            for name in ("q1", "q3", "q5"):
                if statements[name][0].query(statements[name][1]).rows != \
                        device_rows[name]:
                    raise AssertionError(f"mesh {name}: rows differ on the "
                                         "plane over the real cards")
                out["cross_card"][name] = "equal"
    finally:
        meshshuffle.MeshShuffleJoinKernel.__call__ = real_call
        devplane.disable_mesh()
    # the plane is off: ndev 1, and Q1 is planned anew without it
    made = []
    planner = sess._plan

    def plan_spy(stmt):
        made.append(stmt)
        return planner(stmt)
    sess._plan = plan_spy
    try:
        q1_rows = sess.query(tpch.Q1).rows
    finally:
        del sess._plan
    plan = "\n".join(r[0] for r in sess.query("EXPLAIN " + tpch.Q1).rows)
    if devplane.ndev() != 1 or not made or "Mesh" in plan or \
            q1_rows != statements["q1"][2]:
        raise AssertionError(f"mesh: after disable_mesh ndev "
                             f"{devplane.ndev()}, {len(made)} plans made, "
                             f"plan:\n{plan}")
    out["after_disable"] = {"ndev": devplane.ndev(), "q1_replanned": True}
    # the host path, plane off: every statement's rows again
    t0 = time.perf_counter()
    for s in sessions:
        s.execute("SET @@tidb_tpu_device = 0")
    try:
        for name, (s, sql, _t, _op, _st) in statements.items():
            if s.query(sql).rows != device_rows[name]:
                raise AssertionError(f"mesh {name}: rows differ from "
                                     "tidb_tpu_device = 0")
    finally:
        for s, before in zip(sessions, saved):
            for k in knobs:
                s.sys_vars.pop(k, None)
            s.sys_vars.update(before)
    out["host_check_s"] = time.perf_counter() - t0
    ssb_sess.close()
    ssb_storage.close()
    out["seconds"] = time.perf_counter() - t_phase
    return out


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


def htap_phase(args, dev, recorded, sess, storage, d,
               counter) -> tuple[dict, dict]:
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
       twice, sweep rates 0, 20 and 100 writes/s in HTAP_WINDOW_S windows
       (the writer on a second session and thread); every analytic read's
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
    The segment_sum calls of the new shapes go to recorded["htap-*"].
    -> (the phase's line, the storage, data and counter, which the
    server phase reuses)."""
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
        serves0 = counter(metrics.CACHE_DELTA_SERVES)
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
               "delta_serves": counter(metrics.CACHE_DELTA_SERVES) -
               serves0,
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
            patched["segsum_launches"] <= 0 or \
            patched["hbm_hits"] != regions or not patched["delta_serves"]:
        raise AssertionError(f"htap: the committed batch was not patched "
                             f"on the card in {regions} hits {patched}")
    if not timer.calls or timer.calls[0]["scatter_device_ms"] is None:
        raise AssertionError(f"htap patched: patch calls {timer.calls}")
    # the patch's device program clones every lane of the block and
    # writes the delta rows: bytes bound = each resident lane byte read
    # once and written once
    out["patch_bound_ms"] = 2 * timer.calls[0]["lane_bytes"] / \
        segsum_bench.H100_BYTES_PER_S * 1e3
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
    merged = q1("q1_merged", record="htap-q1-merged")
    # the merge re-stamped the regions no write touched: every region
    # still hits the HBM cache (the written one through a patch)
    if merged["hbm_hits"] != regions or merged["hbm_misses"]:
        raise AssertionError(f"htap merged: untouched regions went cold "
                             f"{merged}")
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
    # the storage carries on into the sqlrest and server phases (the
    # server closes it and holds the hbm-cache node at 0 after that
    # close), with lineitem's written state: the Q1 mirror and the
    # l_orderkey of the rows the first batch inserted
    return out, {"storage": storage, "d": d, "counter": counter,
                 "mirror": mirror,
                 "inserted_orderkeys": b1.inserts["l_orderkey"]}


# The sqlrest phase's LOAD DATA input: ScaledTpch lineitem at this scale
# factor, written as tab-separated text. Cut from 0.1: at
# 0.1 the statement's one transaction passes kv.TXN_TOTAL_SIZE_LIMIT (100
# MiB, the reference's) and the step ran 61 s on the card before failing;
# cut again to 0.025 (150,030 rows) for the mesh phase's time
LOAD_SF = 0.025
# The sqlrest phase splits customer, the probe side of Q3 and Q5 and one
# region as loaded, at evenly spaced handles into this many regions
# before its per-chunk runs, so that each query's top join yields a
# chunk per region
PER_CHUNK_REGIONS = 8


def q18_truth(d, mirror, inserted_orderkeys) -> list[tuple]:
    """tpch.Q18's rows over lineitem as the htap phase left it (the Q1
    mirror's live rows and quantities, the inserted rows' orders), from
    the generator's customer and orders: the orders whose quantities sum
    past 300, with their customer and date, by date and key, 100 rows,
    as the session formats them."""
    from decimal import Decimal

    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.sqltypes import TypeCode, format_datetime
    ok = np.concatenate([d.l_orderkey,
                         np.asarray(inserted_orderkeys, dtype=np.int64)])
    alive = mirror.alive
    qty = mirror.cols["qty"]
    sums = np.bincount(ok[alive], weights=qty[alive],
                       minlength=d.counts["orders"]).astype(np.int64)
    keys = np.flatnonzero(sums > 300 * 100)
    order = np.lexsort((keys, d.o_orderdate[keys]))[:100]
    out = []
    days = tpch._days_us(d.o_orderdate)
    for o in keys[order]:
        out.append((int(d.o_custkey[o]), int(o),
                    format_datetime(int(days[o]), TypeCode.DATE),
                    Decimal(int(sums[o])).scaleb(-2)))
    return out


def sqlrest_phase(args, dev, recorded, storage, d, counter, mirror,
                  inserted_orderkeys) -> tuple[dict, dict]:
    """The rest of the SQL stack through the port's Session on the htap
    phase's store (no TPC-H load of its own; lineitem keeps its 4
    regions). Each statement is held against an exact numpy truth where
    the phase has the arrays of every table it reads (customer, orders,
    nation and region are checked unwritten first; lineitem's written
    state is the htap phase's Q1 mirror), else against the same
    statement under tidb_tpu_device = 0 or the default setting, and its
    ledger reads 0 after it. The analytic statements run on the
    materialized coprocessor (tidb_tpu_copr_stream = 0), as the sql
    phase's Q3 and Q5 do. In order:

    1. TPC-H Q18 (tpch.Q18): EXPLAIN shows `Apply in (uncorrelated)`;
       the kernel launched.
    2. NOT IN (tpch.NOT_IN) and 3. a correlated scalar subquery
       (tpch.SCALAR_SUBQUERY, 25 inner runs over customer) against
       np.isin and np.bincount.
    4. UNION ALL and UNION of a lineitem and an orders aggregate
       (tpch.UNION_ALL, tpch.UNION): the branches' partial aggregates
       launched the kernel.
    5. The cross join tpch.CROSS_JOIN (region x customer, 750,000 joined
       rows at SF 1): the kernel launched.
    6. Q3 and Q5 under tidb_tpu_superchunk_rows = 0 (per-chunk device
       aggregation), each against the default setting's run just before
       it, with more launches than that fused run (customer split into
       PER_CHUNK_REGIONS regions first, both runs at
       tidb_tpu_device_min_rows = 1).
    7. LOAD DATA of ScaledTpch(LOAD_SF) lineitem from a tab-separated
       file into lineitem_load (lineitem's DDL): rows/s, the native
       scanner served every chunk (no fallback); SPLIT TABLE ... REGIONS
       8 reports 7 splits; Q1 over it equals tpch.q1_truth with 8 cop
       tasks and the kernel launched.
    8. ADMIN CHECK TABLE customer, supplier (supplier holds the htap
       phase's index i_s_nation; its i_c_nation on customer was dropped)
       passes; ADMIN SHOW DDL JOBS lists the htap phase's index jobs.
    9. EXPLAIN ANALYZE of warm Q1 and Q3: the root's act_rows equals the
       rows returned, Q1's reader's kernel cell is filled, and
       device_time is filled under tidb_tpu_runtime_stats_device = 1;
       hot Q1's median of 5 runs with tidb_tpu_runtime_stats at 1 and
       at 0.
    10. TRACE FORMAT='json' of warm Q1: a balanced tree with admission,
       sched.slot, dispatch, finalize and a copr.task or copr.stream span
       on a pool thread; the status port's /trace/<id>/chrome serves it;
       the digest summary's last_trace_id points at it; the five
       observability memtables answer with rows; sched.shed_server(0)
       returns the trace ring's bytes to 0.
    11. The binlog: a MemoryPump on the storage, one transaction of 1,000
       UPDATEs of lineitem_load: one event, whose decoded row changes
       equal the updated rows; then lineitem_load is dropped.
    The Q18, UNION ALL, cross join, per-chunk Q3 and Q5 and LOAD DATA
    table's Q1 calls of segment_sum go to recorded["sqlrest-*"].
    -> (the phase's line, what the server phase takes)."""
    import statistics
    import tempfile
    from decimal import Decimal

    from tidb_tpu_torch import binlog, metrics, sched, trace
    from tidb_tpu_torch.benchmarks import segsum_bench, tpch
    from tidb_tpu_torch.executor import loaddata
    from tidb_tpu_torch.ops import segsum
    from tidb_tpu_torch.server.status import StatusServer
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.sqltypes import EvalType, format_datetime
    t_phase = time.perf_counter()
    sess = Session(storage, db="tpch")
    out = {"phase": "sqlrest", "sf": min(args.sf, STORE_SF),
           "load_sf": min(args.sf, LOAD_SF), "steps": {}}
    # the materialized coprocessor, as the sql phase runs Q3 and Q5: the
    # htap phase's DDL and GC re-colded every cache, and only this path
    # fills the chunk cache from a selection plan at SF 1, so the first
    # statement's scan of each table serves the later ones
    sess.execute("SET @@tidb_tpu_copr_stream = 0")

    def execute(sql):
        res = sess.execute(sql)
        if sess.last_mem_left:
            raise AssertionError(f"sqlrest {sql[:60]!r}: the statement's "
                                 f"ledger holds {sess.last_mem_left} B")
        return res

    def run(step, sql, truth=None, record=None, same=None):
        """One statement held to `truth` (by `same`, else ==) -> (rows,
        its line: seconds, launches, join paths, ledger)."""
        torch.cuda.synchronize()
        with (segsum_bench.record_calls() if record
              else contextlib.nullcontext()) as rec:
            segsum.launches = 0
            t0 = time.perf_counter()
            rows = sess.query(sql).rows
            seconds = time.perf_counter() - t0
            launches = segsum.launches
        if rec is not None:
            recorded[record] = recorded_path(record, rec, launches)
        st = sess.last_stats
        if truth is not None and \
                not (same(rows, truth) if same else rows == truth):
            raise AssertionError(f"sqlrest {step}: rows differ from the "
                                 f"truth:\n{rows[:20]}\n{truth[:20]}")
        if sess.last_mem_left:
            raise AssertionError(f"sqlrest {step}: the statement's ledger "
                                 f"holds {sess.last_mem_left} B")
        if st is not None and st.fallbacks:
            raise AssertionError(f"sqlrest {step}: fallbacks "
                                 f"{st.fallback_reasons}")
        got = {"seconds": seconds, "rows": len(rows),
               "segsum_launches": launches,
               "join_paths": dict(st.join_paths) if st is not None else {},
               "device_batches": st.device_batches if st is not None
               else 0, "ledger_left": sess.last_mem_left}
        out["steps"][step] = got
        return rows, got

    def launched(step, got):
        if got["segsum_launches"] <= 0:
            raise AssertionError(f"sqlrest {step}: segment-sum kernel "
                                 f"never launched {got}")

    def host_rows(sql):
        execute("SET @@tidb_tpu_device = 0")
        try:
            return sess.query(sql).rows
        finally:
            execute("SET @@tidb_tpu_device = 1")

    def multiset(rows, truth):
        return sorted(rows) == sorted(truth)

    # the tables the truths read beside lineitem: as generated
    unwritten = {
        "customer": ("SELECT COUNT(*), SUM(c_custkey), SUM(c_nationkey) "
                     "FROM customer",
                     [(d.counts["customer"], Decimal(int(d.c_custkey.sum())),
                       Decimal(int(d.c_nationkey.sum())))]),
        "orders": ("SELECT COUNT(*), SUM(o_orderkey), SUM(o_custkey) "
                   "FROM orders",
                   [(d.counts["orders"], Decimal(int(d.o_orderkey.sum())),
                     Decimal(int(d.o_custkey.sum())))]),
        "nation": ("SELECT COUNT(*), SUM(n_regionkey) FROM nation",
                   [(len(tpch.NATIONS),
                     Decimal(sum(r for _n, r in tpch.NATIONS)))]),
        "region": ("SELECT COUNT(*) FROM region",
                   [(len(tpch.REGIONS),)])}
    for name, (sql, truth) in unwritten.items():
        run(f"unwritten_{name}", sql, truth)

    # 1. Q18: the IN subquery with GROUP BY ... HAVING stays an Apply
    plan = [r[0] for r in sess.query("EXPLAIN " + tpch.Q18).rows]
    if not any("Apply in (uncorrelated)" in line for line in plan):
        raise AssertionError(f"sqlrest q18: no uncorrelated Apply {plan}")
    _rows, got = run("q18", tpch.Q18,
                     q18_truth(d, mirror, inserted_orderkeys),
                     record="sqlrest-q18")
    launched("q18", got)
    out["q18_plan"] = plan

    # 2. NOT IN and 3. the correlated scalar subquery
    no_orders = int((~np.isin(d.c_custkey, d.o_custkey)).sum())
    run("not_in", tpch.NOT_IN, [(no_orders,)])
    counts = np.bincount(d.c_nationkey, minlength=len(tpch.NATIONS))
    run("scalar_subquery", tpch.SCALAR_SUBQUERY,
        sorted((name, int(counts[k]))
               for k, (name, _r) in enumerate(tpch.NATIONS)))

    # 4. UNION ALL and UNION of two pushed partial aggregates
    live = mirror.alive
    flags = np.bincount(mirror.cols["flag"][live],
                        minlength=len(mirror.flag_names))
    prios = np.bincount(d.o_orderpriority, minlength=len(tpch.PRIORITIES))
    branch_rows = [(mirror.flag_names[i], int(c)) for i, c in
                   enumerate(flags) if c] + \
        [(p, int(prios[i])) for i, p in enumerate(tpch.PRIORITIES)
         if prios[i]]
    _rows, got = run("union_all", tpch.UNION_ALL, branch_rows,
                     record="sqlrest-union", same=multiset)
    launched("union_all", got)
    _rows, got = run("union", tpch.UNION, sorted(set(branch_rows)),
                     same=multiset)
    launched("union", got)

    # 5. the cross join
    cross = [(r, d.counts["customer"], Decimal(int(d.c_nationkey.sum())))
             for r in tpch.REGIONS]
    _rows, got = run("cross_join", tpch.CROSS_JOIN, cross,
                     record="sqlrest-cross", same=multiset)
    launched("cross_join", got)
    if got["join_paths"].get("customer") != "cross":
        raise AssertionError(f"sqlrest cross_join: {got['join_paths']}")

    # 6. per-chunk device aggregation: customer in PER_CHUNK_REGIONS
    # regions, one chunk each, and every chunk on the device (both runs
    # of each query at tidb_tpu_device_min_rows = 1: Q5's joined chunks
    # are a few hundred rows)
    span = d.counts["customer"] // PER_CHUNK_REGIONS
    split = sess.query("SPLIT TABLE customer AT " + ", ".join(
        f"({span * i})" for i in range(1, PER_CHUNK_REGIONS))).rows
    if split != [(PER_CHUNK_REGIONS - 1,)]:
        raise AssertionError(f"sqlrest split customer: {split}")
    (sc_rows, min_rows), = sess.query(
        "SELECT @@tidb_tpu_superchunk_rows, @@tidb_tpu_device_min_rows").rows
    execute("SET @@tidb_tpu_device_min_rows = 1")
    for name in ("q3", "q5"):
        sql = getattr(tpch, name.upper())
        fused_rows, fused = run(f"{name}_fused", sql)
        execute("SET @@tidb_tpu_superchunk_rows = 0")
        try:
            _rows, per = run(f"{name}_per_chunk", sql, fused_rows,
                             record=f"sqlrest-{name}-per-chunk")
        finally:
            execute(f"SET @@tidb_tpu_superchunk_rows = {sc_rows}")
        if per["segsum_launches"] <= fused["segsum_launches"] or \
                set(per["join_paths"].values()) != {"per-chunk"}:
            raise AssertionError(f"sqlrest {name} per chunk: {per} against "
                                 f"the fused run {fused}")
    execute(f"SET @@tidb_tpu_device_min_rows = {min_rows}")

    # 7. LOAD DATA with the native scanner, SPLIT TABLE, Q1 over it
    lsf = min(args.sf, LOAD_SF)
    dl = tpch.ScaledTpch(lsf, args.seed)
    ddl = [s for s in tpch.DDL.split(";") if "TABLE lineitem" in s][0]
    execute(ddl.replace("lineitem (", "lineitem_load ("))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lineitem.tsv")
        t0 = time.perf_counter()
        n_load = tpch.write_tsv(dl, "lineitem", path)
        write_s = time.perf_counter() - t0
        loaddata.reset_scan_stats()
        t0 = time.perf_counter()
        loaded = execute(f"LOAD DATA INFILE '{path}' INTO TABLE "
                         "lineitem_load")
        load_s = time.perf_counter() - t0
    scan = loaddata.scan_stats()
    out["steps"]["load_data"] = {
        "rows": n_load, "write_tsv_s": write_s, "seconds": load_s,
        "rows_per_s": n_load / load_s, "scan": scan}
    if loaded != [n_load] or scan["native_rows"] != n_load or \
            not scan["native_chunks"] or scan["fallbacks"]:
        raise AssertionError(f"sqlrest load_data: {loaded} of {n_load} "
                             f"rows, scanner {scan}")
    split = sess.query("SPLIT TABLE lineitem_load REGIONS 8").rows
    if split != [(7,)]:
        raise AssertionError(f"sqlrest split: {split}")
    q1_load = tpch.Q1.replace("FROM lineitem", "FROM lineitem_load")
    _rows, got = run("load_q1", q1_load,
                     tpch.as_session_rows("q1", tpch.q1_truth(dl)),
                     record="sqlrest-load-q1")
    launched("load_q1", got)
    tasks = sum(o.cop_tasks for o in sess.last_collector.ops()
                if o.name == "TableReader")
    got["cop_tasks"] = tasks
    if tasks != 8:
        raise AssertionError(f"sqlrest load_q1: {tasks} cop tasks")

    # 8. ADMIN
    checked = sess.query("ADMIN CHECK TABLE customer, supplier").rows
    jobs = sess.query("ADMIN SHOW DDL JOBS").rows
    kinds = sorted({r[1] for r in jobs})
    out["steps"]["admin"] = {"check": checked, "job_types": kinds}
    if checked != [("check passed",)] or "add index" not in kinds or \
            "drop index" not in kinds:
        raise AssertionError(f"sqlrest admin: {checked} {kinds}")

    # 9. EXPLAIN ANALYZE, device time, the instrumentation's overhead
    analyzed = {}
    returned = {"q1": len(mirror.truth()),
                "q3": out["steps"]["q3_fused"]["rows"]}
    for name in ("q1", "q3"):
        sql = getattr(tpch, name.upper())
        want = returned[name]
        execute("SET @@tidb_tpu_runtime_stats_device = 1")
        try:
            rows = sess.query("EXPLAIN ANALYZE " + sql).rows
        finally:
            execute("SET @@tidb_tpu_runtime_stats_device = 0")
        if sess.last_mem_left:
            raise AssertionError(f"sqlrest explain analyze {name}: ledger")
        timed = [r[5] for r in rows if r[5] not in ("-", "0ns")]
        readers = [r for r in rows if "TableReader" in r[0]]
        # Q1's reader pushes the aggregate: its kernel cell is filled
        if rows[0][2] != want or not timed or \
                (name == "q1" and readers[0][9] == "-"):
            raise AssertionError(f"sqlrest explain analyze {name}: {rows}")
        analyzed[name] = [list(r) for r in rows]
    out["explain_analyze"] = analyzed
    hot = {}
    for flag in (1, 0, 1, 0):
        execute(f"SET @@tidb_tpu_runtime_stats = {flag}")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.query(tpch.Q1)
            times.append(time.perf_counter() - t0)
        hot.setdefault(f"stats_{flag}_s", []).extend(times)
    execute("SET @@tidb_tpu_runtime_stats = 1")
    out["hot_q1_runtime_stats"] = {
        **hot, **{f"{k}_median": statistics.median(v)
                  for k, v in hot.items()}}

    # 10. TRACE, the ring, /trace/<id>/chrome, the digest, the memtables
    doc = json.loads(sess.query("TRACE FORMAT='json' " + tpch.Q1)
                     .rows[0][0])
    tid = doc["trace_id"]
    rec = trace.ring_get(tid)
    names, lanes = set(), set()

    def walk(s):
        names.add(s.name)
        if s.name.startswith("copr.") and s.tid != rec["root"].tid:
            lanes.add(s.tid)
        for c in s.children:
            walk(c)
    walk(rec["root"])
    need = {"admission", "sched.slot", "dispatch", "finalize"}
    problems = trace.validate(rec["root"])
    if not need <= names or not lanes or problems:
        raise AssertionError(f"sqlrest trace: spans {sorted(names)}, "
                             f"cop lanes {lanes}, {problems}")
    status = StatusServer(storage, None)
    status.start()
    try:
        chrome = http_get(status.port, f"/trace/{tid}/chrome")
    finally:
        status.close()
    if not [e for e in chrome["traceEvents"] if e["ph"] == "X"]:
        raise AssertionError("sqlrest trace: /trace/<id>/chrome is empty")
    digests = sess.query("SELECT last_trace_id FROM performance_schema."
                         "events_statements_summary_by_digest").rows
    if (tid,) not in digests:
        raise AssertionError(f"sqlrest trace: no digest points at {tid}")
    memtables = {}
    for name in ("memory_usage", "resource_usage", "statement_traces",
                 "kernel_profile", "statement_profile"):
        memtables[name] = len(sess.query(
            f"SELECT * FROM information_schema.{name}").rows)
    if not all(memtables.values()):
        raise AssertionError(f"sqlrest memtables: {memtables}")
    ring_before = trace.ring_stats()
    sched.shed_server(0)
    ring_after = trace.ring_stats()
    if ring_after["bytes"] or not ring_before["bytes"]:
        raise AssertionError(f"sqlrest trace ring: {ring_before} -> "
                             f"{ring_after} after the shed")
    out["trace"] = {"trace_id": tid, "spans": len(rec["root"].children),
                    "span_names": sorted(names), "cop_lanes": len(lanes),
                    "chrome_events": len(chrome["traceEvents"]),
                    "memtable_rows": memtables, "ring_before": ring_before,
                    "ring_after_shed": ring_after}

    # 11. the binlog
    pump = binlog.MemoryPump()
    storage.binlog_pump = pump
    ids = list(range(0, n_load, max(n_load // 1000, 1)))[:1000]
    try:
        t0 = time.perf_counter()
        execute("BEGIN")
        for h in ids:
            execute("UPDATE lineitem_load SET l_quantity = l_quantity + 1 "
                    f"WHERE l_id = {h}")
        execute("COMMIT")
        commit_s = time.perf_counter() - t0
    finally:
        storage.binlog_pump = None
    events = pump.events()
    info = sess.domain.info_schema().table("tpch", "lineitem_load")
    changes = binlog.decode_row_events(events[0]) if len(events) == 1 \
        else []

    def row_of(values):
        row = []
        for c in info.columns:
            v = values.get(c.id)
            if v is None:
                row.append(None)
            elif c.ft.eval_type == EvalType.DECIMAL:
                row.append(Decimal(int(v[1])).scaleb(-int(v[0])))
            elif c.ft.eval_type == EvalType.DATETIME:
                row.append(format_datetime(int(v), c.ft.tp))
            elif isinstance(v, bytes):      # string datums stay bytes
                row.append(v.decode())
            else:
                row.append(v)
        return tuple(row)

    got_rows = sorted(row_of(c.values) for c in changes
                      if c.table_id == info.id and c.op == "PUT")
    want_rows = sess.query("SELECT * FROM lineitem_load WHERE l_id IN (" +
                           ",".join(map(str, ids)) + ") ORDER BY l_id").rows
    out["steps"]["binlog"] = {"events": len(events),
                              "row_changes": len(changes),
                              "statements": len(ids), "seconds": commit_s}
    if len(events) != 1 or len(got_rows) != len(ids) or \
            got_rows != [tuple(r) for r in want_rows]:
        raise AssertionError(f"sqlrest binlog: {len(events)} events, "
                             f"{len(got_rows)} row changes for {len(ids)} "
                             "UPDATEs, or their rows differ")
    execute("DROP TABLE lineitem_load")
    execute("SET @@tidb_tpu_copr_stream = 1")
    sess.close()
    out["seconds"] = time.perf_counter() - t_phase
    out["metrics_traces"] = {k: v for k, v in metrics.snapshot().items()
                             if k.startswith(metrics.TRACES)}
    return out, {"storage": storage, "d": d, "counter": counter}


# The server phase's concurrency window (seconds) and connections: cut
# from 20 s so that the whole smoke stays under 16 minutes, and to 5 s
# for the mesh phase's time
SERVER_WINDOW_S = 5.0
SERVER_CLIENTS = 8
# extra arguments of the server phase's child process (a CPU dry run of
# the phase passes --device cpu)
SERVER_CHILD_ARGS: list = []


class WireError(Exception):
    def __init__(self, code: int, sqlstate: str, msg: str):
        super().__init__(f"({code}, {sqlstate}) {msg}")
        self.code, self.sqlstate = code, sqlstate


class WireClient:
    """A minimal MySQL client over the port's server/packet.py: the
    mysql_native_password handshake, COM_QUERY / INIT_DB with the text
    protocol, COM_STMT_PREPARE / EXECUTE / CLOSE with the binary one."""

    def __init__(self, port: int, user: str = "root", password: str = "",
                 db: str = ""):
        import hashlib
        import socket
        import struct
        from tidb_tpu_torch.server.packet import PacketIO
        self._struct = struct
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=600)
        self.pkt = PacketIO(self.sock)
        greeting = self.pkt.read_packet()
        off = greeting.index(b"\0", 1) + 1 + 4
        salt = greeting[off:off + 8]
        off += 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10
        salt += greeting[off:off + 12]
        auth = b""
        if password:
            h1 = hashlib.sha1(password.encode()).digest()
            mask = hashlib.sha1(salt + hashlib.sha1(h1).digest()).digest()
            auth = bytes(a ^ b for a, b in zip(h1, mask))
        caps = 0x200 | 0x8000 | 0x80000 | (8 if db else 0)
        resp = struct.pack("<II", caps, 1 << 24) + bytes([33]) + b"\0" * 23
        resp += user.encode() + b"\0" + bytes([len(auth)]) + auth
        if db:
            resp += db.encode() + b"\0"
        self.pkt.write_packet(resp + b"mysql_native_password\0")
        ok = self.pkt.read_packet()
        if ok[0] == 0xFF:
            self.sock.close()
            raise self._err(ok)

    def _err(self, pkt: bytes) -> WireError:
        return WireError(self._struct.unpack_from("<H", pkt, 1)[0],
                         pkt[4:9].decode(), pkt[9:].decode("utf8", "replace"))

    def _command(self, cmd: int, data: bytes) -> bytes:
        self.pkt.reset_seq()
        self.pkt.write_packet(bytes([cmd]) + data)
        first = self.pkt.read_packet()
        if first[0] == 0xFF:
            raise self._err(first)
        return first

    def _columns(self, first: bytes) -> list:
        from tidb_tpu_torch.server.packet import (read_lenenc_bytes,
                                                  read_lenenc_int)
        ncols, _ = read_lenenc_int(first, 0)
        cols = []
        for _ in range(ncols):
            pkt, off = self.pkt.read_packet(), 0
            for _ in range(4):
                _v, off = read_lenenc_bytes(pkt, off)
            name, off = read_lenenc_bytes(pkt, off)
            _org, off = read_lenenc_bytes(pkt, off)
            cols.append((name.decode(), pkt[off + 7]))
        if ncols:
            assert self.pkt.read_packet()[0] == 0xFE
        return cols

    def _rows(self, parse) -> list:
        rows = []
        while True:
            pkt = self.pkt.read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return rows
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            rows.append(parse(pkt))

    def query(self, sql: str):
        """-> ("ok", affected) or (columns, text rows)."""
        from tidb_tpu_torch.server.packet import (read_lenenc_bytes,
                                                  read_lenenc_int)
        first = self._command(0x03, sql.encode())
        if first[0] == 0x00:
            return ("ok", read_lenenc_int(first, 1)[0])
        cols = self._columns(first)

        def parse(pkt):
            out, off = [], 0
            for _ in cols:
                if pkt[off] == 0xFB:
                    out.append(None)
                    off += 1
                else:
                    v, off = read_lenenc_bytes(pkt, off)
                    out.append(v.decode())
            return tuple(out)
        return cols, self._rows(parse)

    def use(self, db: str) -> None:
        self._command(0x02, db.encode())

    def prepare(self, sql: str) -> tuple[int, int]:
        first = self._command(0x16, sql.encode())
        sid, ncols, nparams = self._struct.unpack_from("<IHH", first, 1)
        for _ in range(nparams + (1 if nparams else 0)):
            self.pkt.read_packet()
        for _ in range(ncols + (1 if ncols else 0)):
            self.pkt.read_packet()
        return sid, nparams

    def execute(self, sid: int, params=()):
        """-> (columns, rows as the text protocol would give them)."""
        from tidb_tpu_torch.server.packet import (read_lenenc_bytes,
                                                  read_lenenc_int)
        st = self._struct
        body = st.pack("<IBI", sid, 0, 1)
        if params:
            types, values = b"", b""
            for v in params:
                if isinstance(v, int):
                    types += bytes([8, 0])
                    values += st.pack("<q", v)
                else:
                    raw = str(v).encode()
                    types += bytes([15, 0])
                    values += bytes([len(raw)]) + raw
            body += bytes((len(params) + 7) // 8) + b"\x01" + types + values
        first = self._command(0x17, body)
        if first[0] == 0x00:
            return ("ok", read_lenenc_int(first, 1)[0])
        cols = self._columns(first)

        def parse(pkt):
            nb = (len(cols) + 9) // 8
            bitmap, off, out = pkt[1:1 + nb], 1 + nb, []
            for i, (_n, tp) in enumerate(cols):
                if bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                    out.append(None)
                elif tp == 8:
                    out.append(str(st.unpack_from("<q", pkt, off)[0]))
                    off += 8
                elif tp == 5:
                    out.append(repr(st.unpack_from("<d", pkt, off)[0]))
                    off += 8
                elif tp in (7, 10, 12):
                    n = pkt[off]
                    y, mo, d = st.unpack_from("<HBB", pkt, off + 1)
                    out.append(f"{y:04d}-{mo:02d}-{d:02d}" if n <= 4 else
                               "{:04d}-{:02d}-{:02d} {:02d}:{:02d}:{:02d}"
                               .format(y, mo, d,
                                       *st.unpack_from("<BBB", pkt,
                                                       off + 5)))
                    off += 1 + n
                else:
                    v, off = read_lenenc_bytes(pkt, off)
                    out.append(v.decode())
            return tuple(out)
        return cols, self._rows(parse)

    def close(self) -> None:
        try:
            self.pkt.reset_seq()
            self.pkt.write_packet(b"\x01")
        except OSError:
            pass
        self.sock.close()


def as_text(rows) -> list[tuple]:
    """In-process ResultSet rows as the server's text protocol sends them
    (server ClientConn._encode_row)."""
    from decimal import Decimal

    def one(v):
        if v is None:
            return None
        if isinstance(v, bytes):
            return v.decode()
        if isinstance(v, bool):
            return "1" if v else "0"
        if isinstance(v, float):
            return repr(v)
        if isinstance(v, Decimal):
            return str(v)
        return str(v)
    return [tuple(one(v) for v in r) for r in rows]


def http_get(port: int, path: str):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        body = r.read()
    return json.loads(body) if path != "/metrics" else body.decode()


def server_phase(args, dev, recorded, storage, d, counter) -> dict:
    """The MySQL server on the htap phase's store (no new load): the
    port's Server and StatusServer in-process, driven over TCP by
    WireClient. In order:

    1. root connects; ALTER TABLE customer ADD COLUMN c_acctbal (TPC-H's
       column, which the step-4 writers update; the bootstrap's DDL and
       this one re-cold every cache); CREATE USER 'tpch' and GRANT
       SELECT ON tpch.*; as tpch an UPDATE fails with 1142, and a wrong
       password fails the handshake with 1045.
    2. Q1, Q3, Q5 as text over COM_QUERY, cold then warm: rows equal an
       in-process Session.query on the same store formatted as the
       server formats them, and the connection's rows under SET
       @@tidb_tpu_device = 0; every run launched the segment-sum kernel.
       Then HOT_ROUNDS alternating rounds of hot Q1 over the wire and
       in-process (the wire's share of a statement); the repeated text
       hits the plan cache.
    3. Prepared Q1 (`?` for the interval) and Q3 (`?` for the segment
       and both dates), each executed 3 times with other parameters:
       binary rows equal the text protocol's run with literals. As in
       the reference, a prepared statement re-plans per execution (its
       markers fold into the plan as constants): the plan cache's hit
       count does not move across them.
    4. SERVER_CLIENTS connections for SERVER_WINDOW_S: one runs the
       prepared Q1 in a loop (each result equal to step 3's), the others
       each own a disjoint range of customer keys and alternate an
       autocommit UPDATE of c_acctbal with a point SELECT that reads it
       back. Statements/s, p50/p99 ms per kind, launches and the
       device's busy share (meter) over the window.
    5. GET /shed (the hbm-cache ledger at 0); a cold Q3 on one
       connection, seen in SHOW PROCESSLIST by another and stopped by
       KILL QUERY: 1317, then SELECT 1 answers; KILL CONNECTION closes
       its socket; every session ledger at 0.
    6. SET GLOBAL tidb_tpu_server_mem_quota below one Q3's recorded
       digest peak: 4 concurrent Q3s each complete with the right rows
       or get the retryable 9008, never 8175.
    7. /status, /metrics, /metrics/history answer; /shed empties the
       hbm-cache, and the next Q1 misses and refills every block; the
       digest summary lists Q1's digest with its count.
    8. `python -m tidb_tpu_torch --port 0 --status-port 0 --set
       tidb_tpu_device_min_rows=1` as a child: 65,536 rows inserted, a
       SUM/COUNT GROUP BY equal to numpy, dispatches in its /profile,
       exit 0 within 20 s of SIGTERM.
    The cold, warm and prepared Q1 runs' and the cold Q3 and Q5 runs'
    segment_sum calls go to recorded["server-*"]."""
    import gc
    import signal
    import threading
    from tidb_tpu_torch import errcode, memtrack, meter, metrics, perfschema
    from tidb_tpu_torch import sched
    from tidb_tpu_torch.benchmarks import segsum_bench, tpch
    from tidb_tpu_torch.ops import segsum
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.server.status import StatusServer
    from tidb_tpu_torch.session import Domain, Session
    from tidb_tpu_torch.store import device_cache
    regions = 4
    node = device_cache.tracker()
    # the htap phase's sessions are closed: the server opens a Domain of
    # its own over the store, as a server process started on it would
    gc.collect()
    pending = Domain.get(storage).stats_handle().pending_tables()
    if pending:
        raise AssertionError(f"server: the old domain's DML deltas survive "
                             f"{pending}")
    phase_t0 = t0 = time.perf_counter()
    server = Server(storage, port=0)
    server.start()
    status = StatusServer(storage, server)
    status.start()
    out = {"phase": "server", "nvidia_smi": nvidia_smi(),
           "start_s": time.perf_counter() - t0, "runs": {}}
    sess = Session(storage, db="tpch")
    root = WireClient(server.port, db="tpch")

    def expect_error(code, fn):
        try:
            fn()
        except WireError as e:
            if e.code != code:
                raise AssertionError(f"server: expected {code}, got {e}")
            return e.code
        raise AssertionError(f"server: expected error {code}, got none")

    # 1. handshake and accounts
    t0 = time.perf_counter()
    root.query("ALTER TABLE customer ADD COLUMN c_acctbal DECIMAL(15,2) "
               "DEFAULT 0")
    out["alter_s"] = time.perf_counter() - t0
    root.query("CREATE USER 'tpch'@'%' IDENTIFIED BY 'tpch-pw'")
    root.query("GRANT SELECT ON tpch.* TO 'tpch'@'%'")
    ro = WireClient(server.port, user="tpch", password="tpch-pw", db="tpch")
    out["accounts"] = {
        "select_as_tpch": ro.query("SELECT COUNT(*) FROM region")[1],
        "update_as_tpch": expect_error(1142, lambda: ro.query(
            "UPDATE customer SET c_acctbal = 1 WHERE c_custkey = 1")),
        "wrong_password": expect_error(1045, lambda: WireClient(
            server.port, user="tpch", password="nope"))}
    ro.close()

    # 2. Q1, Q3, Q5 over COM_QUERY, cold after the bootstrap, then warm
    texts = {name: getattr(tpch, name.upper()) for name in ("q1", "q3", "q5")}
    truth = {}

    def wire(conn, name, sql, label, record=None):
        hits0 = counter(metrics.HBM_CACHE_HITS)
        misses0 = counter(metrics.HBM_CACHE_MISSES)
        torch.cuda.synchronize()
        with (segsum_bench.record_calls() if record
              else contextlib.nullcontext()) as rec:
            segsum.launches = 0
            t0 = time.perf_counter()
            got = conn.query(sql) if not isinstance(sql, tuple) \
                else conn.execute(*sql)
            seconds = time.perf_counter() - t0
            launches = segsum.launches
        if rec is not None:
            recorded[record] = recorded_path(f"server {name} {label}", rec,
                                             launches)
        if launches <= 0:
            raise AssertionError(f"server {name} {label}: segment-sum "
                                 "kernel never launched on the wire path")
        out["runs"][f"{name}_{label}"] = {
            "seconds": seconds, "segsum_launches": launches,
            "hbm_hits": counter(metrics.HBM_CACHE_HITS) - hits0,
            "hbm_misses": counter(metrics.HBM_CACHE_MISSES) - misses0}
        return got[1]

    for name in ("q1", "q3", "q5"):
        if name == "q3":
            for c in (root, sess):
                (c.query if c is root else c.execute)(
                    "SET @@tidb_tpu_copr_stream = 0")
        rows = wire(root, name, texts[name], "cold",
                    record=f"server-{name}-cold")
        rows_warm = wire(root, name, texts[name], "warm",
                         record="server-q1-warm" if name == "q1" else None)
        truth[name] = as_text(sess.query(texts[name]).rows)
        if rows != truth[name] or rows_warm != truth[name]:
            raise AssertionError(f"server {name}: wire rows differ from "
                                 f"Session.query:\n{rows}\n{truth[name]}")
    root.query("SET @@tidb_tpu_device = 0")
    for name in ("q1", "q3", "q5"):
        t0 = time.perf_counter()
        if root.query(texts[name])[1] != truth[name]:
            raise AssertionError(f"server {name}: rows under "
                                 "tidb_tpu_device = 0 differ")
        out["runs"][f"{name}_host"] = {"seconds": time.perf_counter() - t0}
    root.query("SET @@tidb_tpu_device = 1")
    for c in (root, sess):
        (c.query if c is root else c.execute)(
            "SET @@tidb_tpu_copr_stream = 1")
    cache = sess.domain.plan_cache()
    hits0 = cache.hits
    hot = {"wire_s": [], "in_process_s": []}
    for _ in range(HOT_ROUNDS):
        for side in ("wire_s", "in_process_s"):
            h0 = counter(metrics.HBM_CACHE_HITS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = root.query(texts["q1"])[1] if side == "wire_s" else \
                as_text(sess.query(texts["q1"]).rows)
            hot[side].append(time.perf_counter() - t0)
            if rows != truth["q1"] or \
                    counter(metrics.HBM_CACHE_HITS) - h0 != regions:
                raise AssertionError(f"server hot q1 ({side}): rows or "
                                     "HBM hits differ")
    hot["wire_share_ms"] = [(w - i) * 1e3 for w, i in
                            zip(hot["wire_s"], hot["in_process_s"])]
    hot["plan_cache_hits"] = cache.hits - hits0
    if hot["plan_cache_hits"] < 2 * HOT_ROUNDS - 1:
        raise AssertionError(f"server: repeated Q1 text missed the plan "
                             f"cache {hot['plan_cache_hits']}")
    out["hot_q1"] = hot

    # 3. prepared statements over the binary protocol
    q1p = texts["q1"].replace("INTERVAL '90' DAY", "INTERVAL ? DAY")
    q3p = (texts["q3"].replace("c_mktsegment = 'BUILDING'", "c_mktsegment = ?")
           .replace("o_orderdate < DATE '1995-03-15'", "o_orderdate < ?")
           .replace("l_shipdate > DATE '1995-03-15'", "l_shipdate > ?"))
    prepared = {"q1": (q1p, [[90], [60], [120]]),
                "q3": (q3p, [["BUILDING", "1995-03-15", "1995-03-15"],
                             ["MACHINERY", "1995-03-10", "1995-03-10"],
                             ["AUTOMOBILE", "1995-03-20", "1995-03-20"]])}
    root.query("SET @@tidb_tpu_copr_stream = 0")
    prep_out, q1_90 = {}, None
    for name, (sql, runs) in prepared.items():
        sid, nparams = root.prepare(sql)
        got = []
        for i, params in enumerate(runs):
            h0 = cache.hits
            rows = wire(root, name, (sid, params), f"prepared_{i}",
                        record="server-q1-prepared" if (name, i) == ("q1", 0)
                        else None)
            if cache.hits != h0:
                raise AssertionError(f"server prepared {name}: a prepared "
                                     "execution hit the plan cache")
            literal = sql
            for v in params:
                literal = literal.replace(
                    "?", str(v) if isinstance(v, int) else f"'{v}'", 1)
            # the first Q3 set is step 2's statement: its text run (same
            # connection) is the one to equal, not a third 7 s Q3
            text = truth["q3"] if (name, i) == ("q3", 0) else \
                root.query(literal)[1]
            if rows != text or not rows:
                raise AssertionError(f"server prepared {name} {params}: "
                                     f"binary rows differ from the text "
                                     f"protocol's:\n{rows}\n{text}")
            if (name, i) == ("q1", 0):
                q1_90 = rows
                if rows != truth["q1"]:
                    raise AssertionError("server prepared q1: rows differ "
                                         "from step 2's truth")
            got.append({"params": params, "rows": len(rows)})
        prep_out[name] = got
    root.query("SET @@tidb_tpu_copr_stream = 1")
    out["prepared"] = prep_out

    # 4. concurrency: a dashboard's rollup beside an OLTP front end
    customers = d.counts["customer"]
    span = customers // (SERVER_CLIENTS - 1)
    lat = {"q1": [], "select": [], "update": []}
    errors, lat_mu = [], threading.Lock()
    start = threading.Barrier(SERVER_CLIENTS + 1)
    deadline = [0.0]

    def dashboard():
        c = WireClient(server.port, db="tpch")
        try:
            sid, _n = c.prepare(q1p)
            start.wait(timeout=60)
            while time.perf_counter() < deadline[0]:
                t0 = time.perf_counter()
                rows = c.execute(sid, [90])[1]
                dt = time.perf_counter() - t0
                if rows != q1_90:
                    raise AssertionError("server window: prepared Q1 rows "
                                         "differ from the truth")
                with lat_mu:
                    lat["q1"].append(dt)
        except Exception as e:  # noqa: BLE001 - raised after the window
            errors.append(repr(e))
        finally:
            c.close()

    def oltp(i):
        c = WireClient(server.port, db="tpch")
        lo = i * span
        try:
            start.wait(timeout=60)
            j = 0
            while time.perf_counter() < deadline[0]:
                key, val = lo + j % span, f"{(i * 1000 + j) % 99999 / 100:.2f}"
                t0 = time.perf_counter()
                c.query(f"UPDATE customer SET c_acctbal = {val} "
                        f"WHERE c_custkey = {key}")
                t1 = time.perf_counter()
                rows = c.query("SELECT c_acctbal FROM customer "
                               f"WHERE c_custkey = {key}")[1]
                t2 = time.perf_counter()
                if rows != [(val,)]:
                    raise AssertionError(f"server window: client {i} read "
                                         f"{rows} after writing {val}")
                with lat_mu:
                    lat["update"].append(t1 - t0)
                    lat["select"].append(t2 - t1)
                j += 1
        except Exception as e:  # noqa: BLE001 - raised after the window
            errors.append(repr(e))
        finally:
            c.close()

    threads = [threading.Thread(target=dashboard)] + \
        [threading.Thread(target=oltp, args=(i,))
         for i in range(SERVER_CLIENTS - 1)]
    for t in threads:
        t.start()
    dev0 = meter.server_snapshot()["device_ns"]
    segsum.launches = 0
    deadline[0] = time.perf_counter() + SERVER_WINDOW_S
    t0 = time.perf_counter()
    start.wait(timeout=60)
    for t in threads:
        t.join(timeout=SERVER_WINDOW_S + 300)
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"server window: {errors}")

    def pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))] * 1e3 if xs else None
    out["window"] = {
        "seconds": wall, "clients": SERVER_CLIENTS,
        "statements_per_s": sum(map(len, lat.values())) / wall,
        "per_kind": {k: {"statements": len(v), "per_s": len(v) / wall,
                         "p50_ms": pct(v, 0.5), "p99_ms": pct(v, 0.99)}
                     for k, v in lat.items()},
        "segsum_launches": segsum.launches,
        "device_busy_share":
            (meter.server_snapshot()["device_ns"] - dev0) / (wall * 1e9)}
    if not lat["q1"] or not lat["update"] or segsum.launches <= 0:
        raise AssertionError(f"server window: {out['window']}")

    # 5. KILL
    shed = http_get(status.port, "/shed")
    if node.device:
        raise AssertionError(f"server: /shed left {node.device} B in the "
                             "hbm-cache")
    victim = WireClient(server.port, db="tpch")
    killer = WireClient(server.port, db="tpch")
    victim.query("SET @@tidb_tpu_copr_stream = 0")
    vid = victim.query("SELECT CONNECTION_ID()")[1][0][0]
    res = {}

    def run_victim():
        t0 = time.perf_counter()
        try:
            victim.query(texts["q3"])
            res["outcome"] = "completed"
        except WireError as e:
            res["outcome"] = e.code
        res["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=run_victim)
    th.start()
    seen = None
    for _ in range(6000):
        seen = [r for r in killer.query("SHOW PROCESSLIST")[1]
                if r[0] == vid and r[4] == "Query"]
        if seen or not th.is_alive():
            break
        time.sleep(0.005)
    t_kill = time.perf_counter()
    killer.query(f"KILL QUERY {vid}")
    th.join(timeout=300)
    res["kill_to_error_s"] = time.perf_counter() - t_kill
    if not seen or res.get("outcome") != errcode.ER_QUERY_INTERRUPTED:
        raise AssertionError(f"server kill: {res} (processlist {seen})")
    res["select_1_after"] = victim.query("SELECT 1")[1]
    killer.query(f"KILL CONNECTION {vid}")
    try:
        victim.query("SELECT 1")
        raise AssertionError("server kill: the connection survived KILL "
                             "CONNECTION")
    except (ConnectionError, OSError):
        res["connection_closed"] = True
    killer.close()
    time.sleep(0.2)
    held = [t for t in memtrack.sessions_snapshot()
            if t["label"].startswith("session-") and t["host"] + t["device"]]
    if held:
        raise AssertionError(f"server kill: session ledgers held {held}")
    res["shed_freed_bytes"] = shed["freed_bytes"]
    out["kill"] = res

    # 6. admission under a pinched server quota
    peak = perfschema.digest_max_mem(texts["q3"])
    quota = max(peak // 2, 1)
    adm0 = dict(sched.stats()["admission"])
    root.query(f"SET GLOBAL tidb_tpu_server_mem_quota = {quota}")
    root.query("SET GLOBAL tidb_tpu_admission_timeout_ms = 500")
    outcomes = []
    gate = threading.Barrier(4)

    def contender():
        c = WireClient(server.port, db="tpch")
        try:
            c.query("SET @@tidb_tpu_copr_stream = 0")
            gate.wait(timeout=60)
            try:
                rows = c.query(texts["q3"])[1]
                outcomes.append("ok" if rows == truth["q3"] else "wrong")
            except WireError as e:
                outcomes.append(e.code)
        finally:
            c.close()

    ths = [threading.Thread(target=contender) for _ in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
    root.query("SET GLOBAL tidb_tpu_server_mem_quota = 0")
    root.query("SET GLOBAL tidb_tpu_admission_timeout_ms = 1000")
    adm1 = sched.stats()["admission"]
    out["admission"] = {
        "digest_peak_bytes": peak, "quota_bytes": quota,
        "outcomes": sorted(map(str, outcomes)),
        "counts": {k: adm1[k] - adm0.get(k, 0)
                   for k in ("admitted", "queued", "shed", "rejected")}}
    if len(outcomes) != 4 or "ok" not in outcomes or \
            set(outcomes) - {"ok", errcode.ER_SERVER_BUSY_ADMISSION} or \
            not errcode.is_retryable(errcode.ER_SERVER_BUSY_ADMISSION):
        raise AssertionError(f"server admission: {out['admission']}")

    # 7. the status port
    st = http_get(status.port, "/status")
    text = http_get(status.port, "/metrics")
    hist = http_get(status.port, "/metrics/history")
    for key in ("tidb_tpu_connections", "tidb_tpu_queries_total"):
        if key not in text:
            raise AssertionError(f"server /metrics lacks {key}")
    if "serving" not in st or not hist.get("series"):
        raise AssertionError("server /status or /metrics/history empty")
    http_get(status.port, "/shed")
    if node.device:
        raise AssertionError("server: /shed left the hbm-cache non-empty")
    rows = wire(root, "q1", texts["q1"], "after_shed")
    refill = out["runs"]["q1_after_shed"]
    if rows != truth["q1"] or refill["hbm_misses"] != regions or \
            len(storage.device_cache) != regions:
        raise AssertionError(f"server q1 after /shed: {refill}")
    digest = perfschema.sql_digest(texts["q1"])[0]
    count = root.query("SELECT exec_count FROM performance_schema."
                       "events_statements_summary_by_digest WHERE digest = "
                       f"'{digest}'")[1]
    if not count or int(count[0][0]) < 3 + 2 * HOT_ROUNDS:
        raise AssertionError(f"server digest summary: Q1 {count}")
    out["status"] = {"connections": st["connections"],
                     "history_series": len(hist["series"]),
                     "q1_digest": digest, "q1_exec_count": int(count[0][0])}
    root.close()
    sess.close()

    # 8. the server as a process
    import numpy as np
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch", "--port", "0",
         "--status-port", "0", "--set", "tidb_tpu_device_min_rows=1",
         *SERVER_CHILD_ARGS],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = sport = None
        for line in proc.stdout:
            if "MySQL protocol on" in line:
                port = int(line.rsplit(":", 1)[1])
            if "status API on" in line:
                sport = int(line.rsplit(":", 1)[1])
                break
        if not port or not sport:
            raise AssertionError("server process: no ports reported")
        ready_s = time.perf_counter() - t0
        threading.Thread(target=proc.stdout.read, daemon=True).start()
        c = WireClient(port)
        c.query("CREATE DATABASE p")
        c.use("p")
        c.query("CREATE TABLE t (id BIGINT PRIMARY KEY, g BIGINT, v BIGINT)")
        c.query("INSERT INTO t VALUES " + ",".join(
            f"({i}, {i % 7}, {i % 13})" for i in range(1024)))
        n = 1024
        while n < 65536:
            c.query(f"INSERT INTO t SELECT id + {n}, (id + {n}) % 7, "
                    f"(id + {n}) % 13 FROM t")
            n *= 2
        ids = np.arange(65536)
        want = [(str(g), str(int((ids[ids % 7 == g] % 13).sum())),
                 str(int((ids % 7 == g).sum()))) for g in range(7)]
        t1 = time.perf_counter()
        got = c.query("SELECT g, SUM(v), COUNT(*) FROM t GROUP BY g "
                      "ORDER BY g")[1]
        agg_s = time.perf_counter() - t1
        if got != want:
            raise AssertionError(f"server process: {got} != {want}")
        prof = http_get(sport, "/profile")
        dispatches = sum(r["dispatches"] for r in prof["kernel_profile"])
        if dispatches <= 0:
            raise AssertionError("server process: no dispatch on the card")
        c.close()
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=20)
        out["process"] = {"ready_s": ready_s, "agg_s": agg_s,
                          "dispatches": dispatches, "exit_code": rc,
                          "exit_s": time.perf_counter() - t1}
        if rc != 0:
            raise AssertionError(f"server process exited {rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    status.close()
    server.close()
    storage.close()
    out["hbm_resident_after_close"] = node.device
    out["seconds"] = time.perf_counter() - phase_t0
    if node.device:
        raise AssertionError(f"server: the hbm-cache node holds "
                             f"{node.device} B after close")
    if sched.stats()["scheduler"]["inflight"]:
        raise AssertionError(f"server: slots left {sched.stats()}")
    return out


# The fleet phase's store plane loads a snapshot of a TPC-H store at SF
# 0.05 (FLEET_SF, or --sf where smaller), cut from the sql phase's SF 1:
# each member's cold fill ships every KV pair through the Python wire
# codec (~10 s per member at SF 0.1 on the CPU test box), and the SF 1
# snapshot (~2 GB, ~70 s to write and as long to load) would take the
# whole of the phase's budget; cut from SF 0.1 when the legs phase came
FLEET_SF = 0.05
# each SQL member's HBM block-cache budget: the store plane and both
# members share one card, each with its own CUDA context
FLEET_CACHE_BYTES = 2 << 30


def bench_step(args, dev, recorded, sess, storage, d, counter) -> dict:
    """The port's bench entry (tidb_tpu_torch.bench.run) on the sql
    phase's store with the materialized coprocessor: Q1/Q3/Q5 with
    tidb_tpu_device = 1 (one cold and one timed run) and = 0 (one fill
    and one timed run), which must agree; its line must carry bench.py's
    keys and is printed as it is. Its segment_sum calls (the device
    mode's: the host mode makes none) go to recorded["bench"].
    -> the step's line."""
    from tidb_tpu_torch import bench
    from tidb_tpu_torch.benchmarks import segsum_bench
    from tidb_tpu_torch.ops import segsum
    # Q3 and Q5 read through the materialized coprocessor, as in the sql
    # phase: streamed, their selection regions re-scan the store on
    # every run (24-28 s each at SF 1 on the card) and the step would
    # pass its budget
    sess.execute("SET @@tidb_tpu_copr_stream = 0")
    t0 = time.perf_counter()
    try:
        with segsum_bench.record_calls() as rec:
            segsum.launches = 0
            line = bench.run(sess, storage, d, iters=1, host_iters=1)
            launched = segsum.launches
    finally:
        sess.execute("SET @@tidb_tpu_copr_stream = 1")
    seconds = time.perf_counter() - t0
    recorded["bench"] = recorded_path("bench", rec, launched)
    if tuple(line) != bench.KEYS or line["metric"] != bench.METRIC:
        raise AssertionError(f"bench: keys {tuple(line)}, not {bench.KEYS}")
    launches = {q: line["detail"][q]["segsum_launches"]
                for q in ("q1", "q3", "q5")}
    if not launches["q1"] or sum(launches.values()) != launched:
        raise AssertionError(f"bench: no kernel launch in Q1, or the "
                             f"line's {launches} are not the run's "
                             f"{launched} launches")
    if line["detail"]["copr_stream"] != 0:
        raise AssertionError("bench: the line does not record the "
                             "materialized coprocessor it ran on")
    print(json.dumps(line), flush=True)
    return {"phase": "bench", "seconds": seconds, "value": line["value"],
            "vs_baseline": line["vs_baseline"], "launches": launches}


def fleet_phase(args, dev) -> tuple[dict, dict]:
    """The fleet on one card (tidb_tpu_torch/fleet.py): one store-plane
    process and two SQL members, each a fresh interpreter on `dev`
    with its own chunk and HBM caches, all SQL over the wire
    (WireClient). In order:

    1. TPC-H at min(--sf, FLEET_SF) loaded in process and written with
       store/snapshot.save (timed); the store plane loads it
       (`storeserve --snapshot`, the Fleet's default --retain-ms 5000).
    2. Member 0: Q1 cold (a remote fill of its chunk and HBM caches: 4
       misses each), then hot: 4 HBM hits and no host->device byte on
       its /status; rows equal the numpy truth as text.
    3. Member 1: Q1 cold and hot: its own cache fills (4 HBM misses)
       while member 0's counters stay put; then Q3 and Q5, each equal to
       its truth.
    4. A 64-row OLTP batch committed as SQL on member 1; Q1 on member 0
       pulls the journal window (pulls{outcome="window"} and patched
       rows climb, chunk-cache and HBM misses flat), equal to
       Q1Mirror's truth; with tidb_tpu_device = 0 the same rows.
    5. Q1 on member 1 with tidb_tpu_fleet_local_cache = 0: the store
       plane runs the coprocessor on its own device (its segment-sum
       launches climb), rows equal the mirror.
    6. cluster_members from both members lists 2 SQL members and the
       store plane; TRACE FORMAT='json' on member 0 gives an id above
       0xFFFFFF, and from member 1 cluster_statement_traces finds a
       store-plane record whose origin_member is member 0; GET
       /fleet/top answers on each status port.
    7. SIGKILL member 0: member 1 still serves hot Q1; its
       cluster_processlist returns partial rows in under 10 s with an
       "unreachable" warning; member 0 restarts and rejoins
       cluster_members, and its first statement equals the in-process
       truth.
    8. Each member's own /status shows the segment-sum kernel launched
       in it (segsum_launches, by shape in segsum_shapes).
    Fleet.stop() leaves no child process, and no session ledger of this
    process holds a byte. -> (the phase's line, the kernel's launches by
    shape per process of the fleet)."""
    import gc
    import signal
    from tidb_tpu_torch import memtrack
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.fleet import Fleet
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store import snapshot
    from tidb_tpu_torch.store.storage import new_mock_storage
    phase_t0 = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sf = min(args.sf, FLEET_SF)
    d = tpch.ScaledTpch(sf, args.seed)
    storage = new_mock_storage(device=dev)
    sess = Session(storage)
    sess.execute("CREATE DATABASE tpch")
    sess.execute("USE tpch")
    t0 = time.perf_counter()
    loaded = tpch.load(sess, storage, d)
    load_s = time.perf_counter() - t0
    small = "SELECT COUNT(*), SUM(s_nationkey) FROM supplier"
    small_truth = as_text(sess.query(small).rows)
    if sess.last_mem_left:
        raise AssertionError(f"fleet load: the statement's ledger still "
                             f"holds {sess.last_mem_left} B")
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "tidb_tpu_torch", "_build", "fleet_store.snap")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    snapshot.save(path, storage.cluster, storage.engine)
    save_s = time.perf_counter() - t0
    out = {"phase": "fleet", "sf": sf, "rows_loaded": loaded,
           "load_s": load_s, "snapshot_save_s": save_s,
           "snapshot_bytes": os.path.getsize(path), "runs": {}}
    sess.close()
    storage.close()
    del sess, storage
    gc.collect()
    truth = {q: as_text(tpch.as_session_rows(q, f(d))) for q, f in
             (("q1", tpch.q1_truth), ("q3", tpch.q3_truth),
              ("q5", tpch.q5_truth))}
    regions = 4
    shapes = {}
    # the kernel launches on a card only (a CPU dry run has none)
    on_card = dev.type == "cuda"
    fleet = Fleet(n_sql=2, device=str(dev),
                  store_args=["--snapshot", path],
                  sql_args=["--set", "tidb_tpu_device_cache_bytes="
                            f"{FLEET_CACHE_BYTES}"])
    try:
        t0 = time.perf_counter()
        fleet.start()
        fleet.wait_healthy(timeout=120)
        out["start_s"] = time.perf_counter() - t0
        m0, m1 = fleet.members

        def status(port):
            return http_get(port, "/status")

        def count(doc, name, label=""):
            return sum(v for k, v in doc["metrics"].items()
                       if (k == name or k.startswith(name + "{")) and
                       label in k)

        def moved(before, after):
            return {"hbm_hits": count(after, "tidb_tpu_hbm_cache_hits_total")
                    - count(before, "tidb_tpu_hbm_cache_hits_total"),
                    "hbm_misses":
                        count(after, "tidb_tpu_hbm_cache_misses_total") -
                        count(before, "tidb_tpu_hbm_cache_misses_total"),
                    "chunk_misses": after["chunk_cache"]["misses"] -
                        before["chunk_cache"]["misses"],
                    "h2d_bytes": after["h2d_bytes"] - before["h2d_bytes"],
                    "launches": after["segsum_launches"] -
                        before["segsum_launches"]}

        def run(c, m, name, label, sql=None, want=None):
            where = f"fleet member {m.index} {name} {label}"
            s0 = status(m.status_port)
            t0 = time.perf_counter()
            cols_rows = c.query(sql or getattr(tpch, name.upper()))
            seconds = time.perf_counter() - t0
            s1 = status(m.status_port)
            rows = cols_rows[1]
            want = truth[name] if want is None else want
            if rows != want:
                raise AssertionError(f"{where}: rows differ from the "
                                     f"truth:\n{rows}\n{want}")
            got = {"seconds": seconds, **moved(s0, s1)}
            out["runs"][f"m{m.index}_{name}_{label}"] = got
            return got, s1

        c0 = WireClient(m0.port, db="tpch")
        c1 = WireClient(m1.port, db="tpch")
        # 2. member 0 fills its own caches over the wire
        cold, _ = run(c0, m0, "q1", "cold")
        hot, m0_doc = run(c0, m0, "q1", "hot")
        if cold["hbm_misses"] != regions or cold["chunk_misses"] != regions:
            raise AssertionError(f"fleet m0 cold: {regions} chunk and HBM "
                                 f"fills expected, {cold}")
        if hot["hbm_hits"] != regions or hot["hbm_misses"] or \
                hot["h2d_bytes"] or (on_card and hot["launches"] <= 0):
            raise AssertionError(f"fleet m0 hot: {regions} HBM hits, no "
                                 f"host->device byte and a launch "
                                 f"expected, {hot}")
        # 3. member 1's own caches; member 0's stay put
        cold1, _ = run(c1, m1, "q1", "cold")
        hot1, _ = run(c1, m1, "q1", "hot")
        if cold1["hbm_misses"] != regions or hot1["hbm_hits"] != regions \
                or hot1["h2d_bytes"]:
            raise AssertionError(f"fleet m1: its own cache did not fill "
                                 f"{cold1} {hot1}")
        still = moved(m0_doc, status(m0.status_port))
        if any(still.values()):
            raise AssertionError(f"fleet: member 0's counters moved under "
                                 f"member 1's runs {still}")
        run(c1, m1, "q3", "cold")
        run(c1, m1, "q5", "cold")
        # 4. coherence: a batch committed on member 1, read on member 0
        mirror = tpch.Q1Mirror(d)
        n = d.counts["lineitem"]
        b = tpch.write_batch(d, np.arange(3 * (n // 4), n), args.seed + 5,
                             64)
        c1.query("BEGIN")
        for sql in tpch.sql_batch(b):
            c1.query(sql)
        c1.query("COMMIT")
        mirror.apply(b)
        time.sleep(1.0)     # the commit's secondaries resolve async
        mtruth = as_text(tpch.as_session_rows("q1", mirror.truth()))
        pulls = "tidb_tpu_fleet_journal_pulls_total"
        patched = "tidb_tpu_fleet_journal_patched_rows_total"
        s0 = status(m0.status_port)
        coh, s1 = run(c0, m0, "q1", "patched", want=mtruth)
        coh["window_pulls"] = count(s1, pulls, 'outcome="window"') - \
            count(s0, pulls, 'outcome="window"')
        coh["patched_rows"] = count(s1, patched) - count(s0, patched)
        if coh["window_pulls"] <= 0 or coh["patched_rows"] <= 0 or \
                coh["chunk_misses"] or coh["hbm_misses"]:
            raise AssertionError(f"fleet coherence: member 0 did not "
                                 f"patch from the journal window {coh}")
        c0.query("SET @@tidb_tpu_device = 0")
        run(c0, m0, "q1", "host", want=mtruth)
        c0.query("SET @@tidb_tpu_device = 1")
        # 5. the store plane's own device path
        st0 = status(fleet.store_status_port)
        c1.query("SET @@tidb_tpu_fleet_local_cache = 0")
        run(c1, m1, "q1", "store_plane", want=mtruth)
        c1.query("SET @@tidb_tpu_fleet_local_cache = 1")
        st1 = status(fleet.store_status_port)
        out["store_plane_launches"] = st1["segsum_launches"] - \
            st0["segsum_launches"]
        if on_card and out["store_plane_launches"] <= 0:
            raise AssertionError("fleet: the store plane's coprocessor "
                                 "never launched the kernel")
        # 6. the cluster plane
        members_sql = ("SELECT member_id, role FROM "
                       "information_schema.cluster_members")
        for c in (c0, c1):
            roles = sorted(r[1] for r in c.query(members_sql)[1])
            if roles != ["sql", "sql", "store"]:
                raise AssertionError(f"fleet: cluster_members {roles}")
        res = c0.query("TRACE FORMAT='json' SELECT s_nationkey FROM supplier "
                       "WHERE s_suppkey = 7")
        tid = json.loads(res[1][0][0])["trace_id"]
        if tid <= 0xFFFFFF:
            raise AssertionError(f"fleet: trace id {tid} has no member "
                                 "nonce")
        store_ids = {r[0] for r in c1.query(members_sql)[1]
                     if r[1] == "store"}
        issuer = f"{fleet.host}:{m0.status_port}:"
        deadline = time.monotonic() + 20
        while True:
            hits = [r for r in c1.query(
                "SELECT member, origin_member FROM information_schema."
                f"cluster_statement_traces WHERE origin_trace_id = {tid}")[1]
                if r[0] in store_ids]
            if hits:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: no store-plane record of "
                                     f"trace {tid}")
            time.sleep(0.25)
        if not hits[0][1].startswith(issuer):
            raise AssertionError(f"fleet: origin_member {hits} is not "
                                 f"member 0 ({issuer})")
        out["trace"] = {"trace_id": tid, "store_records": len(hits)}
        for port in (m0.status_port, m1.status_port,
                     fleet.store_status_port):
            top = http_get(port, "/fleet/top")
            if len(top["members"]) != 3:
                raise AssertionError(f"fleet: /fleet/top on {port} {top}")
        # 8. (read before the SIGKILL) the kernel ran in each member
        for m in (m0, m1):
            doc = status(m.status_port)
            if on_card and doc["segsum_launches"] <= 0:
                raise AssertionError(f"fleet: the kernel never launched "
                                     f"in member {m.index}")
            shapes[f"fleet-member{m.index}"] = doc["segsum_shapes"]
        shapes["fleet-store"] = status(fleet.store_status_port)[
            "segsum_shapes"]
        out["launches"] = {p: sum(n for _k, n in s)
                           for p, s in shapes.items()}
        # 7. chaos
        c0.close()
        t0 = time.perf_counter()
        fleet.kill(0, signal.SIGKILL)
        run(c1, m1, "q1", "after_kill", want=mtruth)
        t0 = time.perf_counter()
        plist = c1.query("SELECT member, id FROM "
                         "information_schema.cluster_processlist")[1]
        plist_s = time.perf_counter() - t0
        warns = c1.query("SHOW WARNINGS")[1]
        dead = f"{fleet.host}:{m0.status_port}:"
        if plist_s >= 10 or not plist or \
                any(r[0].startswith(dead) for r in plist) or \
                not any("unreachable" in (r[2] or "") for r in warns):
            raise AssertionError(f"fleet: partial processlist after the "
                                 f"kill {plist} {warns} in {plist_s} s")
        out["processlist_after_kill_s"] = plist_s
        t0 = time.perf_counter()
        m0 = fleet.restart(0)
        fleet.wait_healthy(timeout=120)
        out["restart_s"] = time.perf_counter() - t0
        rejoined = f"{fleet.host}:{m0.status_port}:"
        deadline = time.monotonic() + 20
        while not any(r[0].startswith(rejoined)
                      for r in c1.query(members_sql)[1]):
            if time.monotonic() > deadline:
                raise AssertionError("fleet: restarted member 0 never "
                                     "rejoined cluster_members")
            time.sleep(0.25)
        c0 = WireClient(m0.port, db="tpch")
        run(c0, m0, "supplier", "after_restart", sql=small,
            want=small_truth)
        c0.close()
        c1.close()
    finally:
        procs = [m.proc for m in fleet.members] + [fleet.store_proc]
        fleet.stop()
        if os.path.exists(path):
            os.remove(path)
    alive = [p.pid for p in procs if p is not None and p.poll() is None]
    if alive:
        raise AssertionError(f"fleet: children still running {alive}")
    held = [t for t in memtrack.sessions_snapshot()
            if t["label"].startswith("session-") and t["host"] + t["device"]]
    if held:
        raise AssertionError(f"fleet: session ledgers held {held}")
    out["seconds"] = time.perf_counter() - phase_t0
    return out, shapes


def fleet_kernel_entries(fleet_shapes, timed, errs, held_on, dev,
                         seed) -> list:
    """The kernels line's entries of the fleet path: each process of the
    fleet reports its launches by shape on /status (the smoke cannot
    record a child's inputs). A shape other paths recorded carries their
    hold (`held_on` names them: the error is the largest on their
    inputs) and the first one's timing (`timed_on`); any other is held
    and timed here on four seeded inputs of the same shape
    (segsum_case)."""
    from tidb_tpu_torch.benchmarks import segsum_bench
    from tidb_tpu_torch.ops import segsum
    rng = np.random.default_rng(seed)
    out = []
    for path, shapes in fleet_shapes.items():
        for key, calls in shapes:
            key = tuple(key)
            if len(key) == 4:       # 1-D values: one lane
                key = (key[0], 1, *key[1:])
            n, k, c, dtype, mask = key
            where = f"{path}: {n}x{k} {dtype}, C={c}, {mask} mask"
            if key not in timed:
                worst = {"float32": 0.0, "float64": 0.0, "int64": 0}
                inputs = []
                for _ in range(4):
                    # ids in range, as a member's are (index_add_, the
                    # library call timed beside the kernel, asserts on
                    # one outside [0, C))
                    v, i, m = segsum_case(
                        rng, getattr(torch, dtype), n, k, c, mask, dev,
                        ids=rng.integers(0, c, n).astype(np.int32))
                    hold(segsum.segment_sum(v, i, c, valid=m), v, i, c, m,
                         where, worst)
                    inputs.append((v, i, m, c))
                seeded = f"{path} (seeded inputs of its shape)"
                timed[key] = {"timed_on": seeded,
                              **segsum_bench.time_shape(inputs)}
                errs[key] = max(worst.values())
                held_on[key] = [seeded]
            out.append((where, path, calls, errs[key], 0, timed[key],
                        ", ".join(held_on[key])))
    return out


# The legs phase: skew_join at SF 1's sizes (400,000 facts, 20,000
# dimension rows) with one timed device run and one host run a statement
# (the north-star block's are 5 and 2), the kernel-only micro at 2^20
# rows, multichip's planes of 1, 2, 4 and 8 shards on the card; every
# other leg at the reference's defaults (tidb_tpu_torch.bench.LEGS)
LEGS_SKEW_SF = 1.0
LEGS_SKEW_ITERS = (1, 1)
LEGS_INPROCESS = ("encoded", "trace", "profile", "lintcheck", "serve",
                  "chaos")


def _headline(leg: str, line: dict) -> dict:
    """A leg's line abridged to its headline numbers."""
    d = line["detail"]
    if leg == "encoded":
        return {q: {k: v[k] for k in ("encoded_secs", "decoded_secs",
                                      "speedup", "encoding_fallbacks")} |
                {"bytes_ratio": v["bytes_touched"]["ratio"]}
                for q, v in d["queries"].items()}
    if leg == "trace":
        q1 = d["latency_attribution"]["q1"]
        return {"traces": d["traces"], "chrome_events": d["chrome_events"],
                "q1_p99_ms": q1["statement"]["p99_ms"],
                "q1_p99_coverage": q1.get("p99_coverage"),
                "spans": d["trace_stmt_spans"]}
    if leg == "profile":
        return {k: d[k] for k in ("kernel_profile_rows",
                                  "kernel_profile_families",
                                  "statement_profile_rows",
                                  "statement_profile_modes",
                                  "compiles_after_cold",
                                  "compiles_per_warm_iter", "roofline")}
    if leg == "lintcheck":
        return {k: d[k] for k in (
            "lint_clean", "lint_rules", "lint_seconds", "traced_sites",
            "families_checked", "compiles_after_cold",
            "compiles_after_warm", "rows_over_bound", "segsum_launches")}
    if leg == "serve":
        conc, pin = d["concurrent"], d["pinched"]
        return {"serialized_rows_per_sec": d["serialized"]["rows_per_sec"],
                "concurrent_rows_per_sec": conc["rows_per_sec"],
                "speedup_vs_serialized": conc["speedup_vs_serialized"],
                "latency": conc["latency"],
                "sched_stall_seconds": conc["sched_stall_seconds"],
                "pinched": {k: pin[k] for k in (
                    "quota_bytes", "secs", "rows_per_sec", "completed",
                    "admission", "busy_retries", "oom_cancels")},
                "utilization": {k: d["utilization"][k] for k in (
                    "device_busy_fraction", "device_busy_secs",
                    "attribution_coverage")}}
    if leg == "chaos":
        return {k: d[k] for k in (
            "secs", "ops_completed", "writes_completed", "retries",
            "failpoints_armed", "failpoint_fires", "watchdog_fires",
            "quarantines", "worker_restarts", "device_fallbacks",
            "oom_cancels", "post_chaos_healthy", "sched_inflight_end",
            "server_ledger_host_end", "server_ledger_device_end",
            "passed")} | {"attribution_coverage":
                          d["utilization"]["attribution_coverage"]}
    if leg == "multichip":
        return {"per_chip_ratio_1_to_n": d["per_chip_ratio_1_to_n"],
                "serve_aggregate_by_n": d["serve_aggregate_by_n"],
                "per_chip_rows_per_sec": {
                    lg["n_devices"]: {q: v["per_chip_rows_per_sec"]
                                      for q, v in lg["queries"].items()}
                    for lg in d["legs"]},
                "mesh_fallbacks": [lg["mesh_fallbacks"] for lg in d["legs"]],
                "checks": d["checks"]}
    if leg == "fleet":
        return {"start_secs": d["start_secs"],
                "rows_loaded": d["rows_loaded"],
                "stmts_per_sec": {lg["servers"]: lg["stmts_per_sec"]
                                  for lg in d["legs"]},
                "latency": {lg["servers"]: lg["latency"]
                            for lg in d["legs"]},
                "scaling_max_vs_1": d["scaling_max_vs_1"],
                "launches": {m: v["segsum_launches"]
                             for m, v in d["kernel_launches"].items()}}
    if leg == "htap":
        return {r: {k: v[k] for k in ("analytic_rows_per_sec",
                                      "vs_read_only", "freshness_ms_max")}
                for r, v in d["rates"].items()}
    return {}


def legs_phase(args, dev, recorded, htap_sweep) -> tuple[dict, dict]:
    """bench.py's other legs on the card, each as `python -m
    tidb_tpu_torch.bench LEG` runs it (bench.run_leg), in process: encoded,
    trace, profile, lintcheck, serve and chaos at the reference's defaults,
    each on a store of its own; the skew_join block on a store of its own at
    LEGS_SKEW_SF; the kernel-only micro at 2^20 rows (held against numpy);
    multichip over planes of 1, 2, 4 and 8 shards on the card; the fleet leg
    with four SQL members (each process's launches from its /status);
    `python -m tidb_tpu_torch.bench trace` once as a child; and check_htap's
    verdict on the htap phase's sweep. One line per leg: its seconds and
    launches, its headline numbers, the invariants of its contract that
    failed and its performance floors with their verdicts. The phase fails
    on a leg that raised, a failed invariant (a wrong result, a non-
    retryable error, a stuck statement, an OOM cancel, a ledger or slot
    left, an encoding or mesh fallback, an unbalanced trace tree, an empty
    kernel profile, a lint that is not clean or a kernel family constructing
    past the lint's static model, attribution coverage outside [0.9, 1.1]),
    a leg whose device statements did not launch the segment-sum kernel (a
    fleet member's, on its /status), a scheduler slot left after a leg, a
    pinched serve leg that never met the retryable 9008 (its 8175 is an OOM
    cancel), a skew_join fallback or a disagreeing micro. The floors (the
    fleet's 2.0x scaling, htap's 0.5 vs_read_only, multichip's 0.75 ratio
    and serve_scales) only print. Its segment_sum calls go to
    recorded["legs"].
    -> (the phase's line, the fleet members' launches by shape)."""
    import gc
    from tidb_tpu_torch import bench, sched
    from tidb_tpu_torch.benchmarks import (contracts, htap, kernelmicro,
                                           segsum_bench, skewjoin)
    from tidb_tpu_torch.benchmarks.common import progress_printer
    from tidb_tpu_torch.ops import segsum
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"phase": "legs", "legs": {}}
    bad = []
    fleet_shapes = {}

    def report(leg, seconds, launches, line=None, failures=(), **extra):
        inv = contracts.invariants(list(failures))
        flo = contracts.floors(list(failures))
        rec = {"phase": "legs", "leg": leg, "seconds": seconds,
               "launches": launches, **extra}
        if line is not None:
            rec.update(metric=line["metric"], value=line["value"],
                       vs_baseline=line.get("vs_baseline"),
                       headline=_headline(leg, line))
        rec.update(invariants_failed=inv, floors_failed=flo,
                   floors_verdict="held" if not flo else "missed")
        emit(rec)
        out["legs"][leg] = {"seconds": seconds, "launches": launches,
                            "invariants_failed": len(inv),
                            "floors_failed": len(flo)}
        bad.extend(f"{leg}: {f}" for f in inv)
        return rec

    def slots_free(leg):
        snap = sched.device_scheduler().snapshot()
        if snap["inflight"] or snap["waiting"]:
            bad.append(f"{leg}: scheduler slots left {snap}")

    segsum.launches = 0
    with segsum_bench.record_calls() as rec:
        for leg in LEGS_INPROCESS:
            l0, t0 = segsum.launches, time.perf_counter()
            line, failures = bench.run_leg(leg, progress_printer(leg),
                                           device=str(dev))
            launched = segsum.launches - l0
            if dev.type == "cuda" and not launched:
                bad.append(f"{leg}: the segment-sum kernel never launched")
            if leg == "serve" and dev.type == "cuda" and \
                    not line["detail"]["pinched"]["busy_retries"]:
                bad.append("serve: the pinched leg never met the "
                           "retryable 9008")
            report(leg, time.perf_counter() - t0, launched, line, failures)
            slots_free(leg)

        l0, t0 = segsum.launches, time.perf_counter()
        storage = new_mock_storage(device=dev)
        sess = Session(storage)
        try:
            sess.execute("CREATE DATABASE skew")
            sess.execute("USE skew")
            skew = skewjoin.run(sess, storage, LEGS_SKEW_SF,
                                *LEGS_SKEW_ITERS, progress_printer("skew"))
        finally:
            sess.close()
            storage.close()
        launched = segsum.launches - l0
        fb = {q: skew[q]["fallbacks"] for q in skewjoin.QUERIES}
        if any(fb.values()):
            bad.append(f"skew_join: device fallbacks {fb}")
        if dev.type == "cuda" and not launched:
            bad.append("skew_join: the segment-sum kernel never launched")
        report("skew_join", time.perf_counter() - t0, launched,
               rows=skew["rows"], headline={
                   q: {k: skew[q][k] for k in (
                       "device_secs", "host_secs", "speedup", "fallbacks",
                       "partitions_spilled", "hot_lane_rows")}
                   for q in skewjoin.QUERIES},
               quota_spill=skew.get("quota_spill"))
        slots_free("skew_join")

        l0, t0 = segsum.launches, time.perf_counter()
        micro = kernelmicro.run(device=dev)
        err = kernelmicro.hold(micro["result"],
                               kernelmicro.lineitem_chunk(micro["rows"]))
        launched = segsum.launches - l0
        if err > 1e-9 or (dev.type == "cuda" and not launched):
            bad.append(f"kernel micro: relative error {err}, "
                       f"{launched} launches")
        report("kernel_only", time.perf_counter() - t0, launched,
               kernel_only_q1_rows_per_sec=micro["rows_per_sec"],
               rows=micro["rows"], iters=micro["iters"],
               max_rel_err=err)

        l0, t0 = segsum.launches, time.perf_counter()
        line, failures = bench.run_leg("multichip",
                                       progress_printer("multichip"),
                                       device=str(dev))
        launched = segsum.launches - l0
        if dev.type == "cuda" and not launched:
            bad.append("multichip: the segment-sum kernel never launched")
        report("multichip", time.perf_counter() - t0, launched, line,
               failures)
        slots_free("multichip")
        launched_here = segsum.launches
    recorded["legs"] = recorded_path("legs", rec, launched_here)

    t0 = time.perf_counter()
    child_args = ["--device", str(dev)] if dev.type != "cuda" else []
    line, failures = bench.run_leg("fleet", progress_printer("fleet"),
                                   device=str(dev))
    members = {m: v for m, v in line["detail"]["kernel_launches"].items()
               if m != "store"}
    for m, v in line["detail"]["kernel_launches"].items():
        fleet_shapes[f"legs-fleet-{m}"] = v["segsum_shapes"]
        if dev.type == "cuda" and m != "store" and not v["segsum_launches"]:
            bad.append(f"fleet member {m}: the segment-sum kernel never "
                       f"launched")
    report("fleet", time.perf_counter() - t0,
           {m: v["segsum_launches"]
            for m, v in line["detail"]["kernel_launches"].items()},
           line, failures, members=len(members))

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    child = subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.bench", "trace",
         *child_args], cwd=root, capture_output=True, text=True,
        timeout=600)
    try:
        cli_line = json.loads(child.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        cli_line = None
    if child.returncode != 0 or cli_line is None or \
            cli_line.get("metric") != "trace_bench_traces_retained":
        bad.append(f"trace CLI: rc {child.returncode}, "
                   f"{child.stderr[-500:]!r}")
    report("trace_cli", time.perf_counter() - t0, None, returncode=
           child.returncode, metric=None if cli_line is None else
           cli_line.get("metric"), value=None if cli_line is None else
           cli_line.get("value"))

    line = htap.line(htap_sweep)
    report("htap", 0.0, None, line, contracts.check("htap", line),
           source="the htap phase's sweep")
    out["seconds"] = sum(v["seconds"] for v in out["legs"].values())
    if bad:
        raise AssertionError(f"legs: {bad}")
    return out, fleet_shapes


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
    # (Q3, its quota run and Q5 took 50.0, 40.8 and 71.9 s at SF 10 on
    # the card: DEFAULT_SF)
    ap.add_argument("--sf", type=float, default=DEFAULT_SF,
                    help=f"TPC-H scale factor (default {DEFAULT_SF:g})")
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
    t_start = time.perf_counter()
    walls = {}

    def timed(name, fn, *a, **kw):
        """Run one phase, keeping its wall seconds for the wall line."""
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        walls[name] = time.perf_counter() - t0
        return res

    smi = nvidia_smi()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})

    root = os.path.dirname(os.path.abspath(__file__))
    emit(timed("build", build_phase, root))

    parity = timed("parity", check_segsum, dev)
    d, tables, gen_s = timed("generate", generate, args)
    recorded = {}
    emit(timed("q1", run_q1_phase, args, dev, d, tables["lineitem"], gen_s,
               recorded))
    for name in ("q3", "q5"):
        emit(timed(name, run_query_phase, name, args, dev, d, tables,
                   recorded))
    emit(timed("analyze", analyze_phase, args, dev, tables))
    emit(timed("q18", q18_phase, args, dev, d, tables, recorded))
    del d, tables
    out, kept = timed("sql", sql_phase, args, dev, recorded)
    emit(out)
    emit(timed("mesh", mesh_phase, args, dev, recorded, **kept))
    emit(timed("bench", bench_step, args, dev, recorded, **kept))
    emit(timed("store", store_phase, args, dev, recorded, **kept))
    out, kept = timed("htap", htap_phase, args, dev, recorded, **kept)
    emit(out)
    htap_sweep = out["sweep"]
    out, kept = timed("sqlrest", sqlrest_phase, args, dev, recorded, **kept)
    emit(out)
    emit(timed("server", server_phase, args, dev, recorded, **kept))
    del kept    # the earlier phases' store and its HBM blocks go
    out, fleet_shapes = timed("fleet", fleet_phase, args, dev)
    emit(out)
    out, legs_shapes = timed("legs", legs_phase, args, dev, recorded,
                             htap_sweep)
    emit(out)
    fleet_shapes.update(legs_shapes)
    emit(timed("faults", faults_phase, args, dev))
    t_kernel = time.perf_counter()

    # the kernel at every shape the three paths gave it, on their own
    # recorded inputs: held against the plain version, then timed
    # every path's recorded calls are held on their own inputs; a shape
    # (rows, lanes, C, dtype, mask) is timed once, on the first path that
    # recorded it, and later paths of the same shape carry that timing
    # (`timed_on` names the path)
    from tidb_tpu_torch.benchmarks import segsum_bench
    entries, timed, errs, held_on = [], {}, {}, {}
    for path, rec in recorded.items():
        for key, ent in rec.shapes.items():
            n, k, c, dtype, mask = key
            where = f"{path}: {n}x{k} {dtype}, C={c}, {mask} mask"
            worst = {"float32": 0.0, "float64": 0.0, "int64": 0}
            for v, i, m, _c in ent["inputs"]:
                hold(segsum.segment_sum(v, i, c, valid=m), v, i, c, m,
                     where, worst)
            if key not in timed:
                timed[key] = {"timed_on": path,
                              **segsum_bench.time_shape(ent["inputs"])}
            errs[key] = max(errs.get(key, 0), *worst.values())
            held_on.setdefault(key, []).append(path)
            entries.append((where, path, ent["calls"], max(worst.values()),
                            len(ent["inputs"]), timed[key], path))
    entries += fleet_kernel_entries(fleet_shapes, timed, errs, held_on, dev,
                                    args.seed)
    emit({"phase": "kernel", "name": "segment_sum", **parity,
          "timing": {where: {"launches": calls, "inputs_held": held,
                             "held_on": on, **t}
                     for where, _p, calls, _e, held, t, on in entries}})
    walls["kernel"] = time.perf_counter() - t_kernel
    emit({"phase": "wall", "seconds": walls,
          "total_s": time.perf_counter() - t_start})

    emit({"kernels": [{
        "name": f"segment_sum ({where})", "route": "cuda",
        "source": "tidb_tpu_torch/csrc/segsum.cu",
        "replaces": "tidb_tpu/ops/pallas_agg.py:147",
        "launches": calls, "path": path, "timed_on": t["timed_on"],
        "held_on": on, "max_abs_err": err, "ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}
        for where, path, calls, err, _h, t, on in entries]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
