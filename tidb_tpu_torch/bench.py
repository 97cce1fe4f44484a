"""The port's bench entry: TPC-H Q1/Q3/Q5 end to end, rows/s per card.

    python -m tidb_tpu_torch.bench [--sf 1] [--iters 5] [--host-iters 2]
                                   [--seed 42] [--device cuda]

The port of the leg of the JAX package's `bench.py: main` that prints
the north-star line. It loads ScaledTpch into the port's `Session` on
one mock store, then for each query runs it with `tidb_tpu_device = 1`
(one cold run that fills the chunk and HBM caches, then the best of
`iters` warm runs) and with `tidb_tpu_device = 0` (the numpy host path,
one fill run, then the best of `host_iters`), on the same store. The two
modes must return equal rows (floats within 1e-9 relative), or the run
exits non-zero. It prints one JSON line with `bench.py`'s keys:

  * `metric`: tpch_q1_q3_q5_e2e_rows_per_sec_per_chip, `value` the
    geomean over the queries of the device path's input rows/s;
  * `unit`: rows/s; `vs_baseline`: the geomean of device/host speedups;
  * `detail`: per query the device and host seconds and rows/s,
    `device_scan_gbps` (input bytes in the columnar layout over the warm
    seconds) and `roofline_fraction` against the card's peak
    (`profiler.HBM_PEAK_GBPS`), cold/warm split, HBM cache traffic,
    superchunks and kernel launches; the iteration counts and the
    coprocessor mode (`copr_stream`: 1 streamed, 0 materialized); the
    card's `nvidia-smi` name and power limit.

Unlike `bench.py`, it never falls back to the CPU: without CUDA it
exits non-zero unless `--device cpu` is given. `run(...)` takes a loaded
session and store, so a caller (chip_smoke.py) can time the same store
it already holds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

__all__ = ["KEYS", "run", "main"]

METRIC = "tpch_q1_q3_q5_e2e_rows_per_sec_per_chip"
# the keys of bench.py's JSON line
KEYS = ("metric", "value", "unit", "vs_baseline", "detail")

_TABLE_PREFIX = {"region": "r_", "nation": "n_", "customer": "c_",
                 "supplier": "s_", "orders": "o_", "lineitem": "l_"}


def rows_equal(a, b) -> bool:
    """Device and host rows agree: exact, floats within 1e-9 relative."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                fx, fy = float(x), float(y)
                if abs(fx - fy) > max(1e-6, abs(fy) * 1e-9):
                    return False
            elif x != y:
                return False
    return True


def _time_query(session, sql: str, iters: int) -> tuple[float, list]:
    """-> (best seconds, rows) over `iters` full Session.query runs."""
    best, rows = math.inf, None
    for _ in range(iters):
        t0 = time.perf_counter()
        r = session.query(sql)
        best = min(best, time.perf_counter() - t0)
        rows = r.rows
    return best, rows


def _query_bytes(data, qname: str) -> int:
    """Bytes the query's input tables occupy in the columnar layout:
    8-byte lanes for fixed-width columns, utf8 length for strings."""
    import numpy as np
    from tidb_tpu_torch.benchmarks import tpch
    total = 0
    for tname in tpch.QUERY_TABLES[qname]:
        pref = _TABLE_PREFIX[tname]
        for name in vars(data):
            if not name.startswith(pref):
                continue
            a = np.asarray(getattr(data, name))
            if a.ndim != 1:
                continue
            if a.dtype == np.dtype(object):
                total += int(sum(len(str(x)) for x in a))
            else:
                total += int(a.size * 8)
    return total


def _hbm_counters() -> dict:
    from tidb_tpu_torch import metrics
    snap = metrics.snapshot()
    return {"hits": int(snap.get(metrics.HBM_CACHE_HITS, 0)),
            "misses": int(snap.get(metrics.HBM_CACHE_MISSES, 0)),
            "evictions": int(snap.get(metrics.HBM_CACHE_EVICTIONS, 0))}


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
    queries = {"q1": tpch.Q1, "q3": tpch.Q3, "q5": tpch.Q5}
    prev = config.get_var("tidb_tpu_device")
    try:
        for qname, sql in queries.items():
            in_rows = sum(data.counts[t] for t in tpch.QUERY_TABLES[qname])
            in_bytes = _query_bytes(data, qname)
            config.set_var("tidb_tpu_device", 1)
            hbm0 = _hbm_counters()
            launches0 = segsum.launches
            t0 = time.perf_counter()
            session.query(sql)     # chunk + HBM cache fill
            cold = time.perf_counter() - t0
            sc = _superchunks(session)
            hbm_cold = _hbm_counters()
            note(f"{qname}: device cold {cold:.3f}s")
            d_secs, d_rows = _time_query(session, sql, iters)
            hbm_warm = _hbm_counters()
            launches = segsum.launches - launches0
            config.set_var("tidb_tpu_device", 0)
            session.query(sql)     # the same cache fill for the host
            h_secs, h_rows = _time_query(session, sql, host_iters)
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
    detail["hbm_cache_totals"] = _hbm_counters()
    detail["roofline_fraction_geomean"] = _geomean(rooflines)
    return {"metric": METRIC, "value": _geomean(device_rps),
            "unit": "rows/s", "vs_baseline": _geomean(speedups),
            "detail": detail}


def _geomean(xs) -> float:
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def main(argv=None) -> int:
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
    args = p.parse_args(argv)
    from tidb_tpu_torch.ops.runtime import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"[bench] cannot run: {e}", file=sys.stderr, flush=True)
        return 2
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage

    t_start = time.perf_counter()

    def progress(msg: str) -> None:
        print(f"[bench +{time.perf_counter() - t_start:8.1f}s] {msg}",
              file=sys.stderr, flush=True)

    progress(f"generating TPC-H sf={args.sf} on {device}")
    data = tpch.ScaledTpch(args.sf, args.seed)
    storage = new_mock_storage(device=device)
    session = Session(storage)
    session.execute("CREATE DATABASE tpch")
    session.execute("USE tpch")
    t0 = time.perf_counter()
    total = tpch.load(session, storage, data,
                      regions_per_table=args.regions)
    load_secs = time.perf_counter() - t0
    progress(f"loaded {total} rows in {load_secs:.1f}s")
    try:
        line = run(session, storage, data, args.iters, args.host_iters,
                   progress)
    except RuntimeError as e:
        print(f"[bench] {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        session.close()
        storage.close()
    line["detail"].update(rows_loaded=total, load_secs=load_secs)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
