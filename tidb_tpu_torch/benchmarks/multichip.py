"""The multichip series: the port's counterpart of the JAX package's
`python bench.py multichip` (`_multichip_child_main`, `multichip_main`).

Per plane size n (1, 2, 4, 8 shards by default), on one store loaded
once: TPC-H Q1 and Q3 with a plane of n shards (`devplane.enable_mesh(n)`;
n = 1 runs with no plane, as the reference's one-device child does),
one cold run and the best of `iters`; then `serve_rounds` point-shaped
statements (a selective aggregate over orders, which the plane does not
route) and the busy time the scheduler attributed to each shard. The
series reports per-chip rows/s (input rows over the best wall, at every
n), the ratio from the smallest to the largest n, the serving aggregate
(rows scanned over the busiest shard's attributed busy time) by n, and
the device fallbacks with reason="mesh", which must be none.

Unlike the reference, which starts a process per device count (XLA fixes
its device count when its backend starts), one process runs every n: the
plane's shards are spread over the visible devices, so on one card all n
shards share it, and the serving aggregate there measures the
attribution across shards, not an overlap between chips. Each leg's Q1
and Q3 rows must equal the first leg's.
"""

from __future__ import annotations

import os
import time

from tidb_tpu_torch.benchmarks.common import (fallbacks_by_reason,
                                              rows_equal, time_query)

__all__ = ["METRIC", "SERVE_SQL", "RATIO_FLOOR", "run", "leg",
           "checks", "line"]

METRIC = "multichip_per_chip_rows_per_sec_ratio_1_to_n"
SERVE_SQL = ("SELECT COUNT(*), SUM(o_orderdate) FROM orders "
             "WHERE o_custkey = {k}")
RATIO_FLOOR = 0.75


def _mesh_fallbacks() -> int:
    return fallbacks_by_reason().get("mesh", 0)


def leg(session, data, n: int, iters: int, serve_rounds: int, device,
        progress) -> tuple[dict, dict]:
    """One plane size on the loaded session. -> (the leg's record,
    {query: rows})."""
    from tidb_tpu_torch import config, devplane, sched
    from tidb_tpu_torch.benchmarks import tpch
    config.set_var("tidb_tpu_device", 1)
    if n > 1:
        devplane.enable_mesh(n, device=device)
    else:
        devplane.disable_mesh()
    fb0 = _mesh_fallbacks()
    queries, rows = {}, {}
    for qname in ("q1", "q3"):
        sql = tpch.QUERIES[qname]
        in_rows = sum(data.counts[t] for t in tpch.QUERY_TABLES[qname])
        session.query(sql)          # chunk and HBM cache fill
        secs, rows[qname] = time_query(session, sql, iters)
        queries[qname] = {"input_rows": in_rows, "best_secs": secs,
                          "per_chip_rows_per_sec": in_rows / secs}
        progress(f"multichip n={n}: {qname} "
                 f"{queries[qname]['per_chip_rows_per_sec']:.0f} "
                 f"rows/s/chip")
    n_cust = data.counts["customer"]
    session.query(SERVE_SQL.format(k=0))        # HBM fill
    scheduler = sched.device_scheduler()
    busy0 = scheduler.chip_busy_ns()
    grants0 = scheduler.snapshot()["grants"]
    t0 = time.perf_counter()
    for i in range(serve_rounds):
        session.query(SERVE_SQL.format(k=(i * 131) % n_cust))
    serve_wall = time.perf_counter() - t0
    busy1 = scheduler.chip_busy_ns()
    grants = scheduler.snapshot()["grants"] - grants0
    busy = {c: (busy1.get(c, 0) - busy0.get(c, 0)) / 1e9
            for c in busy1 if busy1.get(c, 0) > busy0.get(c, 0)}
    max_busy = max(busy.values(), default=0.0)
    served_rows = data.counts["orders"] * serve_rounds
    serve = {"statements": serve_rounds, "slot_grants": grants,
             "rows_scanned": served_rows, "wall_secs": serve_wall,
             "chips_used": len(busy),
             "per_chip_busy_secs": {str(c): s
                                    for c, s in sorted(busy.items())},
             "max_chip_busy_secs": max_busy,
             "aggregate_rows_per_sec": served_rows / max_busy if max_busy
             else 0.0}
    progress(f"multichip n={n}: serve {serve['aggregate_rows_per_sec']:.0f}"
             f" rows/s over {serve['chips_used']} chip(s)")
    plane = devplane.active_mesh()
    return ({"n_devices": n,
             "platform": "gpu" if str(device).startswith("cuda") else "cpu",
             "devices": [str(d) for d in plane.distinct()] if plane
             else [str(device)],
             "sf": data.sf, "queries": queries, "serve": serve,
             "mesh_fallbacks": _mesh_fallbacks() - fb0, "ok": True},
            rows)


def checks(legs: list, dev_counts) -> tuple[dict, dict, bool]:
    """bench.py's checks over the legs (bench.py:2543-2560). -> (checks,
    per-query ratios, ok)."""
    by_n = {lg["n_devices"]: lg for lg in legs if lg.get("ok")}
    out = {"per_chip_held": False, "serve_scales": False,
           "no_mesh_fallbacks": False}
    ratios = {}
    lo, hi = min(dev_counts), max(dev_counts)
    if lo in by_n and hi in by_n:
        for qname in by_n[lo]["queries"]:
            r1 = by_n[lo]["queries"][qname]["per_chip_rows_per_sec"]
            rn = by_n[hi]["queries"][qname]["per_chip_rows_per_sec"]
            ratios[qname] = rn / r1 if r1 else 0.0
        out["per_chip_held"] = bool(ratios) and \
            min(ratios.values()) >= RATIO_FLOOR
        s1 = by_n[lo]["serve"]["aggregate_rows_per_sec"]
        sn = by_n[hi]["serve"]["aggregate_rows_per_sec"]
        out["serve_scales"] = sn > s1 > 0
        out["no_mesh_fallbacks"] = all(
            lg.get("mesh_fallbacks", 1) == 0 for lg in legs)
    ok = all(out.values()) and len(by_n) == len(dev_counts)
    return out, ratios, ok


def run(progress=None, devs=(1, 2, 4, 8), sf: float = 0.05, iters: int = 3,
        serve_rounds: int = 32, seed: int = 42, device="cuda") -> dict:
    """Load TPC-H once, run a leg per plane size. -> the line's detail.
    Restores the process's plane and `tidb_tpu_device`."""
    from tidb_tpu_torch import config, devplane
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    progress = progress or (lambda msg: None)
    dev_counts = [int(n) for n in devs]
    data = tpch.ScaledTpch(sf, seed)
    storage = new_mock_storage(device=device)
    session = Session(storage)
    plane = devplane.active_mesh()
    saved = config.get_var("tidb_tpu_device")
    legs, first = [], None
    try:
        session.execute("CREATE DATABASE tpch")
        session.execute("USE tpch")
        total = tpch.load(session, storage, data, regions_per_table=4)
        progress(f"multichip: loaded {total} rows (sf={sf})")
        for n in dev_counts:
            rec, rows = leg(session, data, n, iters, serve_rounds, device,
                            progress)
            if first is None:
                first = rows
            rec["rows_equal_first"] = all(rows_equal(rows[q], first[q])
                                          for q in first)
            rec["ok"] = rec["rows_equal_first"]
            legs.append(rec)
    finally:
        devplane.configure_mesh(plane)
        config.set_var("tidb_tpu_device", saved)
        session.close()
        storage.close()
    chk, ratios, ok = checks(legs, dev_counts)
    by_n = {lg["n_devices"]: lg for lg in legs if lg.get("ok")}
    return {"device_counts": dev_counts, "legs": legs,
            "per_chip_ratio_1_to_n": ratios,
            "serve_aggregate_by_n": {
                str(n): by_n[n]["serve"]["aggregate_rows_per_sec"]
                for n in sorted(by_n)},
            "checks": chk, "ok": ok, "host_cpus": os.cpu_count(),
            "wall_model": "one process drives every shard of the plane; "
                          "per-chip rows/sec = input_rows / wall at every "
                          "n; serving makespan = busiest shard's "
                          "attributed busy time (shards on one card share "
                          "it: attribution across shards, not overlap "
                          "between chips)"}


def line(detail: dict) -> dict:
    """bench.py's line around the detail (bench.py:2562-2583)."""
    ratios = detail.get("per_chip_ratio_1_to_n", {})
    return {"metric": METRIC,
            "value": min(ratios.values()) if ratios else 0.0,
            "unit": "ratio",
            "vs_baseline": 1.0 if detail.get("ok") else 0.0,
            "detail": detail}


if __name__ == "__main__":
    import sys
    from tidb_tpu_torch.bench import leg_main
    raise SystemExit(leg_main("multichip", sys.argv[1:]))
