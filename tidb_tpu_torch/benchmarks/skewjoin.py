"""The skew-join block of the north-star line: the port's counterpart of
the JAX package's `bench.py: _skew_join_bench`.

A Zipf-skewed join and a high-cardinality aggregate (seed 20260803):
`skew_c` (id, seg = id % 11) of max(4096, 20000 * sf) rows and `skew_o`
(id, cid, amt) of max(30000, 400000 * sf) rows, whose cid is uniform over
the dimension and an eighth past it, with three hot keys taking 30 %, 8 %
and 4 % of the rows. After ANALYZE of both, `skew_join` and `skew_agg`
run on the device (a cold run, then the best of `iters`) and on the host
(`tidb_tpu_device = 0`), which must agree; fallbacks, spilled partitions
and hot-lane rows are counted around the device runs. Last, the join
runs again under `tidb_tpu_superchunk_rows = 4096` and a query quota
stepped down from its peak until the spill fires: the join must complete.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch.benchmarks.common import (fallback_counters, geomean,
                                              rows_equal, time_query)

__all__ = ["SEED", "QUERIES", "tables", "setup", "run"]

SEED = 20260803
QUERIES = {
    "skew_join": "SELECT c.seg, COUNT(*), SUM(o.amt) FROM skew_o o "
                 "JOIN skew_c c ON o.cid = c.id GROUP BY c.seg "
                 "ORDER BY c.seg",
    "skew_agg": "SELECT cid, COUNT(*), SUM(amt) FROM skew_o "
                "GROUP BY cid ORDER BY cid LIMIT 10",
}
DDL = ["CREATE TABLE skew_c (id BIGINT PRIMARY KEY, seg BIGINT)",
       "CREATE TABLE skew_o (id BIGINT PRIMARY KEY, cid BIGINT, amt DOUBLE)"]


def sizes(sf: float) -> tuple[int, int]:
    """-> (dimension rows, fact rows) at scale factor `sf`."""
    return max(4096, int(20000 * sf)), max(30000, int(400000 * sf))


def tables(sf: float, seed: int = SEED) -> dict:
    """{"skew_c": columns, "skew_o": columns} as the reference makes
    them (numpy arrays by column name)."""
    n_dim, n_fact = sizes(sf)
    rng = np.random.default_rng(seed)
    cid = rng.integers(0, n_dim + n_dim // 8, n_fact)
    for frac, hk in zip((0.30, 0.08, 0.04), (7, 42, 1001)):
        cid[rng.random(n_fact) < frac] = hk
    dim_ids = np.arange(n_dim, dtype=np.int64)
    return {"skew_c": {"id": dim_ids, "seg": dim_ids % 11},
            "skew_o": {"id": np.arange(n_fact, dtype=np.int64),
                       "cid": cid.astype(np.int64),
                       "amt": rng.uniform(1, 100, n_fact).round(2)}}


def setup(session, storage, sf: float, seed: int = SEED) -> int:
    """CREATE and bulk-load both tables in the session's database, then
    ANALYZE them. -> rows loaded."""
    from tidb_tpu_torch.table import Table, bulkload
    for sql in DDL:
        session.execute(sql)
    ischema = session.domain.info_schema()
    cols = tables(sf, seed)
    for name, c in cols.items():
        bulkload.bulk_load(storage, Table(
            ischema.table(session.current_db, name), storage), c)
    # ANALYZE builds the probe side's CMSketch, which the planner hands
    # the hybrid join to seed its heavy hitters
    session.execute("ANALYZE TABLE skew_o")
    session.execute("ANALYZE TABLE skew_c")
    return sum(len(c["id"]) for c in cols.values())


def run(session, storage, sf: float, iters: int, host_iters: int,
        progress=None) -> dict:
    """Load, then time both statements in both modes and run the quota
    ladder. -> the line's `skew_join` block. Raises RuntimeError where
    the modes disagree. Leaves `tidb_tpu_device` at 1, as it found it on
    the bench's path."""
    from tidb_tpu_torch import config
    progress = progress or (lambda msg: None)
    progress("skew_join: loading the Zipf-skewed workload")
    in_rows = setup(session, storage, sf)
    n_fact = sizes(sf)[1]
    threshold = max(4096, n_fact // 50)
    out: dict = {"rows": in_rows, "skew_threshold": threshold,
                 "join_partitions": config.join_partitions()}
    thr_prev = config.get_var("tidb_tpu_skew_threshold")
    session.execute(f"SET tidb_tpu_skew_threshold = {threshold}")
    speedups = []
    try:
        for name, sql in QUERIES.items():
            config.set_var("tidb_tpu_device", 1)
            progress(f"{name}: device cold run")
            session.query(sql)
            c0 = fallback_counters()
            d_secs, d_rows = time_query(session, sql, iters)
            c1 = fallback_counters()
            try:
                config.set_var("tidb_tpu_device", 0)
                session.query(sql)
                h_secs, h_rows = time_query(session, sql, host_iters)
            finally:
                config.set_var("tidb_tpu_device", 1)
            if not rows_equal(d_rows, h_rows):
                raise RuntimeError(f"{name}: device and host disagree: "
                                   f"{d_rows[:3]} vs {h_rows[:3]}")
            d_rps, h_rps = in_rows / d_secs, in_rows / h_secs
            speedups.append(d_rps / h_rps)
            out[name] = {
                "device_secs": d_secs, "host_secs": h_secs,
                "device_rows_per_sec": d_rps, "host_rows_per_sec": h_rps,
                "speedup": d_rps / h_rps,
                "fallbacks": c1["fallbacks"] - c0["fallbacks"],
                "partitions_spilled": c1["partitions_spilled"] -
                c0["partitions_spilled"],
                "hot_lane_rows": c1["hot_lane_rows"] - c0["hot_lane_rows"]}
            progress(f"{name}: device {d_secs:.3f}s host {h_secs:.3f}s "
                     f"fallbacks {out[name]['fallbacks']}")
        out["speedup_geomean"] = geomean(speedups)
        spill = _quota_ladder(session)
        if spill is not None:
            out["quota_spill"] = spill
    finally:
        session.execute(f"SET tidb_tpu_skew_threshold = {thr_prev}")
    return out


def _quota_ladder(session) -> dict | None:
    """The join under quotas stepped down from its peak until the spill
    fires; small superchunks keep the in-flight probe footprint minor
    next to the build's residency. -> the last step's record (None where
    the peak is under 64 KiB)."""
    from tidb_tpu_torch import config
    sql = QUERIES["skew_join"]
    sc_prev = config.get_var("tidb_tpu_superchunk_rows")
    session.execute("SET tidb_tpu_superchunk_rows = 4096")
    rec = None
    try:
        session.query(sql)
        mem = session.last_mem
        peak = mem.host_peak + mem.device_peak if mem is not None else 0
        if peak <= 1 << 16:
            return None
        for step in (12, 14, 15, 16, 17, 18):
            quota = peak - (1 << step)
            c0 = fallback_counters()
            try:
                session.execute(f"SET tidb_tpu_mem_quota_query = {quota}")
                session.query(sql)
                spilled = fallback_counters()["partitions_spilled"] - \
                    c0["partitions_spilled"]
                rec = {"quota_bytes": quota, "completed": True,
                       "partitions_spilled": spilled}
                if spilled:
                    break
            except Exception as e:  # noqa: BLE001 - the record says it
                rec = {"quota_bytes": quota, "completed": False,
                       "error": str(e)}
                break
            finally:
                session.execute("SET tidb_tpu_mem_quota_query = 0")
    finally:
        session.execute(f"SET tidb_tpu_superchunk_rows = {sc_prev}")
    return rec
