"""SSB-shaped streaming wide-scan benchmark: the port of the JAX package's
benchmarks/ssb.py (BASELINE config 5).

A Star-Schema-Benchmark lineorder-shaped wide fact table (13 BIGINT
columns, the reference's generator and seed) is bulk-loaded into the
mock store, split into N regions, and aggregated by an SSB Q1.1-shaped
query

    SELECT SUM(lo_extendedprice * lo_discount) FROM lineorder
    WHERE lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25

plus a grouped variant, with `tidb_tpu_stream_rows` forced BELOW the
table size so the plane's aggregation streams dispatch-ahead
super-batches (batch k+1 launches while batch k drains). Each query runs
twice on the device plane (the first warms the caches) and once on the
host path (`tidb_tpu_device = 0`, the plane off); the rows must agree.
`truth(rows)` computes both answers from the generated columns with
numpy.

    python3 -m tidb_tpu_torch.benchmarks.ssb [--sf F] [--regions N]
        [--stream-rows N] [--shards N] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

__all__ = ["DDL", "Q11", "QGRP", "columns", "truth", "setup", "run",
           "main"]

DDL = """CREATE TABLE lineorder (
    lo_orderkey BIGINT PRIMARY KEY, lo_linenumber BIGINT,
    lo_custkey BIGINT, lo_partkey BIGINT, lo_suppkey BIGINT,
    lo_orderdate BIGINT, lo_quantity BIGINT, lo_extendedprice BIGINT,
    lo_ordtotalprice BIGINT, lo_discount BIGINT, lo_revenue BIGINT,
    lo_supplycost BIGINT, lo_tax BIGINT)"""

Q11 = ("SELECT SUM(lo_extendedprice * lo_discount) FROM lineorder "
       "WHERE lo_discount >= 1 AND lo_discount <= 3 "
       "AND lo_quantity < 25")
QGRP = ("SELECT lo_discount, COUNT(*), SUM(lo_revenue) FROM lineorder "
        "WHERE lo_quantity < 30 GROUP BY lo_discount")


def columns(n: int) -> dict:
    """The reference's lineorder columns for `n` rows (seed 7)."""
    rng = np.random.default_rng(7)
    return {
        "lo_orderkey": np.arange(n, dtype=np.int64),
        "lo_linenumber": rng.integers(1, 8, n),
        "lo_custkey": rng.integers(0, 30_000, n),
        "lo_partkey": rng.integers(0, 200_000, n),
        "lo_suppkey": rng.integers(0, 2_000, n),
        "lo_orderdate": rng.integers(0, 2556, n),
        "lo_quantity": rng.integers(1, 51, n),
        "lo_extendedprice": rng.integers(90_000, 10_000_000, n),
        "lo_ordtotalprice": rng.integers(100_000, 38_000_000, n),
        "lo_discount": rng.integers(0, 11, n),
        "lo_revenue": rng.integers(80_000, 9_000_000, n),
        "lo_supplycost": rng.integers(50_000, 120_000, n),
        "lo_tax": rng.integers(0, 9, n)}


def truth(cols: dict) -> dict:
    """Q11's and QGRP's rows from the columns, with numpy: Q11 one row
    (its exact integer sum), QGRP one row per discount in ascending
    order."""
    d, q = cols["lo_discount"], cols["lo_quantity"]
    m = (d >= 1) & (d <= 3) & (q < 25)
    q11 = [(int((cols["lo_extendedprice"][m].astype(object) *
                 d[m].astype(object)).sum()),)]
    g = q < 30
    qgrp = []
    for v in np.unique(d[g]):
        sel = g & (d == v)
        qgrp.append((int(v), int(sel.sum()),
                     int(cols["lo_revenue"][sel].astype(object).sum())))
    return {"q11": q11, "qgrp": qgrp}


def setup(storage, n: int, regions: int, cols: dict | None = None):
    """Create ssb.lineorder in `storage`, bulk-load `n` rows and split
    the table into `regions` regions. -> (Session, columns, load secs)."""
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.table import Table, bulkload
    if cols is None:
        cols = columns(n)
    s = Session(storage)
    s.execute("CREATE DATABASE ssb")
    s.execute("USE ssb")
    s.execute(DDL)
    info = s.domain.info_schema().table("ssb", "lineorder")
    t0 = time.perf_counter()
    bulkload.bulk_load(storage, Table(info, storage), cols)
    s.execute(f"SPLIT TABLE lineorder REGIONS {regions}")
    return s, cols, time.perf_counter() - t0


def run(sf: float = 0.1, regions: int = 16,
        stream_rows: int | None = None, device=None,
        shards: int | None = None) -> dict:
    """Load SSB at `sf` on `device` (CUDA unless the caller asks for
    another), then run Q11 and QGRP on a plane of `shards` shards (one
    per visible device by default) and on the host path, with
    `tidb_tpu_stream_rows` below the table size. -> the reference's
    report (rows, regions, stream_rows, load_secs, and per query
    device_secs, host_secs, rows_per_sec, speedup) plus each query's
    device rows."""
    from tidb_tpu_torch import config, devplane
    from tidb_tpu_torch.store.storage import new_mock_storage

    n = int(6_000_000 * sf)
    storage = new_mock_storage(device=device)
    s, _cols, load_secs = setup(storage, n, regions)
    # force the streaming plane path: batches well below the table size
    if stream_rows is None:
        stream_rows = max(1 << 17, n // 8)
    prev_stream = config.get_var("tidb_tpu_stream_rows")
    prev_device = config.get_var("tidb_tpu_device")
    prev_mesh = devplane.active_mesh()
    config.set_var("tidb_tpu_stream_rows", int(stream_rows))

    out = {"rows": n, "regions": regions, "stream_rows": int(stream_rows),
           "load_secs": round(load_secs, 2)}
    try:
        for name, sql in (("q11", Q11), ("qgrp", QGRP)):
            config.set_var("tidb_tpu_device", 1)
            devplane.enable_mesh(shards, device=storage.device)
            s.query(sql)                  # warm
            t0 = time.perf_counter()
            dev_rows = s.query(sql).rows
            d = time.perf_counter() - t0
            config.set_var("tidb_tpu_device", 0)
            devplane.disable_mesh()
            t0 = time.perf_counter()
            host_rows = s.query(sql).rows
            h = time.perf_counter() - t0
            assert sorted(map(str, dev_rows)) == \
                sorted(map(str, host_rows))
            out[name] = {"device_secs": round(d, 4),
                         "host_secs": round(h, 4),
                         "rows_per_sec": round(n / d, 1),
                         "speedup": round(h / d, 2),
                         "device_rows": dev_rows}
            print(f"{name}: device {d:.3f}s host {h:.3f}s "
                  f"({n / d:.0f} rows/s, {h / d:.2f}x)", flush=True)
    finally:
        # restore process-global knobs: library callers (and the tests)
        # must not inherit this harness's device/stream/plane state
        config.set_var("tidb_tpu_stream_rows", prev_stream)
        config.set_var("tidb_tpu_device", prev_device)
        devplane.configure_mesh(prev_mesh)
        s.close()
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, dict)} |
                     {k: {f: x for f, x in v.items() if f != "device_rows"}
                      for k, v in out.items() if isinstance(v, dict)}),
          flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tidb_tpu_torch.benchmarks.ssb")
    p.add_argument("--sf", type=float, default=0.1)
    p.add_argument("--regions", type=int, default=16)
    p.add_argument("--stream-rows", type=int, default=None)
    p.add_argument("--shards", type=int, default=None,
                   help="plane shards (default: one per visible device)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    run(args.sf, args.regions, args.stream_rows, device=args.device,
        shards=args.shards)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
