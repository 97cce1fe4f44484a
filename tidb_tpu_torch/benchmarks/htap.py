"""HTAP under write pressure: the port's counterpart of the JAX package's
`python bench.py htap` (`_htap_bench`, bench.py:438-622).

A TPC-C-style new-order/payment write mix runs through SQL from a second
session while a warm analytic GROUP BY runs over the same table, swept
over write rates. The tables, the data's seed, the analytic statement and
the writer's statements are the reference's:

  * `stock` (s_id, s_seg = s_id % 11, s_qty, s_ytd DOUBLE, s_cnt) and
    `orders` (o_id, o_item, o_amt), bulk-loaded from seed 20260804;
  * write `seq` touches stock row k = seq * 7919 % rows: an odd seq is a
    new-order (`UPDATE stock SET s_qty = s_qty - 1, s_cnt = seq` and
    `INSERT INTO orders VALUES (seq, k, 9.99)`), an even one a payment
    (`UPDATE stock SET s_ytd = s_ytd + 1.5, s_cnt = seq`), each
    statement in autocommit.

`setup` creates and loads the tables; `write_statements` gives one
write's SQL; `StockMirror` replays committed statements on the numpy
columns for an exact truth; `sweep` runs the reference's loop (the
writer on its own thread and session, one window per rate) and reports
per rate the reference's fields: achieved writes/s, write p99, analytic
rows/s, `vs_read_only`, freshness, delta serves, HBM hits and misses,
plus the port's own per-window kernel launches, fallbacks and the
largest statement ledger left. `run` and `line` are the leg as
`python -m tidb_tpu_torch.bench htap` runs it: a store of its own, the
sweep with its utilization block, and `bench.py`'s htap line.

    python3 -m tidb_tpu_torch.benchmarks.htap [--rows 60000] [--secs 5]
        [--rates 0,20,100] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time

import numpy as np

from tidb_tpu_torch.benchmarks.common import percentile

__all__ = ["DDL", "ANALYTIC", "SEED", "METRIC", "stock_columns",
           "setup", "write_statements", "StockMirror", "sweep", "run", "line",
           "percentile"]

DDL = ["CREATE TABLE stock (s_id BIGINT PRIMARY KEY, s_seg BIGINT, "
       "s_qty BIGINT, s_ytd DOUBLE, s_cnt BIGINT)",
       "CREATE TABLE orders (o_id BIGINT PRIMARY KEY, o_item BIGINT, "
       "o_amt DOUBLE)"]
ANALYTIC = ("SELECT s_seg, COUNT(*), SUM(s_qty), SUM(s_ytd), MAX(s_cnt) "
            "FROM stock GROUP BY s_seg ORDER BY s_seg")
SEED = 20260804
SEGMENTS = 11


def stock_columns(n_rows: int, seed: int = SEED) -> dict:
    """The reference's stock columns ({name: numpy array})."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n_rows, dtype=np.int64)
    return {"s_id": ids, "s_seg": ids % SEGMENTS,
            "s_qty": rng.integers(10, 100, n_rows),
            "s_ytd": rng.uniform(0, 1000, n_rows).round(2),
            "s_cnt": np.zeros(n_rows, dtype=np.int64)}


def setup(session, storage, n_rows: int, seed: int = SEED) -> "StockMirror":
    """CREATE TABLE stock/orders in the session's database and bulk-load
    stock. -> the mirror of the loaded columns."""
    from tidb_tpu_torch.table import Table, bulkload
    for sql in DDL:
        session.execute(sql)
    cols = stock_columns(n_rows, seed)
    info = session.domain.info_schema().table(session.current_db, "stock")
    bulkload.bulk_load(storage, Table(info, storage), cols)
    return StockMirror(cols)


def write_statements(seq: int, n_rows: int) -> list[str]:
    """Write `seq`'s statements, each run in autocommit."""
    k = int((seq * 7919) % n_rows)
    if seq % 2:     # new-order: touch stock + log
        return [f"UPDATE stock SET s_qty = s_qty - 1, s_cnt = {seq} "
                f"WHERE s_id = {k}",
                f"INSERT INTO orders VALUES ({seq}, {k}, 9.99)"]
    return [f"UPDATE stock SET s_ytd = s_ytd + 1.5, s_cnt = {seq} "
            f"WHERE s_id = {k}"]          # payment: money moves


class StockMirror:
    """stock's lanes as numpy arrays, kept in step with the committed
    write statements, for the analytic statement's exact truth."""

    def __init__(self, cols: dict):
        self.cols = {k: v.copy() for k, v in cols.items()}
        self.n = len(cols["s_id"])

    def apply(self, seq: int, stmt_index: int) -> None:
        """Replay statement `stmt_index` of write `seq` (the orders
        INSERT changes no stock lane)."""
        k = int((seq * 7919) % self.n)
        c = self.cols
        if seq % 2 and stmt_index == 0:
            c["s_qty"][k] -= 1
            c["s_cnt"][k] = seq
        elif not seq % 2:
            c["s_ytd"][k] += 1.5
            c["s_cnt"][k] = seq

    def truth(self) -> list[tuple]:
        """(s_seg, COUNT, SUM(s_qty), SUM(s_ytd), MAX(s_cnt)) per
        segment; SUM(s_ytd) as math.fsum of the float64 values."""
        c = self.cols
        out = []
        for g in range(SEGMENTS):
            m = c["s_seg"] == g
            if not m.any():
                continue
            out.append((g, int(m.sum()), int(c["s_qty"][m].sum()),
                        math.fsum(c["s_ytd"][m].tolist()),
                        int(c["s_cnt"][m].max())))
        return out


def same_rows(got, truth, rel: float = 1e-9) -> bool:
    """Integer lanes exact (SUM(s_qty) is a DECIMAL), SUM(s_ytd) within
    `rel` relative."""
    if len(got) != len(truth):
        return False
    for g, t in zip(got, truth):
        if (g[0], g[1], int(g[2]), g[4]) != (t[0], t[1], t[2], t[4]) or \
                int(g[2]) != g[2] or \
                not math.isclose(g[3], t[3], rel_tol=rel):
            return False
    return True


def _counters() -> dict:
    from tidb_tpu_torch import metrics
    snap = metrics.snapshot()

    def total(prefix):
        return int(sum(v for k, v in snap.items() if k.startswith(prefix)))
    return {"served_with_delta": total(metrics.CACHE_DELTA_SERVES),
            "delta_merges": total(metrics.DELTA_MERGES),
            "hbm_hits": total(metrics.HBM_CACHE_HITS),
            "hbm_misses": total(metrics.HBM_CACHE_MISSES)}


def sweep(session, storage, n_rows: int, rates=(0, 20, 100),
          window: float = 5.0, progress=None) -> dict:
    """The reference's sweep over `session` (the analytic loop) with the
    writer on a second session and thread. -> the report, with
    `committed`: every committed write statement as (seq, index), in
    commit order, for StockMirror.apply."""
    from tidb_tpu_torch.session import Session, SQLError
    progress = progress or (lambda msg: None)
    out: dict = {"rows": n_rows, "window_secs": window, "rates": {}}
    committed: list = []
    seq_commit: dict = {}            # write seq -> commit wall time
    baseline_rps = None
    for rate in rates:
        stop = threading.Event()
        write_lat: list = []
        write_errs: list = []
        written = [0]
        seq0 = max(seq_commit, default=0)

        def writer(rate=rate, seq0=seq0):
            ws = Session(storage, db=session.current_db)
            period = 1.0 / rate
            nxt = time.perf_counter()
            seq = seq0
            try:
                while not stop.is_set():
                    seq += 1
                    t0 = time.perf_counter()
                    try:
                        for i, sql in enumerate(write_statements(seq,
                                                                 n_rows)):
                            ws.execute(sql)
                            committed.append((seq, i))
                        seq_commit[seq] = time.perf_counter()
                        written[0] += 1
                    except SQLError as exc:
                        write_errs.append(str(exc))
                    write_lat.append(time.perf_counter() - t0)
                    nxt += period
                    delay = nxt - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    else:
                        nxt = time.perf_counter()   # fell behind
            finally:
                ws.close()

        c0 = _counters()
        wt = None
        if rate > 0:
            wt = threading.Thread(target=writer, name="htap-writer")
            wt.start()
        progress(f"htap: rate {rate}/s window {window}s")
        queries = launches = fallbacks = ledger_left = 0
        lag_samples: list = []
        seen = seq0
        errs: list = []
        t_start = time.perf_counter()
        try:
            while time.perf_counter() - t_start < window:
                rows = session.query(ANALYTIC).rows
                t_read = time.perf_counter()
                queries += 1
                st = session.last_stats
                launches += st.segsum_launches
                fallbacks += st.fallbacks + sum(
                    op.fallbacks for op in session.last_collector.ops())
                ledger_left = max(ledger_left, session.last_mem_left)
                if sum(r[1] for r in rows) != n_rows:
                    errs.append(f"COUNT mismatch: {rows}")
                    break
                top = max(r[4] for r in rows)
                if top > seen:
                    seen = top
                    t_commit = seq_commit.get(top)
                    if t_commit is not None:
                        lag_samples.append(t_read - t_commit)
        finally:
            secs = time.perf_counter() - t_start
            stop.set()
            if wt is not None:
                wt.join()
        c1 = _counters()
        rps = queries * n_rows / secs
        if rate == 0 and baseline_rps is None:
            baseline_rps = rps
        out["rates"][str(rate)] = {
            "target_writes_per_sec": rate,
            "achieved_writes_per_sec": written[0] / secs,
            "write_p99_ms": percentile(write_lat, 99) * 1e3
            if write_lat else None,
            "analytic_queries": queries,
            "analytic_rows_per_sec": rps,
            "vs_read_only": rps / baseline_rps if baseline_rps else None,
            "freshness_ms_avg": 1e3 * sum(lag_samples) / len(lag_samples)
            if lag_samples else None,
            "freshness_ms_max": 1e3 * max(lag_samples)
            if lag_samples else None,
            "errors": (errs + write_errs)[:3],
            "delta": {k: c1[k] - c0[k] for k in c0},
            "segsum_launches": launches, "fallbacks": fallbacks,
            "ledger_left_max": ledger_left}
        progress(f"htap: rate {rate}: {rps:,.0f} analytic rows/s, "
                 f"{written[0]} writes")
    out["read_only_rows_per_sec"] = baseline_rps or 0.0
    nz = [v for k, v in out["rates"].items() if int(k) > 0]
    if nz and baseline_rps:
        out["min_vs_read_only"] = min(v["vs_read_only"] for v in nz)
    out["delta_rows_staged_end"] = storage.delta_store.rows_current()
    out["committed"] = committed
    return out


METRIC = "htap_analytic_rows_per_sec_under_writes"


def run(progress=None, rows: int = 60000, secs: float = 5.0,
        rates=(0, 20, 100), device="cuda") -> dict:
    """The reference's `_htap_bench` (bench.py:438-622) on a store of its
    own: setup, two warm analytic runs, the sweep and its utilization
    block (analytic against write device time by digest). The final
    rows must equal the numpy replay of the committed writes
    (`equals_replay`). -> the line's detail."""
    from tidb_tpu_torch import perfschema
    from tidb_tpu_torch.benchmarks.common import (meter_mark,
                                                  utilization_block)
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    progress = progress or (lambda msg: None)
    storage = new_mock_storage(device=device)
    session = Session(storage)
    try:
        session.execute("CREATE DATABASE htap")
        session.execute("USE htap")
        progress(f"htap: loading {rows} stock rows")
        mirror = setup(session, storage, rows)
        progress("htap: warming (cache fill)")
        session.query(ANALYTIC)
        session.query(ANALYTIC)
        digests = {perfschema.sql_digest(ANALYTIC)[0]: "analytic"}
        for seq in (1, 2):
            for sql in write_statements(seq, rows):
                digests[perfschema.sql_digest(sql)[0]] = "write"
        mark = meter_mark()
        out = sweep(session, storage, rows, [int(r) for r in rates], secs,
                    progress=progress)
        out["utilization"] = utilization_block(mark, digests)
        for seq, i in out.pop("committed"):
            mirror.apply(seq, i)
        out["equals_replay"] = same_rows(session.query(ANALYTIC).rows,
                                         mirror.truth())
    finally:
        session.close()
        storage.close()
    return out


def line(detail: dict) -> dict:
    """bench.py's htap line around the detail (bench.py:637-647)."""
    rates = detail.get("rates", {})
    top = max((int(k) for k in rates), default=0)
    return {"metric": METRIC,
            "value": rates.get(str(top), {}).get("analytic_rows_per_sec",
                                                 0.0),
            "unit": "rows/s",
            "vs_baseline": detail.get("min_vs_read_only", 0.0),
            "detail": detail}


def main() -> int:
    import sys
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=60000)
    ap.add_argument("--secs", type=float, default=5.0)
    ap.add_argument("--rates", default="0,20,100")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    storage = new_mock_storage(device=args.device)
    session = Session(storage)
    try:
        session.execute("CREATE DATABASE htap")
        session.execute("USE htap")
        mirror = setup(session, storage, args.rows)
        session.query(ANALYTIC)
        session.query(ANALYTIC)
        res = sweep(session, storage, args.rows,
                    [int(x) for x in args.rates.split(",")], args.secs,
                    progress=lambda m: print(m, file=sys.stderr))
        for seq, i in res.pop("committed"):
            mirror.apply(seq, i)
        res["equals_replay"] = same_rows(session.query(ANALYTIC).rows,
                                         mirror.truth())
        print(json.dumps(res))
        return 0 if res["equals_replay"] else 1
    finally:
        session.close()
        storage.close()


if __name__ == "__main__":
    raise SystemExit(main())
