"""Encoded against decoded execution, warm: the port's counterpart of
the JAX package's `python bench.py encoded` (`_encoded_bench`,
`encoded_main`).

TPC-H Q1 (dictionary group keys, the direct-indexed aggregate) and Q3
(the string-filtered join chain: encoded join-key lanes and fragment
fusion) run warm with `tidb_tpu_encoded_exec` and
`tidb_tpu_fuse_fragments` both on, then both off. The results must be
equal; `encoding_fallbacks` (device fallbacks with reason="encoding")
and the bytes the encoded dispatches touched are counted around the
encoded runs.
"""

from __future__ import annotations

from tidb_tpu_torch.benchmarks.common import (bytes_counters, bytes_touched,
                                              fallbacks_by_reason, geomean,
                                              rows_equal, time_query)

__all__ = ["METRIC", "run", "line"]

METRIC = "encoded_vs_decoded_warm_speedup"


def _encoding_fallbacks() -> int:
    return fallbacks_by_reason().get("encoding", 0)


def run(progress=None, sf: float = 0.05, iters: int = 3, seed: int = 42,
        device="cuda") -> dict:
    """Load TPC-H at `sf` into a store of its own and compare. -> the
    line's detail. Raises RuntimeError where the two modes disagree."""
    from tidb_tpu_torch import config
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    progress = progress or (lambda msg: None)
    data = tpch.ScaledTpch(sf, seed)
    storage = new_mock_storage(device=device)
    session = Session(storage)
    out: dict = {"sf": sf, "iters": iters, "queries": {}}
    try:
        session.execute("CREATE DATABASE tpch_enc")
        session.execute("USE tpch_enc")
        progress(f"encoded: loading sf={sf}")
        out["rows_loaded"] = tpch.load(session, storage, data,
                                       regions_per_table=2)
        for qname in ("q1", "q3"):
            sql = tpch.QUERIES[qname]
            in_rows = sum(data.counts[t] for t in tpch.QUERY_TABLES[qname])
            config.set_var("tidb_tpu_encoded_exec", 1)
            config.set_var("tidb_tpu_fuse_fragments", 1)
            progress(f"encoded: {qname} warm (encoded)")
            session.query(sql)          # chunk-cache fill
            session.query(sql)          # the HBM tier fills on the 2nd
            f0, b0 = _encoding_fallbacks(), bytes_counters()
            e_secs, e_rows = time_query(session, sql, iters)
            b1, f1 = bytes_counters(), _encoding_fallbacks()
            try:
                config.set_var("tidb_tpu_encoded_exec", 0)
                config.set_var("tidb_tpu_fuse_fragments", 0)
                progress(f"encoded: {qname} warm (decoded)")
                session.query(sql)
                session.query(sql)
                d_secs, d_rows = time_query(session, sql, iters)
            finally:
                config.set_var("tidb_tpu_encoded_exec", 1)
                config.set_var("tidb_tpu_fuse_fragments", 1)
            if not rows_equal(e_rows, d_rows):
                raise RuntimeError(f"{qname}: encoded and decoded disagree")
            out["queries"][qname] = {
                "input_rows": in_rows,
                "encoded_secs": e_secs, "decoded_secs": d_secs,
                "encoded_rows_per_sec": in_rows / e_secs,
                "decoded_rows_per_sec": in_rows / d_secs,
                "speedup": d_secs / e_secs,
                "bytes_touched": bytes_touched(b0, b1),
                "encoding_fallbacks": f1 - f0}
            progress(f"encoded: {qname} encoded {e_secs:.3f}s decoded "
                     f"{d_secs:.3f}s fallbacks {f1 - f0}")
    finally:
        session.close()
        storage.close()
    return out


def line(detail: dict) -> dict:
    """bench.py's line around the detail (bench.py:744-755)."""
    speedups = [q["speedup"] for q in detail.get("queries", {}).values()
                if q.get("speedup")]
    geo = geomean(speedups)
    return {"metric": METRIC, "value": geo, "unit": "x",
            "vs_baseline": geo, "detail": detail}


if __name__ == "__main__":
    import sys
    from tidb_tpu_torch.bench import leg_main
    raise SystemExit(leg_main("encoded", sys.argv[1:]))
