"""The traced mix: the port's counterpart of the JAX package's `python
bench.py trace` (`_trace_bench`, `trace_main`).

Warm TPC-H Q1 and point lookups run with every statement traced
(`tidb_tpu_trace_sample = 1`) under an 8 GiB server quota, so the
admission span covers a real controller pass. The leg fails (raises
RuntimeError) unless every retained span tree is balanced, the latency
attribution holds Q1 with a device or host execution phase, the tree of
`TRACE FORMAT='json'` over warm Q1 carries the lifecycle, scheduler-slot,
dispatch, finalize and coprocessor-worker spans, and its Chrome
trace-event export passes the schema check.
"""

from __future__ import annotations

import json

from tidb_tpu_torch.benchmarks.common import (point_sql, trace_attribution,
                                              trace_mark, validate_chrome)

__all__ = ["METRIC", "NEED_SPANS", "run", "line"]

METRIC = "trace_bench_traces_retained"
NEED_SPANS = {"statement", "parse", "plan", "admission", "execute",
              "sched.slot", "dispatch", "finalize"}


def run(progress=None, sf: float = 0.02, iters: int = 3, lookups: int = 16,
        seed: int = 42, device="cuda") -> dict:
    """-> the line's detail, with `passed` True. Raises RuntimeError on
    a failed check. Restores the two variables it sets."""
    from tidb_tpu_torch import config, perfschema, trace
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    progress = progress or (lambda msg: None)
    data = tpch.ScaledTpch(sf, seed)
    storage = new_mock_storage(device=device)
    session = Session(storage)
    saved = {k: config.get_var(k) for k in
             ("tidb_tpu_trace_sample", "tidb_tpu_server_mem_quota")}
    out: dict = {"sf": sf, "iters": iters, "lookups": lookups}
    try:
        session.execute("CREATE DATABASE tpch_trace")
        session.execute("USE tpch_trace")
        progress(f"trace: loading sf={sf}")
        tpch.load(session, storage, data, regions_per_table=2)
        q1 = tpch.QUERIES["q1"]
        n_orders = data.counts["orders"]
        progress("trace: warmup (cache fill)")
        session.query(q1)
        config.set_var("tidb_tpu_trace_sample", 1)
        config.set_var("tidb_tpu_server_mem_quota", 8 << 30)
        mark = trace_mark()
        progress(f"trace: {iters} warm Q1 + {lookups} point lookups")
        for i in range(iters):
            session.query(q1)
            for j in range(lookups // iters + 1):
                session.query(point_sql((i * 7919 + j * 131) % n_orders))
        records = trace.ring_records(mark)
        unbalanced = [(r["trace_id"], p) for r in records
                      for p in trace.validate(r["root"])]
        if unbalanced:
            raise RuntimeError(f"unbalanced span trees: {unbalanced[:5]}")
        out["traces"] = len(records)

        digests = {perfschema.sql_digest(q1)[0]: "q1",
                   perfschema.sql_digest(point_sql(0))[0]: "point"}
        attribution = trace_attribution(mark, digests)
        out["latency_attribution"] = attribution
        q1a = attribution.get("q1")
        if not q1a or q1a["traces"] < iters:
            raise RuntimeError(
                f"latency_attribution unpopulated: {attribution}")
        if q1a["statement"]["p99_ms"] <= 0 or \
                q1a["device_dispatch"]["p99_ms"] + \
                q1a["finalize"]["p99_ms"] + \
                q1a["host_fallback"]["p99_ms"] <= 0:
            raise RuntimeError(
                f"no device/host execution phase attributed: {q1a}")

        doc = json.loads(session.query(
            f"TRACE FORMAT='json' {q1}").rows[0][0])
        names: set = set()

        def walk(d):
            names.add(d["name"])
            for c in d.get("children", ()):
                walk(c)

        walk(doc["spans"])
        missing = NEED_SPANS - names
        if missing:
            raise RuntimeError(f"TRACE tree missing spans {sorted(missing)}"
                               f" (got {sorted(names)})")
        if not {"copr.task", "copr.stream"} & names:
            raise RuntimeError(
                f"TRACE tree has no copr worker spans: {sorted(names)}")
        out["trace_stmt_spans"] = sorted(names)
        rec = trace.ring_get(doc["trace_id"])
        if rec is None:
            raise RuntimeError("TRACE'd statement not in the ring")
        chrome = trace.to_chrome(rec)
        validate_chrome(chrome)
        out["chrome_events"] = len(chrome["traceEvents"])
        out["passed"] = True
    finally:
        for k, v in saved.items():
            config.set_var(k, v)
        session.close()
        storage.close()
    progress(f"trace: {out.get('traces', 0)} traces, "
             f"passed={out.get('passed', False)}")
    return out


def line(detail: dict) -> dict:
    """bench.py's line around the detail (bench.py:1642-1648)."""
    return {"metric": METRIC, "value": detail.get("traces", 0),
            "unit": "traces", "detail": detail}


if __name__ == "__main__":
    import sys
    from tidb_tpu_torch.bench import leg_main
    raise SystemExit(leg_main("trace", sys.argv[1:]))
