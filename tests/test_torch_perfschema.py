"""PERFORMANCE_SCHEMA statement events, the digest summary and the slow
log: the port against the reference.

The same statements through both packages' sessions give equal digests
and digest texts (literals stripped by the lexer), equal exec counts,
rows and error counts in events_statements_summary_by_digest, equal
rows in events_statements_history (state, rows_sent, error), the
memtables' column names and types, and a digest's recorded peak
(`digest_max_mem`, the admission projection) above 0 for a statement
that held memory. A statement at or past `tidb_tpu_slow_query_ms` lands
in the slow-query log with its digest. The reference's own
`tests/test_perfschema_trace.py` statement-event cases are replayed
against the port (its trace cases need the trace ring, not ported; the
digest's `last_trace_id` stays 0).
"""

import logging

import pytest

from tests.test_torch_server import replay
from tidb_tpu import perfschema as jperf
from tidb_tpu.session import Session as JSession
from tidb_tpu.store import new_mock_storage as j_storage
from tidb_tpu_torch import perfschema as pperf
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as p_storage

STMTS = ["CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, s VARCHAR(8))",
         "INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b'), (3, 30, 'c')",
         "SELECT * FROM t WHERE id = 1", "SELECT * FROM t WHERE id = 2",
         "SELECT * FROM t WHERE id = 3",
         "SELECT s, SUM(v) FROM t GROUP BY s",
         "SELECT s, SUM(v) FROM t GROUP BY s",
         "UPDATE t SET v = v + 1 WHERE id = 2",
         "SELECT * FROM nosuch", "SELECT 1; SELECT 2"]


@pytest.fixture
def sessions():
    jperf.reset()
    pperf.reset()
    jst, pst = j_storage(), p_storage(device="cpu")
    js, ps = JSession(jst), PSession(pst)
    for s in (js, ps):
        s.execute("CREATE DATABASE d")
        s.execute("USE d")
    for sql in STMTS:
        for s in (js, ps):
            try:
                s.execute(sql)
            except Exception:  # noqa: BLE001 - the error is recorded
                pass
    yield js, ps
    for s, st in ((js, jst), (ps, pst)):
        s.close()
        st.close()


def test_digest_summary_equals_the_reference(sessions):
    js, ps = sessions
    q = ("SELECT digest, digest_text, exec_count, sum_rows, sum_errors, "
         "last_trace_id FROM performance_schema."
         "events_statements_summary_by_digest ORDER BY digest_text")
    jr, pr = js.query(q), ps.query(q)
    assert pr.rows == jr.rows
    assert pr.columns == jr.columns
    assert [f.tp for f in pr.field_types] == [f.tp for f in jr.field_types]
    by_text = {r[1]: r for r in pr.rows}
    assert by_text["SELECT * FROM t WHERE id = ?"][2] == 3
    assert by_text["SELECT * FROM nosuch"][4] == 1


def test_statement_history_equals_the_reference(sessions):
    js, ps = sessions
    q = ("SELECT sql_text, state, rows_sent, error IS NULL FROM "
         "performance_schema.events_statements_history ORDER BY event_id")
    assert ps.query(q).rows == js.query(q).rows
    c = ("SELECT thread_id = CONNECTION_ID(), state FROM "
         "performance_schema.events_statements_current")
    assert ps.query(c).rows == js.query(c).rows


def test_digest_helpers_equal_the_reference(sessions):
    for sql in STMTS + ["SELECT 'x''y', 1.5e3, -2 FROM t /* c */ WHERE a IN "
                        "(1, 2, 3)"]:
        assert pperf.sql_digest(sql) == jperf.sql_digest(sql)
    agg = "SELECT s, SUM(v) FROM t GROUP BY s"
    assert pperf.digest_max_mem(agg) > 0
    assert jperf.digest_max_mem(agg) > 0


def test_slow_query_log(caplog):
    st = p_storage(device="cpu")
    s = PSession(st)
    s.execute("SET @@tidb_tpu_slow_query_ms = 0")
    with caplog.at_level(logging.WARNING, logger="tidb_tpu_torch.slow_query"):
        s.execute("SELECT 1 + 1")
    recs = [r.getMessage() for r in caplog.records
            if r.name == "tidb_tpu_torch.slow_query"]
    assert recs and "digest=" in recs[-1] and "SELECT 1 + 1" in recs[-1]
    caplog.clear()
    s.execute("SET @@tidb_tpu_slow_query_ms = 100000")
    with caplog.at_level(logging.WARNING, logger="tidb_tpu_torch.slow_query"):
        s.execute("SELECT 1 + 2")
    assert not [r for r in caplog.records
                if r.name == "tidb_tpu_torch.slow_query"
                and "SELECT 1 + 2" in r.getMessage()]
    s.close()
    st.close()


def test_credentials_never_reach_the_events():
    from tidb_tpu_torch.bootstrap import bootstrap
    pperf.reset()
    st = p_storage(device="cpu")
    bootstrap(st)
    s = PSession(st)
    s.execute("CREATE USER 'x'@'%' IDENTIFIED BY 'secret'")
    rows = s.query("SELECT sql_text FROM performance_schema."
                   "events_statements_history").rows
    assert rows and not any("secret" in r[0] for r in rows)
    s.close()
    st.close()


replay("test_perfschema_trace.py", globals(), drop={
    "TestTrace": "statement tracing (the trace ring, TRACE) is not ported"})
