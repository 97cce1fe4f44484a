"""Prepared statements and the plan cache: the port against the
reference.

The binary protocol (COM_STMT_PREPARE / EXECUTE / CLOSE) through both
packages' servers gives equal prepare-time column metadata and equal
binary rows, DECIMAL and DATE included, and equal rows to the text
protocol's run with literals; SQL PREPARE / EXECUTE / DEALLOCATE gives
equal results through both sessions. The plan cache hits from the second
run of the same single-statement SELECT text on, in both packages; a
prepared statement binds its markers as constants and re-plans per
execution in both (the cache's hit count does not move); and one Q1 plan
cached by one session serves another session's Q1 with equal rows. The
reference's own `tests/test_prepared.py` is replayed against the port.
"""

import pytest

from tests.test_torch_server import Pair, fast_schema_lease, replay  # noqa: F401
from tidb_tpu.session import Session as JSession
from tidb_tpu.store import new_mock_storage as j_storage
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as p_storage


@pytest.fixture
def pair():
    p = Pair()
    jc, pc = p.clients()
    for c in (jc, pc):
        c.query("CREATE DATABASE test")
        c.use("test")
        c.query("CREATE TABLE t (a BIGINT PRIMARY KEY, b DOUBLE, "
                "s VARCHAR(20), d DATE, m DECIMAL(12,2), "
                "dt DATETIME)")
        c.query("INSERT INTO t VALUES "
                "(1, 1.5, 'x', '2024-03-01', 10.25, '2024-03-01 10:11:12'),"
                " (2, 2.5, 'y', '2024-04-01', -3.50, NULL), "
                "(3, NULL, NULL, NULL, NULL, NULL), "
                "(4, 4.5, 'x', '1998-12-01', 7.00, '1998-12-01 00:00:00')")
    yield p, jc, pc
    jc.close()
    pc.close()
    p.close()


BINARY_CASES = [
    ("SELECT a, b, s, d, m, dt FROM t WHERE a = ?", [[1], [3], [4]]),
    ("SELECT a FROM t WHERE b > ? AND s = ?", [[2.0, "y"], [0.0, "x"]]),
    ("SELECT s, SUM(m), COUNT(*), MAX(d) FROM t WHERE d <= ? GROUP BY s "
     "ORDER BY s", [["2024-12-31"], ["1999-01-01"]]),
    ("SELECT SUM(m * 2), AVG(b) FROM t WHERE a BETWEEN ? AND ?",
     [[1, 4], [2, 2]]),
    ("SELECT d + INTERVAL ? DAY FROM t WHERE a = ?", [[3, 1], [30, 4]]),
]


@pytest.mark.parametrize("sql,runs", BINARY_CASES,
                         ids=[c[0][:40] for c in BINARY_CASES])
def test_binary_rows_equal_the_reference(pair, sql, runs):
    _p, jc, pc = pair
    jsid, jn = jc.stmt_prepare(sql)
    psid, pn = pc.stmt_prepare(sql)
    assert (pn, pc.last_prepare_columns) == (jn, jc.last_prepare_columns)
    for params in runs:
        got = pc.stmt_execute(psid, params)
        assert got == jc.stmt_execute(jsid, params), params
    pc.stmt_close(psid)
    jc.stmt_close(jsid)
    # the connection still answers after the close
    assert pc.query("SELECT COUNT(*) FROM t") == \
        jc.query("SELECT COUNT(*) FROM t")


def test_binary_rows_equal_text_rows_with_literals(pair):
    _p, _jc, pc = pair
    sid, _n = pc.stmt_prepare("SELECT a, s, d, m FROM t WHERE a >= ? "
                              "ORDER BY a")
    cols, rows = pc.stmt_execute(sid, [2])
    tcols, trows = pc.query("SELECT a, s, d, m FROM t WHERE a >= 2 "
                            "ORDER BY a")
    assert cols == tcols
    assert [tuple(None if v is None else str(v) for v in r)
            for r in rows] == trows


def test_prepared_dml_and_unknown_statement(pair):
    _p, jc, pc = pair
    for c in (jc, pc):
        sid, _n = c.stmt_prepare("INSERT INTO t (a, s, m) VALUES (?, ?, ?)")
        assert c.stmt_execute(sid, [9, "w", "1.25"]) == 1
    assert pc.query("SELECT a, s, m FROM t WHERE a = 9") == \
        jc.query("SELECT a, s, m FROM t WHERE a = 9")
    errs = []
    for c in (jc, pc):
        with pytest.raises(Exception) as ei:
            c.stmt_execute(999, [])
        errs.append((ei.value.code, str(ei.value)))
    assert errs[0] == errs[1]


def test_sql_prepare_execute_deallocate_equal_the_reference(pair):
    _p, jc, pc = pair
    from tests.test_torch_server import same
    for sql in ["PREPARE ps FROM 'SELECT s, m FROM t WHERE a = ?'",
                "SET @k = 2", "EXECUTE ps USING @k",
                "SET @k = 1", "EXECUTE ps USING @k",
                "SET @q = 'SELECT COUNT(*) FROM t WHERE a > ?'",
                "PREPARE p2 FROM @q", "EXECUTE p2 USING @k",
                "EXECUTE p2", "DEALLOCATE PREPARE ps",
                "EXECUTE ps USING @k"]:
        same(jc, pc, sql)


@pytest.fixture
def sessions():
    jst, pst = j_storage(), p_storage(device="cpu")
    js, ps = JSession(jst), PSession(pst)
    for s in (js, ps):
        s.execute("CREATE DATABASE test; USE test")
        s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
        s.execute("INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)")
    yield js, ps
    for s, st in ((js, jst), (ps, pst)):
        s.close()
        st.close()


def test_plan_cache_hits_equal_the_reference(sessions):
    hits = []
    for s in sessions:
        cache = s.domain.plan_cache()
        cache.clear()
        h0 = cache.hits
        sql = "SELECT b FROM t WHERE a = 2"
        assert s.query(sql).rows == [(20,)]
        assert s.query(sql).rows == [(20,)]
        assert s.query(sql).rows == [(20,)]
        # a batch of two statements is not cached, nor a folded one
        s.execute("SELECT 1; SELECT 2")
        s.query("SELECT @@autocommit, b FROM t WHERE a = 1")
        s.query("SELECT @@autocommit, b FROM t WHERE a = 1")
        # a prepared statement re-plans per execution
        sid, _n = s.prepare("SELECT b FROM t WHERE a = ?")
        for k in (1, 2, 3):
            assert s.execute_prepared(sid, [k]).rows == [(10 * k,)]
        hits.append((cache.hits - h0, len(cache)))
    assert hits[1] == hits[0] == (2, 1)


def test_plan_cache_invalidated_by_ddl_and_analyze(sessions):
    for s in sessions:
        sql = "SELECT b FROM t WHERE a = 2"
        s.query(sql)
        s.execute("ALTER TABLE t ADD COLUMN c INT DEFAULT 5")
        assert s.query(sql).rows == [(20,)]
        assert s.query("SELECT c FROM t WHERE a = 2").rows == [(5,)]
        h0 = s.domain.plan_cache().hits
        s.execute("ANALYZE TABLE t")
        s.query(sql)
        assert s.domain.plan_cache().hits == h0   # stats version moved


def test_one_cached_q1_plan_serves_two_sessions():
    """A Q1 plan cached by one session serves a second session over the
    same storage: equal rows, and the plan holds no device tensor and no
    storage state that the second run would see stale (a write between
    the runs shows in the second)."""
    from tidb_tpu_torch.benchmarks import tpch
    st = p_storage(device="cpu")
    st.async_commit_secondaries = False
    a, b = PSession(st), PSession(st)
    a.execute("CREATE DATABASE tpch; USE tpch")
    d = tpch.ScaledTpch(0.002, 5)
    tpch.load(a, st, d)
    b.execute("USE tpch")
    over = {"tidb_tpu_device_min_rows": 1, "tidb_tpu_superchunk_rows": 4096}
    with pcfg_overlay(over):
        cache = a.domain.plan_cache()
        cache.clear()
        first = a.query(tpch.Q1).rows
        h0 = cache.hits
        second = b.query(tpch.Q1).rows
        assert cache.hits == h0 + 1 and second == first
        assert first == tpch.as_session_rows("q1", tpch.q1_truth(d))
        a.execute("DELETE FROM lineitem WHERE l_returnflag = 'R'")
        after = b.query(tpch.Q1).rows
        assert cache.hits == h0 + 2
        assert after == [r for r in first if r[0] != "R"]
    for s in (a, b):
        s.close()
    st.close()


def pcfg_overlay(over):
    """Set port sysvars for the duration of a block (sessions read the
    registry; an overlay is per thread)."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        old = {k: pconfig.get_var(k) for k in over}
        for k, v in over.items():
            pconfig.set_var(k, v)
        try:
            yield
        finally:
            for k, v in old.items():
                pconfig.set_var(k, v)
    return cm()


replay("test_prepared.py", globals())
