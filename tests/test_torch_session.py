"""SQL through the port's Session against the JAX package's Session.

Both packages run `CREATE DATABASE tpch`, `USE tpch` and
`benchmarks/tpch.load` over the same `ScaledTpch(sf=0.002, seed=42)`
(each loaded once per module; the port's storage on `device="cpu"`),
then the same SQL text:

  * TPC-H Q1, Q3 and Q5 give the reference's rows: integer, DECIMAL,
    date and string columns exactly, REAL columns within rel=1e-12 (the
    three queries have none; the comparison carries the rule), and the
    exact numpy truths (tpch.q1_truth, q3_truth, q5_truth) formatted as
    a session formats them;
  * with `SET @@tidb_tpu_device = 0` the port gives the same rows with
    no device work (no kernel launch, no superchunk, no join dispatch);
  * EXPLAIN of each gives the reference's operator tree line for line
    (operator names, order, join keys, pushed and host conditions,
    partial aggregates), before and after ANALYZE TABLE (the estimates
    come from each package's statistics);
  * Q1 reaches the CopPlan of the hand-built store path
    (tpch.q1_cop_plan): the same columns, filter, group-by and
    aggregates, so the HBM block cache keys agree;
  * every statement's memory ledger reads 0 after it;
  * the cluster_* memtables (the fleet's, not ported) raise SQLError
    naming them; a planned Apply and Union build their executors, and
    under `tidb_tpu_superchunk_rows = 0` Q3 and Q5 aggregate per chunk
    on the device with the reference's rows (the transaction,
    UPDATE/DELETE and index statements and executors are held against
    the reference in test_torch_txn.py and test_torch_index.py; the
    subqueries, UNION, the cross join, ADMIN, LOAD DATA, TRACE and
    EXPLAIN ANALYZE in their own test_torch_*.py files).

Both packages run with tidb_tpu_device_min_rows = 1 and
tidb_tpu_superchunk_rows = 4096, so that at this size the coprocessor,
the joins and the aggregates take their device paths.
"""

import contextlib
import math
from decimal import Decimal

import pytest
import torch

from tidb_tpu import config as jconfig
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.executor import build_executor
from tidb_tpu_torch.plan import physical as pph
from tidb_tpu_torch.session import SQLError
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

SF, SEED = 0.002, 42
QUERIES = ("q1", "q3", "q5")
TRUTHS = {"q1": ptpch.q1_truth, "q3": ptpch.q3_truth, "q5": ptpch.q5_truth}
SYSVARS = {"tidb_tpu_device_min_rows": 1, "tidb_tpu_superchunk_rows": 4096}


@contextlib.contextmanager
def sysvars(values):
    """Set the same sysvars in both packages' registries."""
    old = {k: (jconfig.get_var(k), pconfig.get_var(k)) for k in values}
    for k, v in values.items():
        jconfig.set_var(k, v)
        pconfig.set_var(k, v)
    try:
        yield
    finally:
        for k, (jv, pv) in old.items():
            jconfig.set_var(k, jv)
            pconfig.set_var(k, pv)


@pytest.fixture(scope="module")
def sessions():
    """(reference session, port session, data), both loaded."""
    d = ptpch.ScaledTpch(SF, SEED)
    js, ps = jnew_storage(), pnew_storage(device="cpu")
    jsess, psess = JSession(js), PSession(ps)
    for s in (jsess, psess):
        s.execute("CREATE DATABASE tpch")
        s.execute("USE tpch")
    jtpch.load(jsess, js, jtpch.ScaledTpch(SF, SEED))
    ptpch.load(psess, ps, d)
    with sysvars(SYSVARS):
        yield jsess, psess, d
    psess.close()
    jsess.close()
    ps.close()
    js.close()


def _same_value(got, want) -> bool:
    if isinstance(want, float) or isinstance(got, float):
        return math.isclose(got, want, rel_tol=1e-12)
    return type(got) is type(want) and got == want


def assert_same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert all(_same_value(a, b) for a, b in zip(g, w)), (g, w)


def _sql(name: str) -> str:
    return getattr(ptpch, name.upper())


@pytest.mark.parametrize("name", QUERIES)
def test_query_equals_the_reference(sessions, name):
    jsess, psess, _d = sessions
    got = psess.query(_sql(name))
    want = jsess.query(_sql(name))
    assert got.columns == want.columns
    assert [ft.tp for ft in got.field_types] == \
        [ft.tp for ft in want.field_types]
    assert_same_rows(got.rows, want.rows)
    assert psess.last_mem.total() == 0
    assert psess.last_stats.mem_left == 0


@pytest.mark.parametrize("name", QUERIES)
def test_query_equals_the_truth(sessions, name):
    _jsess, psess, d = sessions
    rows = psess.query(_sql(name)).rows
    assert_same_rows(rows, ptpch.as_session_rows(name, TRUTHS[name](d)))
    assert rows and all(isinstance(r[1 if name != "q1" else 2], Decimal)
                        for r in rows)


@pytest.mark.parametrize("name", QUERIES)
def test_host_path_gives_the_same_rows(sessions, name):
    jsess, psess, _d = sessions
    psess.execute("SET @@tidb_tpu_device = 0")
    try:
        got = psess.query(_sql(name)).rows
        st = psess.last_stats
    finally:
        psess.execute("SET @@tidb_tpu_device = 1")
    assert_same_rows(got, jsess.query(_sql(name)).rows)
    assert (st.segsum_launches, st.superchunks, st.join_dispatches,
            st.fused_dispatches, st.hybrid_joins) == (0, 0, 0, 0, 0)
    assert set(st.join_paths.values()) <= {"per-chunk"}


def test_device_path_ran_on_the_device(sessions):
    _jsess, psess, _d = sessions
    psess.query(ptpch.Q3)
    st = psess.last_stats
    assert st.superchunks > 0 and st.fallbacks == 0
    assert "per-chunk" not in st.join_paths.values()


def _explain(sess, name: str) -> list[str]:
    return [r[0] for r in sess.query("EXPLAIN " + _sql(name)).rows]


@pytest.mark.parametrize("name", QUERIES)
def test_explain_tree_equals_the_reference(sessions, name):
    jsess, psess, _d = sessions
    got = _explain(psess, name)
    assert got == _explain(jsess, name)
    assert psess.last_mem.total() == 0


@pytest.mark.parametrize("name", QUERIES)
def test_explain_after_analyze_equals_the_reference(sessions, name):
    jsess, psess, _d = sessions
    tables = ", ".join(ptpch.QUERY_TABLES[name])
    for s in (jsess, psess):
        s.execute(f"ANALYZE TABLE {tables}")
    got = _explain(psess, name)
    assert got == _explain(jsess, name)
    assert any("est_rows:" in line for line in got)


def test_q1_reaches_the_hand_built_cop_plan(sessions):
    _jsess, psess, _d = sessions
    plan = psess.plan(ptpch.Q1)
    while not isinstance(plan, pph.PhysTableReader):
        plan = plan.children[0]
    got = plan.cop
    info = psess.domain.info_schema().table("tpch", "lineitem")
    want = ptpch.q1_cop_plan(info)
    assert [c.id for c in got.cols] == [c.id for c in want.cols]
    assert repr(got.filter) == repr(want.filter)
    assert got.host_filter is None and want.host_filter is None
    assert repr(got.group_exprs) == repr(want.group_exprs)
    assert repr(got.aggs) == repr(want.aggs)


def test_sysvars_set_and_read_back(sessions):
    _jsess, psess, _d = sessions
    psess.execute("SET @@tidb_tpu_superchunk_rows = 8192, @x = 2 + 3")
    try:
        row = psess.query("SELECT @@tidb_tpu_superchunk_rows, @x").rows
    finally:
        psess.execute("SET @@tidb_tpu_superchunk_rows = 4096")
    assert row == [(8192, 5)]
    with pytest.raises(SQLError):
        psess.execute("SET @@tidb_tpu_superchunk_rows = 'many'")


def test_insert_and_select_equal_the_reference(sessions):
    jsess, psess, _d = sessions
    stmts = ["CREATE TABLE w (a BIGINT PRIMARY KEY, b VARCHAR(8), "
             "c DECIMAL(10,2), d DATE)",
             "INSERT INTO w VALUES (1, 'x', 1.5, '1995-03-15'), "
             "(2, NULL, NULL, NULL)",
             "INSERT IGNORE INTO w VALUES (1, 'dup', 0, NULL)",
             "INSERT INTO w (a, b, c) SELECT a + 10, b, c * 2 FROM w",
             "REPLACE INTO w VALUES (2, 'y', 9.99, '1994-01-01')"]
    for sql in stmts:
        assert psess.execute(sql) == jsess.execute(sql)
    q = "SELECT a, b, c, d FROM w WHERE a > 0 ORDER BY a DESC LIMIT 3"
    assert_same_rows(psess.query(q).rows, jsess.query(q).rows)
    for s in (jsess, psess):
        s.execute("DROP TABLE w")


# the memtables over the fleet's membership plane, the last part of the
# SQL surface the port once left unported (it raised "not ported yet"):
# in process, with no fleet, each answers for this process alone, with
# the reference's columns
UNPORTED = ["SELECT * FROM information_schema.cluster_members",
            "SELECT * FROM information_schema.cluster_processlist",
            "SELECT * FROM information_schema.cluster_statement_traces"]


@pytest.mark.parametrize("sql", UNPORTED)
def test_unported_statement_raises_by_name(sessions, sql):
    jsess, psess, _d = sessions
    got, want = psess.query(sql), jsess.query(sql)
    assert got.columns == want.columns
    if "cluster_members" in sql:
        assert len(got.rows) == len(want.rows) == 1
        assert got.rows[0][3] == want.rows[0][3] == "local"
    assert psess.query("SELECT COUNT(*) FROM region").rows == [(5,)]


_PLANNED = {"PhysApply": "SELECT n_name FROM nation WHERE n_regionkey "
                         "NOT IN (SELECT r_regionkey FROM region "
                         "WHERE r_name = 'ASIA')",
            "PhysUnion": "SELECT r_name FROM region UNION ALL "
                         "SELECT n_name FROM nation"}


def _find(plan, cls):
    if isinstance(plan, cls):
        return plan
    for c in plan.children:
        got = _find(c, cls)
        if got is not None:
            return got
    return None


@pytest.mark.parametrize("node", ["PhysApply", "PhysUnion"])
def test_unported_executor_raises_at_build(sessions, node):
    """A planned Apply or Union builds its executor (both raised "not
    ported yet" at build before the port had them), and the statement
    gives the reference's rows."""
    jsess, psess, _d = sessions
    sql = _PLANNED[node]
    plan = psess.plan(sql)
    sub = _find(plan, getattr(pph, node))
    assert sub is not None
    op = build_executor(sub)
    assert op.schema == list(sub.schema.cols)
    assert_same_rows(psess.query(sql).rows, jsess.query(sql).rows)
    assert psess.last_mem_left == 0


@pytest.mark.parametrize("name", ["q3", "q5"])
def test_per_chunk_device_agg_raises_by_name(sessions, name):
    """tidb_tpu_superchunk_rows = 0 (per-chunk device aggregation, which
    raised "not ported yet" before the port had it): Q3 and Q5 give the
    reference's rows, every joined chunk is one device partial aggregate
    (at this scale the top join can yield a single chunk; the smoke
    holds "more launches than the fused run" at SF 1), and the ledger
    reads 0."""
    jsess, psess, _d = sessions
    fused = psess.query(_sql(name)).rows
    fused_batches = psess.last_stats.device_batches
    want = jsess.query(_sql(name)).rows
    for s in (jsess, psess):
        s.execute("SET @@tidb_tpu_superchunk_rows = 0")
    try:
        got = psess.query(_sql(name)).rows
        st = psess.last_stats
        ref = jsess.query(_sql(name)).rows
    finally:
        for s in (jsess, psess):
            s.execute("SET @@tidb_tpu_superchunk_rows = 4096")
    assert_same_rows(got, want)
    assert_same_rows(got, ref)
    assert_same_rows(fused, want)
    assert st.device_batches == st.superchunks >= fused_batches
    assert st.device_batches > 0 and st.fallbacks == 0
    assert set(st.join_paths.values()) == {"per-chunk"}
    assert psess.last_mem_left == 0


def test_parse_error_is_the_parsers(sessions):
    from tidb_tpu_torch.parser import ParseError
    _jsess, psess, _d = sessions
    with pytest.raises(ParseError):
        psess.execute("SELEC 1")


def _hash_joins(plan):
    if type(plan).__name__ == "PhysHashJoin":
        yield plan
    for c in plan.children:
        yield from _hash_joins(c)


def test_planner_probe_cms_reaches_the_join(sessions):
    jsess, psess, _d = sessions
    for s in (jsess, psess):
        s.execute("ANALYZE TABLE customer, orders, lineitem")
    got = [getattr(j, "probe_cms", None) is not None
           for j in _hash_joins(psess.plan(ptpch.Q3))]
    want = [getattr(j, "probe_cms", None) is not None
            for j in _hash_joins(jsess.plan(ptpch.Q3))]
    assert got == want and any(got)
    join = next(j for j in _hash_joins(psess.plan(ptpch.Q3))
                if getattr(j, "probe_cms", None) is not None)
    op = build_executor(join)
    assert op.probe_cms is join.probe_cms
    assert (op.join_type, op.other_cond) == (join.join_type, join.other_cond)


@pytest.mark.parametrize("seeded", [False, True])
def test_probe_sketch_seeds_the_hot_lane(seeded):
    """A build key the probe side's CMSketch counts past the skew
    threshold joins the heavy-hitter lane before any probe row."""
    import numpy as np
    from tidb_tpu_torch.chunk import Chunk, Column
    from tidb_tpu_torch.executor.join import HashJoin
    from tidb_tpu_torch.executor.scan import TableScan
    from tidb_tpu_torch.expression import ColumnRef
    from tidb_tpu_torch.ops import hybrid
    from tidb_tpu_torch.sqltypes import new_int_field
    from tidb_tpu_torch.statistics import CMSketch, cm_key
    ft = new_int_field()
    nb, hot_key = 5000, 7
    cms = CMSketch()
    cms.insert(cm_key(hot_key), pconfig.skew_threshold() * 2)
    join = HashJoin(TableScan("p", [("k", ft)]), TableScan("b", [("k", ft)]),
                    [ColumnRef(0, ft, "k")], [ColumnRef(0, ft, "k")],
                    probe_cms=cms if seeded else None)
    build = Chunk([Column(ft, np.arange(nb, dtype=np.int64))])
    _enc, bk, raw = join._fit_build(build)
    # the build fits one superchunk: only the hot set can engage the
    # hybrid path
    with pconfig.session_overlay({"tidb_tpu_superchunk_rows": 1 << 18}):
        engage, hot, h = join._hybrid_engage(bk, nb, raw)
    assert engage == seeded
    assert (h[hot_key] in set(hot.tolist())) == seeded
    assert hot.size == (1 if seeded else 0)
    assert np.array_equal(h, hybrid.build_hashes(bk, nb))
