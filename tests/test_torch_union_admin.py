"""UNION, the cross join and ADMIN through the port's Session against the
JAX package's.

Both packages load `ScaledTpch(sf=0.002, seed=42)` through
`benchmarks/tpch.load` (the port's storage on the CPU) and run, with
tidb_tpu_device_min_rows = 1 and tidb_tpu_superchunk_rows = 4096:

  * UNION ALL and UNION of a lineitem aggregate by l_returnflag and an
    orders aggregate by o_orderpriority (tpch.UNION_ALL, tpch.UNION),
    whose branches push their partial aggregates to the coprocessor;
  * the cross join tpch.CROSS_JOIN (region x customer, a HashJoin with
    no key, aggregated), held also against the counts of the data;
  * ADMIN CHECK TABLE, SHOW DDL and SHOW DDL JOBS;

each giving the reference's rows on the port's device path (CPU) and
under `SET @@tidb_tpu_device = 0` (exact for int and decimal, rel 1e-12
for real), with its ledger at 0 after it. The reference's own
`tests/test_union_admin_infoschema.py` is replayed against the port
(`replay`).
"""

import pytest

from tests.test_torch_server import replay
from tests.test_torch_session import assert_same_rows, sysvars
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

SF, SEED = 0.002, 42
SYSVARS = {"tidb_tpu_device_min_rows": 1, "tidb_tpu_superchunk_rows": 4096}

STATEMENTS = {
    "union_all": ptpch.UNION_ALL + " ORDER BY 1",
    "union": ptpch.UNION + " ORDER BY 1",
    "union_mixed": "SELECT r_regionkey, r_name FROM region UNION "
                   "SELECT n_nationkey * 1.5, n_regionkey FROM nation "
                   "ORDER BY 1, 2",
    "cross": ptpch.CROSS_JOIN,
    "cross_cond": "SELECT r_name, n_name FROM region, nation "
                  "WHERE r_regionkey < n_regionkey ORDER BY 1, 2",
    "admin_check": "ADMIN CHECK TABLE customer",
    "admin_show_ddl_jobs": "ADMIN SHOW DDL JOBS",
}


@pytest.fixture(scope="module")
def tpch_sessions():
    """(reference session, port session, data), both loaded."""
    d = ptpch.ScaledTpch(SF, SEED)
    js, ps = jnew_storage(), pnew_storage(device="cpu")
    jsess, psess = JSession(js), PSession(ps)
    for s in (jsess, psess):
        s.execute("CREATE DATABASE tpch")
        s.execute("USE tpch")
    jtpch.load(jsess, js, jtpch.ScaledTpch(SF, SEED))
    ptpch.load(psess, ps, d)
    for s in (jsess, psess):
        s.execute("CREATE INDEX c_nation ON customer (c_nationkey)")
    with sysvars(SYSVARS):
        yield jsess, psess, d
    psess.close()
    jsess.close()
    ps.close()
    js.close()


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_equals_the_reference(tpch_sessions, name):
    jsess, psess, _d = tpch_sessions
    sql = STATEMENTS[name]
    want = jsess.query(sql)
    got = psess.query(sql)
    assert got.columns == want.columns
    assert_same_rows(got.rows, want.rows)
    assert psess.last_mem_left == 0
    psess.execute("SET @@tidb_tpu_device = 0")
    try:
        host = psess.query(sql).rows
    finally:
        psess.execute("SET @@tidb_tpu_device = 1")
    assert_same_rows(host, want.rows)
    assert psess.last_mem_left == 0


def test_cross_join_equals_the_counts(tpch_sessions):
    _jsess, psess, d = tpch_sessions
    rows = psess.query(ptpch.CROSS_JOIN).rows
    st = psess.last_stats
    n = len(d.c_custkey)
    s = int(d.c_nationkey.sum())
    assert sorted(rows) == sorted((r, n, s) for r in ptpch.REGIONS)
    assert st.join_paths == {"customer": "cross"}
    # the aggregate over the product runs on the device
    assert st.device_batches > 0 and st.fallbacks == 0
    assert any("lkeys:[]" in r[0] for r in psess.query(
        "EXPLAIN " + ptpch.CROSS_JOIN).rows)


def test_union_branches_push_their_partial_aggregates(tpch_sessions):
    jsess, psess, _d = tpch_sessions
    lines = [r[0] for r in psess.query("EXPLAIN " + ptpch.UNION_ALL).rows]
    assert lines == [r[0] for r in jsess.query(
        "EXPLAIN " + ptpch.UNION_ALL).rows]
    assert lines[0].startswith("Union")
    assert sum("partial_agg" in x for x in lines) == 2


def test_admin_show_ddl(tpch_sessions):
    jsess, psess, _d = tpch_sessions
    got = psess.query("ADMIN SHOW DDL").rows
    want = jsess.query("ADMIN SHOW DDL").rows
    assert len(got) == 1 and got[0][1:] == want[0][1:] == ("self", "self")
    assert psess.query("ADMIN CANCEL DDL JOBS 99999").rows == \
        jsess.query("ADMIN CANCEL DDL JOBS 99999").rows


replay("test_union_admin_infoschema.py", globals())
