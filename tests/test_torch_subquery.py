"""Subqueries (the Apply operator) through the port's Session against the
JAX package's.

Both packages load `ScaledTpch(sf=0.002, seed=42)` through
`benchmarks/tpch.load` (the port's storage on the CPU) and run, with
tidb_tpu_device_min_rows = 1 and tidb_tpu_superchunk_rows = 4096:

  * TPC-H Q18 as the port's tpch.Q18 adapts it (an IN subquery with
    GROUP BY ... HAVING, which plans to an uncorrelated Apply), also
    with the HAVING threshold at 150 so that it returns 100 rows; NOT IN
    (always an uncorrelated Apply); a correlated scalar subquery (one
    inner run per nation); TPC-H Q4 (its EXISTS decorrelates into a semi
    join);
  * each statement gives the reference's rows on the port's device path
    (CPU) and under `SET @@tidb_tpu_device = 0` (exact for int and
    decimal, rel 1e-12 for real), its ledger reads 0 after it, and the
    scalar subquery's counts equal `np.bincount` over the customers'
    nation keys.

The reference's own `tests/test_subquery.py` and `test_decorrelate.py`
are replayed against the port (`replay`).
"""

import numpy as np
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
    "q18": ptpch.Q18,
    "q18_150": ptpch.Q18.replace("> 300", "> 150"),
    "not_in": ptpch.NOT_IN,
    "scalar": ptpch.SCALAR_SUBQUERY,
    "q4": ptpch.Q4,
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
        st = psess.last_stats
    finally:
        psess.execute("SET @@tidb_tpu_device = 1")
    assert_same_rows(host, want.rows)
    assert (st.superchunks, st.fused_dispatches) == (0, 0)
    assert psess.last_mem_left == 0


def test_q18_plans_an_uncorrelated_apply(tpch_sessions):
    jsess, psess, _d = tpch_sessions
    for name in ("q18", "not_in"):
        lines = [r[0] for r in psess.query(
            "EXPLAIN " + STATEMENTS[name]).rows]
        assert any("Apply in (uncorrelated)" in x or
                   "Apply not in (uncorrelated)" in x for x in lines)
        assert lines == [r[0] for r in jsess.query(
            "EXPLAIN " + STATEMENTS[name]).rows]
    rows = psess.query(STATEMENTS["q18_150"]).rows
    assert len(rows) == 100
    # the HashAgg over the Apply aggregates on the device
    assert psess.last_stats.device_batches > 0


def test_scalar_subquery_equals_bincount(tpch_sessions):
    _jsess, psess, d = tpch_sessions
    counts = np.bincount(d.c_nationkey, minlength=len(ptpch.NATIONS))
    want = sorted((name, int(counts[k]))
                  for k, (name, _r) in enumerate(ptpch.NATIONS))
    assert psess.query(STATEMENTS["scalar"]).rows == want
    lines = [r[0] for r in psess.query(
        "EXPLAIN " + STATEMENTS["scalar"]).rows]
    assert any("Apply scalar (correlated)" in x for x in lines)


def test_q4_decorrelates_into_a_semi_join(tpch_sessions):
    _jsess, psess, _d = tpch_sessions
    lines = [r[0] for r in psess.query("EXPLAIN " + ptpch.Q4).rows]
    assert any("semi" in x for x in lines)
    assert not any("Apply" in x for x in lines)


replay("test_subquery.py", globals())
replay("test_decorrelate.py", globals())
