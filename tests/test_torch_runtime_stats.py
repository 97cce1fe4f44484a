"""EXPLAIN ANALYZE and the per-operator runtime statistics of the port
against the JAX package's.

Both packages load `ScaledTpch(sf=0.002, seed=42)` through
`benchmarks/tpch.load` (the port's storage on the CPU) and run EXPLAIN
ANALYZE of TPC-H Q1, Q3 and Q5 and of the subquery, UNION and cross
join statements of this slice, with tidb_tpu_device_min_rows = 1 and
tidb_tpu_superchunk_rows = 4096: the columns are the reference's, and
per operator the id, est_rows, act_rows, loops, cop_tasks and the
pipeline cell's `Nsc/Mch fill=` part are equal (the times, memory, the
pipeline cell's stall and the kernel cells are measurements of each
package). HashAgg over a MergeJoin of two 6,000-row tables, the
smallest input on which the port once recorded no superchunk, holds the
same cell. The root's act_rows equals the rows the statement returns;
the reader that pushes Q1's aggregate shows a kernel cell and, under
`tidb_tpu_runtime_stats_device = 1`, a device time. The digest summary
then carries the operators' rows.

The reference's own `tests/test_runtime_stats.py` is replayed against
the port (`replay`; the session's collector is `last_collector` in the
port). Its wall-clock case (TestOverhead's per-chunk wrapper budget) is
not replayed: a loaded shared CPU breaks it, and the smoke measures the
instrumentation's overhead on the card.
"""

import pytest

from tests.test_torch_server import replay
from tests.test_torch_session import sysvars
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

SF, SEED = 0.002, 42
SYSVARS = {"tidb_tpu_device_min_rows": 1, "tidb_tpu_superchunk_rows": 4096}
STATEMENTS = {"q1": ptpch.Q1, "q3": ptpch.Q3, "q5": ptpch.Q5,
              "q18": ptpch.Q18.replace("> 300", "> 150"),
              "not_in": ptpch.NOT_IN, "scalar": ptpch.SCALAR_SUBQUERY,
              "union_all": ptpch.UNION_ALL, "cross": ptpch.CROSS_JOIN}
COLUMNS = ["id", "est_rows", "act_rows", "loops", "time", "device_time",
           "mem", "cop_tasks", "pipeline", "kernel"]


@pytest.fixture(scope="module")
def tpch_pair():
    js, ps = jnew_storage(), pnew_storage(device="cpu")
    jsess, psess = JSession(js), PSession(ps)
    for s in (jsess, psess):
        s.execute("CREATE DATABASE tpch")
        s.execute("USE tpch")
    jtpch.load(jsess, js, jtpch.ScaledTpch(SF, SEED))
    ptpch.load(psess, ps, ptpch.ScaledTpch(SF, SEED))
    with sysvars(SYSVARS):
        yield jsess, psess
    for s, st in ((jsess, js), (psess, ps)):
        s.close()
        st.close()


def _pipeline(cell: str) -> str:
    """The deterministic part of the pipeline cell: `Nsc/Mch fill=F`
    (the stall after it is a wall-clock measurement)."""
    return cell.split(" stall=")[0]


def _counted(rows):
    # id, est_rows, act_rows, loops, cop_tasks, superchunks and fill
    return [(r[0], r[1], r[2], r[3], r[7], _pipeline(r[8])) for r in rows]


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_explain_analyze_equals_the_reference(tpch_pair, name):
    jsess, psess = tpch_pair
    sql = STATEMENTS[name]
    want = jsess.query("EXPLAIN ANALYZE " + sql)
    got = psess.query("EXPLAIN ANALYZE " + sql)
    assert got.columns == want.columns == COLUMNS
    assert _counted(got.rows) == _counted(want.rows)
    assert got.rows[0][2] == len(psess.query(sql).rows)
    assert psess.last_mem_left == 0


def test_superchunks_over_a_merge_join_equal_the_reference():
    sql = ("EXPLAIN ANALYZE SELECT a.g, COUNT(*), SUM(b.w) FROM a JOIN b "
           "ON a.id = b.id GROUP BY a.g")
    cells = []
    for sess in (JSession(jnew_storage()),
                 PSession(pnew_storage(device="cpu"))):
        sess.execute("CREATE DATABASE d")
        sess.execute("USE d")
        sess.execute("CREATE TABLE a (id BIGINT PRIMARY KEY, g BIGINT, "
                     "v BIGINT)")
        sess.execute("CREATE TABLE b (id BIGINT PRIMARY KEY, w BIGINT)")
        for lo in range(0, 6000, 1000):
            ids = range(lo, lo + 1000)
            sess.execute("INSERT INTO a VALUES " + ",".join(
                f"({i},{i % 7},{i})" for i in ids))
            sess.execute("INSERT INTO b VALUES " + ",".join(
                f"({i},{i})" for i in ids))
        with sysvars({"tidb_tpu_device_min_rows": 1,
                      "tidb_tpu_superchunk_rows": 1 << 18}):
            rows = sess.query(sql).rows
        cells.append([(r[0], _pipeline(r[8])) for r in rows])
        sess.close()
    want, got = cells
    assert got == want
    agg = [c for name, c in got if "HashAgg" in name]
    assert agg == ["1sc/1ch fill=0.73"]


def test_reader_kernel_and_device_time(tpch_pair):
    _jsess, psess = tpch_pair
    psess.execute("SET @@tidb_tpu_runtime_stats_device = 1")
    try:
        rows = psess.query("EXPLAIN ANALYZE " + ptpch.Q1).rows
    finally:
        psess.execute("SET @@tidb_tpu_runtime_stats_device = 0")
    reader = [r for r in rows if "TableReader" in r[0]]
    assert reader and reader[0][9] != "-" and "hashagg" in reader[0][9]
    assert reader[0][5] not in ("-", "0ns")
    off = psess.query("EXPLAIN ANALYZE " + ptpch.Q1).rows
    assert all(r[5] == "-" for r in off)


def test_digest_carries_operator_rows(tpch_pair):
    _jsess, psess = tpch_pair
    psess.query(ptpch.Q3)
    ops = psess.last_collector.ops()
    # a join the fused HashAgg drives itself yields no chunk of its own
    assert ops and all(o.loops > 0 for o in ops if o.name != "HashJoin")
    top = [o for o in ops if o.name == "Projection"]
    assert top and top[-1].act_rows == 10
    assert sum(o.cop_tasks for o in ops) > 0


replay("test_runtime_stats.py", globals(), drop={
    "TestOverhead::test_wrapper_overhead_per_chunk_is_tiny":
        "a wall-clock budget, which a loaded shared CPU breaks (the JAX "
        "package's own TestOverhead has failed under load); the smoke "
        "measures the overhead on the card"},
    subs={"import tpch\n": "from tests import tpch\n",
          "sess._last_stats": "sess.last_collector"})
