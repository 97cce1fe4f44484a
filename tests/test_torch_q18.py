"""TPC-H Q18's inner block in the port against the JAX package.

`SELECT l_orderkey FROM lineitem GROUP BY l_orderkey HAVING
SUM(l_quantity) > 300` over lineitem's l_orderkey and l_quantity from
ScaledTpch(0.05) (75,000 orders, 300,060 rows), bulk-loaded into a
JAX-package session. After ANALYZE the reference planner must choose
StreamAgg (l_orderkey's NDV, about 73,600, is over 1 << 16), and the
port's `agg_algorithm` over its own ANALYZE of the same column must
choose "stream". The plans must agree (the group column, the aggregate
and its argument, by name and type; the port's scan reads every lineitem
column, as the reference's reader does over the full DDL), and the
reference's rows, the port's `run_q18_inner` rows (on the CPU) and
`tpch.q18_inner_truth` must be equal, as must every group before the
HAVING and `tpch.q18_groups_truth`. A spilled sort gives the same rows.
At SF 0.01 (15,000 orders) both stay on the hash agg and still give the
truth's rows. Keys and scaled-int decimal sums are compared exactly:
tolerance 0.
"""

import numpy as np
import pytest
import torch

from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.plan import physical as jph
from tidb_tpu.session import Session
from tidb_tpu.store.storage import new_mock_storage
from tidb_tpu.table import Table, bulkload
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.executor import agg as pagg

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

SEED = 42


def _session(sf):
    """A JAX-package session holding lineitem's l_orderkey and
    l_quantity from ScaledTpch(sf), ANALYZEd."""
    d = jtpch.ScaledTpch(sf, SEED)
    s = Session(new_mock_storage())
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    s.execute("CREATE TABLE lineitem (l_id BIGINT PRIMARY KEY, "
              "l_orderkey BIGINT, l_quantity DECIMAL(15,2))")
    n = d.counts["lineitem"]
    tbl = Table(s.domain.info_schema().table("tpch", "lineitem"), s.storage)
    bulkload.bulk_load(s.storage, tbl, {
        "l_id": np.arange(n, dtype=np.int64),
        "l_orderkey": d.l_orderkey,
        "l_quantity": d.l_quantity * 100})     # DECIMAL(15,2) scaled
    s.execute("ANALYZE TABLE lineitem")
    return s


def _agg_node(plan):
    node = plan
    while not isinstance(node, (jph.PhysStreamAgg, jph.PhysHashAgg,
                                jph.PhysFinalAgg)):
        node = node.children[0]
    return node


@pytest.fixture(scope="module")
def above():
    s = _session(0.05)
    yield s, ptpch.ScaledTpch(0.05, SEED)
    s.close()


def test_analyze_picks_stream_agg_in_both(above):
    s, d = above
    plan = s.plan(ptpch.Q18_INNER)
    assert "StreamAgg" in plan.explain(), plan.explain()
    ref = _agg_node(plan)
    assert isinstance(ref, jph.PhysStreamAgg) and not ref.sorted_input
    tables = ptpch.table_chunks(d, ["lineitem"])
    stats = ptpch.analyze_columns(None, ["l_orderkey"], "cpu",
                                  chunks=tables["lineitem"])["l_orderkey"]
    assert stats.hist.ndv > pagg.STREAM_AGG_NDV
    op, _having = ptpch.q18_inner_plan()
    assert pagg.agg_algorithm([stats], op.aggs) == "stream"
    assert not op.sorted_input
    # the same plan: group column, aggregate and argument by name and
    # type (the reference's reader over this 3-column table numbers the
    # columns differently from the full lineitem DDL the port scans)
    def shape(group_exprs, aggs, schema):
        def ref(e):
            return (schema[e.idx].name, int(e.ft.tp), e.ft.flen, e.ft.frac)
        return ([ref(g) for g in group_exprs],
                [(a.fn.value, a.distinct, ref(a.arg)) for a in aggs])
    assert shape(op.group_exprs, op.aggs, op.child.schema) == \
        shape(ref.group_exprs, ref.aggs, ref.children[0].schema.cols)


def test_rows_equal_reference_and_truth(above):
    s, d = above
    want = [r[0] for r in s.query(ptpch.Q18_INNER).rows]
    truth = ptpch.q18_inner_truth(d)
    tables = ptpch.table_chunks(d, ["lineitem"], 1 << 14)
    res = pagg.run_q18_inner(device="cpu", tables=tables,
                             superchunk_rows=1 << 14)
    got = [r[0] for r in res.rows]
    assert sorted(want) == got == truth.tolist()
    assert len(got) == 240
    keys, sums = ptpch.q18_groups_truth(d)
    np.testing.assert_array_equal(res.groups[0], keys)
    np.testing.assert_array_equal(res.groups[1], sums)
    st = res.stats
    assert st.agg_algorithm == "stream" and not st.fallbacks
    assert st.device_batches == st.superchunks == 19
    assert st.mem_left == 0 and st.mem_peak > 0


def test_spilled_sort_gives_the_same_rows(above):
    _s, d = above
    from tidb_tpu_torch import config
    tables = ptpch.table_chunks(d, ["lineitem"], 1 << 14)
    with config.session_overlay({"tidb_tpu_sort_spill_rows": 50_000}):
        res = pagg.run_q18_inner(device="cpu", tables=tables,
                                 superchunk_rows=1 << 15)
    assert [r[0] for r in res.rows] == ptpch.q18_inner_truth(d).tolist()
    # 16,384-row chunks into runs of 50,000 rows: a run per 4 chunks
    assert res.stats.sort_spilled_runs == 4 and res.stats.mem_left == 0


def test_below_threshold_both_keep_the_hash_agg():
    s = _session(0.01)
    try:
        plan = s.plan(ptpch.Q18_INNER)
        assert "StreamAgg" not in plan.explain(), plan.explain()
        want = sorted(r[0] for r in s.query(ptpch.Q18_INNER).rows)
    finally:
        s.close()
    d = ptpch.ScaledTpch(0.01, SEED)
    res = pagg.run_q18_inner(device="cpu", tables=ptpch.table_chunks(
        d, ["lineitem"], 1 << 14), superchunk_rows=1 << 14)
    assert res.stats.agg_algorithm == "hash"
    assert [r[0] for r in res.rows] == want == \
        ptpch.q18_inner_truth(d).tolist()
    keys, sums = ptpch.q18_groups_truth(d)
    np.testing.assert_array_equal(res.groups[0], keys)
    np.testing.assert_array_equal(res.groups[1], sums)
