"""TPC-H Q3 and Q5 in the port against the JAX package.

One seeded ScaledTpch at SF 0.005 is loaded once into a JAX-package
session (benchmarks/tpch.load) and built once as the port's table
chunks. The port's plan trees (benchmarks/tpch.q3_plan / q5_plan) must
equal the reference planner's: join order, build sides, join keys,
scan schemas and filters, and the fused fragment's plan fingerprint.
Then run_q3 / run_q5 (on the CPU) must return exactly the rows of the
reference's Session.query(Q3 / Q5) and of the exact numpy truths (and,
before the host tail, every group of the HashAgg: for Q3 those of
tpch.q3_groups_truth), twice:
at the default tidb_tpu_superchunk_rows, where the fused fragment and
the pipelined probes run, and at 4096 in both packages, where the
lineitem joins take the hybrid path as they do at SF 10. Both packages
run with tidb_tpu_device_min_rows = 1 (at this size the joined batches
are otherwise below the device floor). Revenues are scaled ints
(decimal, frac 4) and compared exactly: tolerance 0.
"""

import decimal

import pytest
import torch

from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.ops import runtime as jruntime
from tidb_tpu.plan import physical as jph
from tidb_tpu.session import Session
from tidb_tpu.store.storage import new_mock_storage
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.executor.agg import HashAgg, run_q3, run_q5
from tidb_tpu_torch.executor.join import HashJoin
from tidb_tpu_torch.executor.scan import TableScan
from tidb_tpu_torch.ops import runtime as pruntime
from tidb_tpu_torch.sqltypes import parse_datetime

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

SF, SEED = 0.005, 42


@pytest.fixture(scope="module")
def data():
    return ptpch.ScaledTpch(SF, SEED)


@pytest.fixture(scope="module")
def session():
    s = Session(new_mock_storage())
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    jtpch.load(s, s.storage, jtpch.ScaledTpch(SF, SEED))
    s.execute("SET tidb_tpu_device_min_rows = 1")
    yield s
    s.close()


@pytest.fixture(scope="module")
def tables(data):
    return ptpch.table_chunks(data, ptpch.QUERY_TABLES["q5"])


def _schema(cols):
    return [(c.table, c.name, int(c.ft.tp), c.ft.flen, c.ft.frac,
             c.ft.collation) for c in cols]


def _keys(keys):
    return [(k.idx, int(k.ft.tp), k.ft.flen, k.ft.frac) for k in keys]


def _same_tree(p, r):
    """The port's operator tree `p` equals the reference plan `r`."""
    assert _schema(p.schema) == _schema(r.schema.cols)
    if isinstance(r, jph.PhysHashJoin):
        assert isinstance(p, HashJoin)
        assert (p.join_type, p.other_cond) == (r.join_type, None) and \
            r.other_cond is None
        assert _keys(p.left_keys) == _keys(r.left_keys)
        assert _keys(p.right_keys) == _keys(r.right_keys)
        _same_tree(p.left, r.children[0])
        _same_tree(p.right, r.children[1])
        return
    assert isinstance(r, jph.PhysTableReader) and isinstance(p, TableScan)
    assert p.table == r.cop.table.name
    assert pruntime._expr_fp(p.filter) == jruntime._expr_fp(r.cop.filter)
    assert pruntime._expr_fp(p.host_filter) == \
        jruntime._expr_fp(r.cop.host_filter)


def _ref_agg(plan):
    while not isinstance(plan, jph.PhysHashAgg):
        (plan,) = plan.children
    return plan


@pytest.mark.parametrize("name", ["q3", "q5"])
def test_plan_equals_reference_planner(session, name):
    ref = _ref_agg(session.plan(jtpch.QUERIES[name]))
    port = {"q3": ptpch.q3_plan, "q5": ptpch.q5_plan}[name]()
    assert isinstance(port, HashAgg)
    # the fused fragment's identity: group/agg fingerprint over the join
    want = jruntime.plan_fingerprint(None, ref.group_exprs, ref.aggs)
    assert want is not None
    assert pruntime.plan_fingerprint(None, port.group_exprs,
                                     port.aggs) == want
    _same_tree(port.child, ref.children[0])


def _ref_rows(session, name):
    """The reference's rows in the port's layout: revenue as a scaled int
    (frac 4), dates as epoch micros."""
    rows = session.query(jtpch.QUERIES[name]).rows

    def scaled(v):
        return int(decimal.Decimal(v).scaleb(4))
    if name == "q3":
        return [(k, scaled(rev), parse_datetime(od), sp)
                for k, rev, od, sp in rows]
    return [(n, scaled(rev)) for n, rev in rows]


@pytest.mark.parametrize("superchunk", [None, 4096])
@pytest.mark.parametrize("name", ["q3", "q5"])
def test_run_matches_reference_and_truth(session, data, tables, name,
                                         superchunk):
    run = {"q3": run_q3, "q5": run_q5}[name]
    truth = {"q3": ptpch.q3_truth, "q5": ptpch.q5_truth}[name](data)
    sc = superchunk or pconfig.superchunk_rows()
    session.execute(f"SET tidb_tpu_superchunk_rows = {sc}")
    try:
        want = _ref_rows(session, name)
    finally:
        session.execute("SET tidb_tpu_superchunk_rows = "
                        f"{pconfig.superchunk_rows()}")
    with pconfig.session_overlay({"tidb_tpu_device_min_rows": 1}):
        res = run(device="cpu", tables={t: tables[t] for t in
                                        ptpch.QUERY_TABLES[name]},
                  superchunk_rows=superchunk)
    assert res.rows == want == truth
    assert len(truth) == 10 if name == "q3" else len(truth) >= 4
    # every group of the HashAgg, before the host tail
    groups = ptpch.q3_groups_truth(data) if name == "q3" else sorted(truth)
    assert sorted(res.groups) == groups
    assert len(groups) > 10 if name == "q3" else len(groups) == len(truth)
    st = res.stats
    assert st.fallbacks == 0
    top = "lineitem" if name == "q3" else "region"
    if superchunk is None:
        assert st.join_paths[top] == "fused" and st.fused_dispatches > 0
    else:
        assert st.join_paths["lineitem"] == "hybrid"
        assert st.hybrid_tasks > 0 and st.partition_uploads > 0
        if name == "q3":
            assert st.device_batches > 0      # the agg over joined rows
        else:
            assert st.join_paths["region"] == "fused"
