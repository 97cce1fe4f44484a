"""TPC-H Q3 and Q5 served from the mock TiKV store, in the port against
the JAX package, at SF 0.01 with seed 42 in both stores.

The JAX package loads ScaledTpch through its DDL and bulk loader
(benchmarks/tpch.load); the port loads the same generator with
`tpch.load_store` (the KV bytes are identical, tests/test_torch_codec.py).
Then:

  * each TableReader leaf of `tpch.q3_store_plan` / `q5_store_plan` carries
    the CopPlan the JAX planner pushes for tpch.Q3 / Q5 (PhysTableReader.
    cop): the same table, columns, pushed `filter` and `host_filter`;
  * each reader's chunks, region by region on one fan-out thread, equal
    the reference's TableReaderExec.chunks, column by column;
  * run_q3_store's HashAgg groups and rows, and run_q5_store's rows, equal
    the reference's Session.query and the exact numpy truths
    (tpch.q3_groups_truth, q3_truth, q5_truth): revenues are scaled ints
    (decimal, frac 4), tolerance 0;
  * a second run over the same storage gives the same rows from the
    chunk cache (hits, no miss) and every statement's ledger ends at 0.

Both packages run with tidb_tpu_device_min_rows = 1 (at this size the
joined batches are otherwise below the device floor).
"""

import contextlib
import decimal

import numpy as np
import pytest
import torch

from tidb_tpu import config as jconfig
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.executor import ExecContext as JExecContext
from tidb_tpu.executor import TableReaderExec
from tidb_tpu.ops import runtime as jruntime
from tidb_tpu.plan import physical as jph
from tidb_tpu.session import Session
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.executor import ExecContext as PExecContext
from tidb_tpu_torch.executor.agg import run_q3_store, run_q5_store
from tidb_tpu_torch.executor.join import HashJoin
from tidb_tpu_torch.executor.reader import TableReader
from tidb_tpu_torch.ops import runtime as pruntime
from tidb_tpu_torch.sqltypes import parse_datetime
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

SF, SEED = 0.01, 42
RUNS = {"q3": run_q3_store, "q5": run_q5_store}
STORE_PLANS = {"q3": ptpch.q3_store_plan, "q5": ptpch.q5_store_plan}


@contextlib.contextmanager
def sysvars(**values):
    """Set the same sysvars in both packages' registries."""
    old = [(cfg, k, cfg.get_var(k)) for cfg in (jconfig, pconfig)
           for k in values]
    for cfg in (jconfig, pconfig):
        for k, v in values.items():
            cfg.set_var(k, v)
    try:
        yield
    finally:
        for cfg, k, v in old:
            cfg.set_var(k, v)


@pytest.fixture(scope="module")
def data():
    return ptpch.ScaledTpch(SF, SEED)


@pytest.fixture(scope="module")
def stores():
    """(jax session, jax storage, port storage), both loaded."""
    js = jnew_storage()
    s = Session(js)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    jtpch.load(s, js, jtpch.ScaledTpch(SF, SEED))
    ps = pnew_storage(device="cpu")
    ptpch.load_store(ps, ptpch.ScaledTpch(SF, SEED))
    with sysvars(tidb_tpu_device_min_rows=1):
        yield s, js, ps
    s.close()
    js.close()
    ps.close()


def _readers_of(plan, out):
    """The leaves of a port plan tree, left to right."""
    if isinstance(plan, HashJoin):
        _readers_of(plan.left, out)
        _readers_of(plan.right, out)
    elif isinstance(plan, TableReader):
        out.append(plan)
    else:
        _readers_of(plan.child, out)
    return out


def _ref_readers(plan, out):
    """The PhysTableReader leaves of a reference plan, left to right."""
    if isinstance(plan, jph.PhysTableReader):
        out.append(plan)
    for ch in plan.children:
        _ref_readers(ch, out)
    return out


def _pairs(session, name):
    port = _readers_of(STORE_PLANS[name](ptpch.table_infos()), [])
    ref = _ref_readers(session.plan(jtpch.QUERIES[name]), [])
    assert [r.table for r in port] == [r.cop.table.name for r in ref]
    return list(zip(port, ref))


@pytest.mark.parametrize("name", ["q3", "q5"])
def test_leaf_cop_plans_equal_the_planners(stores, name):
    s, _js, _ps = stores
    pairs = _pairs(s, name)
    assert len(pairs) == {"q3": 3, "q5": 6}[name]
    pushed = hosted = 0
    for port, ref in pairs:
        pc, rc = port.cop, ref.cop
        assert pc.table.to_json() == rc.table.to_json()
        assert [c.to_json() for c in pc.cols] == \
            [c.to_json() for c in rc.cols]
        assert pruntime._expr_fp(pc.filter) == jruntime._expr_fp(rc.filter)
        assert pruntime._expr_fp(pc.host_filter) == \
            jruntime._expr_fp(rc.host_filter)
        assert not rc.is_agg and not pc.is_agg
        assert (pc.limit, pc.index, pc.ranges) == \
            (rc.limit, rc.index, rc.ranges) == (None, None, None)
        assert [c.name for c in port.schema] == \
            [c.name for c in ref.schema.cols]
        pushed += pc.filter is not None
        hosted += pc.host_filter is not None
    # both kinds of conjunct are pushed: the date range(s) and the string
    assert pushed >= 1 and hosted == 1


def _columns_equal(pc, jc):
    assert pc.num_rows == jc.num_rows
    for j, (a, b) in enumerate(zip(pc.columns, jc.columns)):
        np.testing.assert_array_equal(a.valid, b.valid, err_msg=str(j))
        if a.data.dtype == object:
            assert list(a.data[a.valid]) == list(b.data[b.valid]), j
        else:
            np.testing.assert_array_equal(a.data[a.valid], b.data[b.valid],
                                          err_msg=str(j))


@pytest.mark.parametrize("name", ["q3", "q5"])
def test_reader_chunks_equal_the_references(stores, name):
    s, js, ps = stores
    with sysvars(tidb_tpu_cop_concurrency=1):
        for port, ref in _pairs(s, name):
            jchunks = list(TableReaderExec(ref).chunks(
                JExecContext(js, js.current_ts())))
            pchunks = list(port.chunks(PExecContext(
                torch.device("cpu"), storage=ps, read_ts=ps.current_ts())))
            assert len(pchunks) == len(jchunks), port.table
            for pc, jc in zip(pchunks, jchunks):
                _columns_equal(pc, jc)


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


@pytest.mark.parametrize("name", ["q3", "q5"])
def test_run_equals_reference_and_truth_cold_and_warm(stores, data, name):
    s, _js, ps = stores
    want = _ref_rows(s, name)
    truth = {"q3": ptpch.q3_truth, "q5": ptpch.q5_truth}[name](data)
    groups = ptpch.q3_groups_truth(data) if name == "q3" else sorted(truth)
    ps.chunk_cache.clear()
    cold = RUNS[name](device="cpu", storage=ps)
    assert cold.rows == want == truth
    assert sorted(cold.groups) == groups
    assert len(truth) == 10 if name == "q3" else len(truth) >= 4
    st = cold.stats
    assert st.fallbacks == 0 and st.mem_left == 0 and st.mem_peak > 0
    assert st.join_paths and cold.storage is ps
    hits, misses = ps.chunk_cache.hits, ps.chunk_cache.misses
    warm = RUNS[name](device="cpu", storage=ps)
    assert warm.rows == cold.rows
    assert sorted(warm.groups) == groups
    assert ps.chunk_cache.hits > hits and ps.chunk_cache.misses == misses
    assert warm.stats.mem_left == 0


def test_store_run_loads_its_own_store(data):
    """Without `storage`, run_q3_store makes and loads a store."""
    with pconfig.session_overlay({"tidb_tpu_device_min_rows": 1}):
        res = run_q3_store(sf=0.002, seed=7, device="cpu")
    try:
        assert res.rows == ptpch.q3_truth(ptpch.ScaledTpch(0.002, 7))
    finally:
        res.storage.close()
