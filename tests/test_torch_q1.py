"""TPC-H Q1's device aggregation path in the port against the JAX package.

The plan is the one the JAX planner pushes to the coprocessor for
`tpch.Q1`, captured by wrapping `tidb_tpu.ops.hashagg.kernel_for` while a
tiny session runs the query. The data is the same seeded ScaledTpch in
both packages. The port's `run_q1` (on the CPU here, with small
superchunks so several partials merge) must give exactly the rows of the
JAX package's kernel_for + HashAggregator over the same superchunks, and
of an exact numpy truth. All Q1 lanes are int64: compared exactly.
"""

import numpy as np
import pytest
import torch

import tpch as tiny_tpch
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.chunk import Chunk as JChunk
from tidb_tpu.chunk import Column as JColumn
from tidb_tpu.ops import hashagg as jh
from tidb_tpu.ops import runtime as jruntime
from tidb_tpu.session import Session
from tidb_tpu.sqltypes import FieldType as JFieldType
from tidb_tpu.sqltypes import TypeCode as JTypeCode
from tidb_tpu.store.storage import new_mock_storage
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.executor.agg import run_q1
from tidb_tpu_torch.ops import runtime as pruntime

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

SF, SEED, ROWS = 0.002, 42, 4096


@pytest.fixture(scope="module")
def jax_q1_plan():
    """(filter, group_exprs, aggs) the JAX planner pushes for Q1."""
    seen = []
    orig = jh.kernel_for

    def spy(filter_expr, group_exprs, aggs, capacity=4096):
        seen.append((filter_expr, list(group_exprs), list(aggs)))
        return orig(filter_expr, group_exprs, aggs, capacity=capacity)

    jh.kernel_for = spy
    try:
        s = Session(new_mock_storage())
        s.execute("CREATE DATABASE tpch")
        s.execute("USE tpch")
        # a tiny table: let every region's chunk take the device path
        s.execute("SET tidb_tpu_device_min_rows = 1")
        tiny_tpch.load(s, tiny_tpch.TpchData(lineitems=400, orders=100,
                                             customers=20, suppliers=10))
        s.query(tiny_tpch.Q1)
    finally:
        jh.kernel_for = orig
    assert seen, "Q1 never reached kernel_for"
    return seen[0]


@pytest.fixture(scope="module")
def data():
    return ptpch.ScaledTpch(SF, SEED)


def test_q1_plan_fingerprint_matches_planner(jax_q1_plan):
    want = jruntime.plan_fingerprint(*jax_q1_plan)
    assert want is not None
    assert pruntime.plan_fingerprint(*ptpch.q1_plan()) == want


def test_generator_matches_reference(data):
    ref = jtpch.ScaledTpch(SF, SEED)
    assert data.counts == ref.counts
    for name in ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate",
                 "l_orderkey", "l_suppkey"):
        np.testing.assert_array_equal(getattr(data, name), getattr(ref, name))


def _jax_chunks(chunks):
    out = []
    for ch in chunks:
        cols = [JColumn(JFieldType(JTypeCode(int(c.ft.tp)), flen=c.ft.flen,
                                   frac=c.ft.frac), c.data, c.valid)
                for c in ch.columns]
        out.append(JChunk(cols))
    return out


def test_run_q1_matches_reference(jax_q1_plan, data):
    chunks = ptpch.lineitem_chunks(data, ROWS)
    res = run_q1(device="cpu", chunks=chunks, superchunk_rows=ROWS)
    assert res.stats.device_batches == len(chunks) == 3
    assert res.stats.fallbacks == 0 and res.stats.escalations == 0

    flt, group_exprs, aggs = jax_q1_plan
    k = jh.kernel_for(flt, group_exprs, aggs)
    agg = jh.HashAggregator(aggs, group_exprs)
    for sc in jruntime.superchunk_batches(_jax_chunks(chunks), ROWS):
        agg.update(k(sc.chunk))
    want = [tuple(key) + tuple(vals) for key, vals in agg.results()]
    assert len(want) == 6
    assert res.rows == want
    assert res.rows == ptpch.q1_truth(data)

    # a second run over the same chunks serves the memoized device columns
    assert all(getattr(ch, "_dev_cache", None) for ch in chunks)
    again = run_q1(device="cpu", chunks=chunks, superchunk_rows=ROWS)
    assert again.rows == want


def test_record_calls_captures_each_segment_sum_call(data):
    """segsum_bench.record_calls (which chip_smoke uses to hold the kernel
    at the path's shapes) sees one stacked call per superchunk, keeps
    clones of the first `keep`, and restores segment_sum on exit."""
    from tidb_tpu_torch.benchmarks.segsum_bench import record_calls
    from tidb_tpu_torch.ops import segsum
    real = segsum.segment_sum
    chunks = ptpch.lineitem_chunks(data, ROWS)
    with record_calls(keep=2) as rec:
        res = run_q1(device="cpu", chunks=chunks, superchunk_rows=ROWS)
    assert segsum.segment_sum is real
    assert rec.calls() == res.stats.device_batches == 3
    for (n, k, c, dtype, mask), ent in rec.shapes.items():
        assert (k, dtype, mask) == (12, "int64", "lane")
        assert len(ent["inputs"]) == min(ent["calls"], 2)
        for v, i, m, cc in ent["inputs"]:
            assert v.shape == (n, k) and m.shape == v.shape and cc == c
            torch.testing.assert_close(
                segsum.segment_sum(v, i, c, valid=m),
                segsum.segment_sum_plain(v, i, c, valid=m), rtol=0, atol=0)


def test_run_q1_one_superchunk_equals_many(data):
    """Merging partials across superchunks gives the rows of one pass."""
    one = run_q1(device="cpu", chunks=ptpch.lineitem_chunks(data, 1 << 15),
                 superchunk_rows=1 << 15)
    assert one.stats.device_batches == 1
    assert one.rows == ptpch.q1_truth(data)


def test_lineitem_chunks_carry_dictionary_memo(data):
    """The CHAR(1) columns carry their dict_encode memo, so no per-row
    encode pass runs, and the memo decodes to the column's strings."""
    from tidb_tpu_torch.chunk import dict_encode
    ch = ptpch.lineitem_chunks(data, ROWS)[1]
    for j in (7, 8):
        col = ch.columns[j]
        codes, values = dict_encode(col)
        assert codes.dtype == np.int64
        assert list(np.asarray(values, dtype=object)[codes]) == \
            list(col.data)
