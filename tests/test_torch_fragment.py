"""The port's fused probe -> partial-agg fragment (ops/fragment.py)
against the JAX package's, at the operator level, on the shapes of
tests/test_fragment_fusion.py.

One seeded fact/dim pair (dangling and NULL join keys, a DECIMAL
measure, a dictionary-encoded build string) goes through both
packages' ProbeAggKernel (prepare_build, dispatch, finalize; the port's
on the CPU) for: a group by the build string, a high-cardinality probe
key that overflows the group table (both raise CapacityError at the same
count, and both escalated kernels agree), AVG with columns of both
sides, a scalar aggregate, and the 5000 x 100 one-key join whose 500,000
pairs overflow the first pair capacity and regrow. FIRST_ROW must reject
in both. GroupResults compare exactly for int64 and decimal lanes
(tolerance 0); no float lane is involved.
"""

import numpy as np
import pytest
import torch

from test_torch_hashagg import assert_group_results_equal, port_chunk
from tidb_tpu import sqltypes as st
from tidb_tpu.chunk import Chunk, Column
from tidb_tpu.expression import AggDesc, AggFunc, col
from tidb_tpu.ops import fragment as jf
from tidb_tpu.ops.hashagg import CapacityError as JCapacityError
from tidb_tpu.ops.hashagg import DeviceRejectError as JReject
from tidb_tpu_torch import convert
from tidb_tpu_torch.ops import fragment as pf
from tidb_tpu_torch.ops.hashagg import CapacityError as PCapacityError
from tidb_tpu_torch.ops.hashagg import DeviceRejectError as PReject

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

INT = st.new_int_field()
DEC = st.new_decimal_field(flen=12, frac=2)
STR = st.new_string_field(flen=8)


def _fact_dim():
    """fact(id, k, amt, q) probes dim(id, grp, w) on fact.k = dim.id."""
    rng = np.random.default_rng(12)
    n, nd = 8000, 300
    k = rng.integers(0, nd + 40, n).astype(np.int64)   # dangling keys
    kv = np.arange(n) % 97 != 0                         # NULL keys
    fact = Chunk([Column(INT, np.arange(n, dtype=np.int64),
                         np.ones(n, bool)),
                  Column(INT, k, kv),
                  Column(DEC, rng.integers(0, 99999, n).astype(np.int64),
                         np.ones(n, bool)),
                  Column(INT, np.arange(n, dtype=np.int64) % 19,
                         np.ones(n, bool))])
    grp = np.array([f"g{i % 7}" for i in range(nd)], dtype=object)
    dim = Chunk([Column(INT, np.arange(nd, dtype=np.int64),
                        np.ones(nd, bool)),
                 Column(STR, grp, np.ones(nd, bool)),
                 Column(INT, np.arange(nd, dtype=np.int64) % 13,
                        np.ones(nd, bool))])
    return fact, dim


def _run(mod, probe, build, group_exprs, aggs, capacity=4096, **kw):
    """prepare_build + dispatch + finalize of one package's kernel over
    one probe chunk. The port's takes its own chunk and expressions."""
    nl = probe.num_cols
    width = nl + build.num_cols
    k = mod.ProbeAggKernel(1, nl, width, group_exprs, aggs,
                           capacity=capacity, **kw)
    bk = [(build.columns[0].data, build.columns[0].valid)]
    pk = [(probe.columns[1].data, probe.columns[1].valid)]
    nb, n = build.num_rows, probe.num_rows
    dev = k.prepare_build(build, bk, nb)
    return k.finalize(probe, build, nb, k.dispatch(dev, nb, pk, probe, n))


def _both(fact, dim, group_exprs, aggs, capacity=4096):
    want = _run(jf, fact, dim, group_exprs, aggs, capacity)
    got = _run(pf, port_chunk(fact), port_chunk(dim),
               [convert.expr_from(g) for g in group_exprs],
               [convert.agg_from(a) for a in aggs], capacity,
               device="cpu")
    assert_group_results_equal(got, want)
    return got


# joined schema: fact 0..3 (id, k, amt, q), dim 4..6 (id, grp, w)
def test_group_by_build_string():
    fact, dim = _fact_dim()
    got = _both(fact, dim, [col(5, STR, "grp")],
                [AggDesc(AggFunc.COUNT, None),
                 AggDesc(AggFunc.SUM, col(2, DEC, "amt")),
                 AggDesc(AggFunc.MIN, col(3, INT, "q")),
                 AggDesc(AggFunc.MAX, col(6, INT, "w"))])
    assert sorted(got.keys) == [(f"g{i}",) for i in range(7)]


def test_high_cardinality_probe_key_escalates():
    """More groups than the table: CapacityError with the same needed
    count in both, then the escalated kernels agree."""
    fact, dim = _fact_dim()
    g = [col(0, INT, "id")]
    aggs = [AggDesc(AggFunc.SUM, col(2, DEC, "amt"))]
    with pytest.raises(JCapacityError) as je:
        _run(jf, fact, dim, g, aggs)
    with pytest.raises(PCapacityError) as pe:
        _run(pf, port_chunk(fact), port_chunk(dim),
             [convert.expr_from(x) for x in g],
             [convert.agg_from(a) for a in aggs], device="cpu")
    assert pe.value.needed == je.value.needed > 4096
    got = _both(fact, dim, g, aggs, capacity=16384)
    assert 4096 < len(got.keys) <= je.value.needed


def test_hash_agg_operator_escalates_the_fused_fragment():
    """Through the operators (HashAgg over HashJoin over two TableScans):
    the agg fuses with the join, the 8000 groups overflow the fragment's
    table, the fragment re-plans once for the superchunk and runs it
    again, and the rows equal the reference kernel's at a table that
    fits."""
    from tidb_tpu.ops.hashagg import HashAggregator as JAggregator
    from tidb_tpu_torch.executor import ExecContext
    from tidb_tpu_torch.executor.agg import HashAgg, _chunk_rows
    from tidb_tpu_torch.executor.join import HashJoin
    from tidb_tpu_torch.executor.scan import TableScan
    from tidb_tpu_torch.ops.runtime import resolve_device
    fact, dim = _fact_dim()
    g = [col(0, INT, "id")]
    aggs = [AggDesc(AggFunc.SUM, col(2, DEC, "amt"))]
    jagg = JAggregator(aggs, g)
    jagg.update(_run(jf, fact, dim, g, aggs, capacity=16384))
    want = sorted(tuple(k) + tuple(v) for k, v in jagg.results())

    pfact, pdim = port_chunk(fact), port_chunk(dim)
    fs = TableScan("fact", [(name, c.ft) for name, c in
                            zip(("id", "k", "amt", "q"), pfact.columns)])
    ds = TableScan("dim", [(name, c.ft) for name, c in
                           zip(("id", "grp", "w"), pdim.columns)])
    op = HashAgg(HashJoin(fs, ds, [fs.col("k")], [ds.col("id")]),
                 [convert.expr_from(x) for x in g],
                 [convert.agg_from(a) for a in aggs])
    ctx = ExecContext(resolve_device("cpu"), {"fact": [pfact],
                                              "dim": [pdim]})
    (chunk,) = op.chunks(ctx)
    assert sorted(_chunk_rows(chunk)) == want and len(want) > 4096
    st = ctx.stats
    assert st.join_paths == {"dim": "fused"}
    assert (st.escalations, st.fused_dispatches, st.fallbacks) == (1, 2, 0)


def test_avg_and_mixed_side_columns():
    fact, dim = _fact_dim()
    _both(fact, dim, [col(5, STR, "grp")],
          [AggDesc(AggFunc.AVG, col(2, DEC, "amt")),
           AggDesc(AggFunc.SUM, col(6, INT, "w")),
           AggDesc(AggFunc.COUNT, None)])


def test_scalar_agg_over_join():
    fact, dim = _fact_dim()
    got = _both(fact, dim, [], [AggDesc(AggFunc.COUNT, None),
                                AggDesc(AggFunc.SUM, col(2, DEC, "amt"))])
    assert got.keys == [()]


def test_many_to_many_regrow():
    """5000 probe rows x 100 build rows, all one key: 500,000 pairs, far
    past the first pair capacity; finalize regrows and stays exact."""
    n, nb = 5000, 100
    probe = Chunk([Column(INT, np.arange(n, dtype=np.int64),
                          np.ones(n, bool)),
                   Column(INT, np.ones(n, np.int64), np.ones(n, bool)),
                   Column(INT, np.arange(n, dtype=np.int64) % 7,
                          np.ones(n, bool))])
    build = Chunk([Column(INT, np.ones(nb, np.int64), np.ones(nb, bool)),
                   Column(INT, np.arange(nb, dtype=np.int64),
                          np.ones(nb, bool))])
    got = _both(probe, build, [], [AggDesc(AggFunc.COUNT, None),
                                   AggDesc(AggFunc.SUM, col(2, INT, "v"))])
    assert int(got.partials[0][0][0]) == 500000
    assert int(got.partials[1][0][0]) == 1499500


def test_first_row_rejects_in_both():
    g = [col(0, INT, "k")]
    agg = [AggDesc(fn=AggFunc.FIRST_ROW, arg=col(3, STR, "s"))]
    with pytest.raises(JReject):
        jf.ProbeAggKernel(1, 2, 4, g, agg)
    with pytest.raises(PReject):
        pf.ProbeAggKernel(1, 2, 4, [convert.expr_from(x) for x in g],
                          [convert.agg_from(a) for a in agg], device="cpu")
