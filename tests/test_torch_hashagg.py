"""The port's HashAggKernel / ScalarAggKernel / HashAggregator against the
JAX package's, on the cases of tests/test_ops_agg.py.

Every case builds its chunk and plan with the JAX package, carries both
into the port (`convert.chunk_from_arrays`, `expr_from`, `agg_from`),
runs both kernels (the port's on the CPU), and requires equal
GroupResults and equal merged results: int64 lanes exactly, float64
lanes at rtol 1e-12 (sums may be taken in another order). CapacityError
must fire at the same capacity, the degrade-to-hash step past
tidb_tpu_direct_agg_slots must match, and `_hash_keys` must be
bit-identical.
"""

import decimal
import random

import numpy as np
import pytest
import torch

from tidb_tpu import config as jconfig
from tidb_tpu import sqltypes as st
from tidb_tpu.chunk import Chunk, Column
from tidb_tpu.expression import AggDesc, AggFunc, Op, col, const, func
from tidb_tpu.ops import hashagg as jh
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import convert
from tidb_tpu_torch.executor.agg import run_agg
from tidb_tpu_torch.ops import hashagg as ph

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

INT = st.new_int_field()
DBL = st.new_double_field()
DEC2 = st.new_decimal_field(frac=2)
STR = st.new_string_field()


def port_chunk(ch):
    return convert.chunk_from_arrays(
        [(c.ft.tp, c.ft.flen, c.ft.frac, c.ft.collation, c.data, c.valid)
         for c in ch.columns])


def _val_eq(a, b):
    if isinstance(a, (float, np.floating)) or isinstance(b, (float,
                                                             np.floating)):
        if a is None or b is None:
            return a is b
        return float(a) == pytest.approx(float(b), rel=1e-12, abs=0) or \
            (np.isnan(float(a)) and np.isnan(float(b)))
    return a == b


def assert_group_results_equal(pg, jg):
    pk = {k: i for i, k in enumerate(pg.keys)}
    jk = {k: i for i, k in enumerate(jg.keys)}
    assert set(pk) == set(jk)
    for key, ji in jk.items():
        pi = pk[key]
        assert int(pg.counts[pi]) == int(jg.counts[ji]), key
        for plan_lanes, ref_lanes in zip(pg.partials, jg.partials):
            assert len(plan_lanes) == len(ref_lanes)
            for pl_, rl in zip(plan_lanes, ref_lanes):
                assert _val_eq(pl_[pi], rl[ji]), (key, pl_[pi], rl[ji])


def assert_results_equal(pres, jres):
    assert [k for k, _ in pres] == [k for k, _ in jres]
    for (_k, pv), (_k2, jv) in zip(pres, jres):
        assert len(pv) == len(jv)
        for a, b in zip(pv, jv):
            assert _val_eq(a, b), (pv, jv)


def both(chunks, filter_expr, group_exprs, aggs, capacity=4096):
    """Run the JAX kernel and the port's over the same chunks; compare
    every GroupResult and the merged results. -> port results."""
    if group_exprs:
        jk = jh.HashAggKernel(filter_expr, group_exprs, aggs,
                              capacity=capacity)
        pk = ph.HashAggKernel(convert.expr_from(filter_expr),
                              [convert.expr_from(g) for g in group_exprs],
                              [convert.agg_from(a) for a in aggs],
                              capacity=capacity, device="cpu")
    else:
        jk = jh.ScalarAggKernel(filter_expr, aggs)
        pk = ph.ScalarAggKernel(convert.expr_from(filter_expr),
                                [convert.agg_from(a) for a in aggs],
                                device="cpu")
    jagg = jh.HashAggregator(aggs, group_exprs)
    pagg = ph.HashAggregator(pk.aggs, pk.group_exprs
                             if group_exprs else None)
    for ch in chunks:
        jg = jk(ch)
        pg = pk(port_chunk(ch))
        assert_group_results_equal(pg, jg)
        jagg.update(jg)
        pagg.update(pg)
    assert_results_equal(pagg.results(), jagg.results())
    return pagg.results()


def test_sum_count_by_int_key():
    rng = random.Random(1)
    rows = [(rng.randrange(5), rng.randrange(100)) for _ in range(3000)]
    res = both([Chunk.from_rows([INT, INT], rows)], None, [col(0, INT)],
               [AggDesc(AggFunc.SUM, col(1, INT)),
                AggDesc(AggFunc.COUNT, None)])
    assert len(res) == 5


def test_filter_and_group_with_nulls():
    rows = [(1, 10), (1, None), (2, 5), (None, 7), (2, 3), (1, 2)]
    res = both([Chunk.from_rows([INT, INT], rows)], col(1, INT).ge(3),
               [col(0, INT)],
               [AggDesc(AggFunc.SUM, col(1, INT)),
                AggDesc(AggFunc.COUNT, None),
                AggDesc(AggFunc.MIN, col(1, INT)),
                AggDesc(AggFunc.MAX, col(1, INT))])
    assert dict(res)[(None,)] == [7, 1, 7, 7]


def test_string_group_key():
    rows = [("aa", 1), ("bb", 2), ("aa", 3), (None, 4), ("cc", 5), ("bb", 6)]
    res = both([Chunk.from_rows([STR, INT], rows)], None, [col(0, STR)],
               [AggDesc(AggFunc.SUM, col(1, INT))])
    assert {k[0]: v[0] for k, v in res} == {"aa": 4, "bb": 8, "cc": 5,
                                            None: 4}


def test_multi_chunk_merge():
    rng = random.Random(2)
    chunks = [Chunk.from_rows([INT, INT], [(rng.randrange(3),
                                            rng.randrange(1000))
                                           for _ in range(500)])
              for _ in range(4)]
    both(chunks, None, [col(0, INT)],
         [AggDesc(AggFunc.SUM, col(1, INT)),
          AggDesc(AggFunc.AVG, col(1, DBL)),
          AggDesc(AggFunc.MIN, col(1, INT))])


def test_decimal_sum_avg():
    rows = [(1, decimal.Decimal("1.50")), (1, decimal.Decimal("2.25")),
            (2, decimal.Decimal("-0.75")), (1, None)]
    res = both([Chunk.from_rows([INT, DEC2], rows)], None, [col(0, INT)],
               [AggDesc(AggFunc.SUM, col(1, DEC2)),
                AggDesc(AggFunc.AVG, col(1, DEC2))])
    assert dict(res)[(1,)] == [375, 1_875_000]


def test_avg_sum_real():
    rows = [(1, 1.5), (1, 2.5), (2, None)]
    res = both([Chunk.from_rows([INT, DBL], rows)], None, [col(0, INT)],
               [AggDesc(AggFunc.SUM, col(1, DBL)),
                AggDesc(AggFunc.AVG, col(1, DBL)),
                AggDesc(AggFunc.COUNT, col(1, DBL))])
    assert dict(res)[(2,)] == [None, None, 0]


def test_expression_group_key():
    rows = [(i, i * 10) for i in range(100)]
    res = both([Chunk.from_rows([INT, INT], rows)], None,
               [func(Op.MOD, col(0, INT), const(3))],
               [AggDesc(AggFunc.COUNT, None)])
    assert {k[0]: v[0] for k, v in res} == {0: 34, 1: 33, 2: 33}


def test_scalar_agg():
    rows = [(i, float(i)) for i in range(1000)]
    res = both([Chunk.from_rows([INT, DBL], rows)], col(0, INT).lt(500), [],
               [AggDesc(AggFunc.SUM, col(0, INT)),
                AggDesc(AggFunc.COUNT, None),
                AggDesc(AggFunc.MAX, col(1, DBL))])
    assert res == [((), [sum(range(500)), 500, 499.0])]


def test_first_row():
    rows = [(1, "x"), (2, "y"), (1, "z")]
    res = both([Chunk.from_rows([INT, STR], rows)], None, [col(0, INT)],
               [AggDesc(AggFunc.FIRST_ROW, col(1, STR))])
    assert {k[0]: v[0] for k, v in res} == {1: "x", 2: "y"}


@pytest.mark.parametrize("capacity,raises", [(64, True), (256, False)])
def test_capacity_overflow_detected(capacity, raises):
    """CapacityError fires at the same capacity in both packages."""
    ch = Chunk.from_rows([INT], [(i,) for i in range(200)])
    aggs = [AggDesc(AggFunc.COUNT, None)]
    jk = jh.HashAggKernel(None, [col(0, INT)], aggs, capacity=capacity)
    pk = ph.HashAggKernel(None, [convert.expr_from(col(0, INT))],
                          [convert.agg_from(a) for a in aggs],
                          capacity=capacity, device="cpu")
    if raises:
        with pytest.raises(jh.CapacityError) as je:
            jk(ch)
        with pytest.raises(ph.CapacityError) as pe:
            pk(port_chunk(ch))
        assert pe.value.needed == je.value.needed
    else:
        assert_group_results_equal(pk(port_chunk(ch)), jk(ch))


def test_device_safety_validation():
    cases = [
        (func(Op.LIKE, col(0, STR), extra="%x%"), [col(1, INT)],
         [AggDesc(AggFunc.COUNT, None)]),
        (None, [func(Op.UPPER, col(0, STR))],
         [AggDesc(AggFunc.COUNT, None)]),
        (None, [col(1, INT)], [AggDesc(AggFunc.MIN, col(0, STR))]),
    ]
    for f, g, a in cases:
        with pytest.raises(ValueError):
            jh.HashAggKernel(f, g, a)
        with pytest.raises(ph.DeviceRejectError):
            ph.HashAggKernel(convert.expr_from(f),
                             [convert.expr_from(x) for x in g],
                             [convert.agg_from(x) for x in a],
                             device="cpu")


def test_empty_chunk_and_no_match_filter():
    res = both([Chunk.from_rows([INT, INT], [(1, 2)])], col(1, INT).gt(100),
               [col(0, INT)], [AggDesc(AggFunc.SUM, col(1, INT))])
    assert res == []


def test_run_agg_replans_capacity_overflow():
    """>capacity distinct groups: the port's driver re-plans the kernel
    once with a larger table (the JAX package's _escalated_kernel) and
    keeps the device path; results equal the JAX kernel at that size."""
    n, ngroups = 6000, 5000
    ch = Chunk.from_rows([INT, INT], [(i % ngroups, i) for i in range(n)])
    aggs = [AggDesc(AggFunc.SUM, col(1, INT))]
    res, stats = run_agg([port_chunk(ch)], None,
                         [convert.expr_from(col(0, INT))],
                         [convert.agg_from(a) for a in aggs], device="cpu")
    assert stats.escalations == 1 and stats.fallbacks == 0
    assert stats.device_batches == 1
    assert len(res) == ngroups
    jagg = jh.HashAggregator(aggs, [col(0, INT)])
    jagg.update(jh.HashAggKernel(None, [col(0, INT)], aggs,
                                 capacity=16384)(ch))
    assert_results_equal(res, jagg.results())


def test_collision_runs_host_path_and_counts(monkeypatch):
    """A CollisionError sends that batch to the host path, counted as a
    fallback; the rows stay right."""
    rng = np.random.default_rng(4)
    ch = Chunk.from_arrays([INT, INT], [rng.integers(0, 9, 5000),
                                        rng.integers(0, 100, 5000)])
    aggs = [AggDesc(AggFunc.SUM, col(1, INT)), AggDesc(AggFunc.COUNT, None)]

    def collide(self, chunk, pending):
        raise ph.CollisionError("forced")
    monkeypatch.setattr(ph.HashAggKernel, "finalize", collide)
    res, stats = run_agg([port_chunk(ch)], None,
                         [convert.expr_from(col(0, INT))],
                         [convert.agg_from(a) for a in aggs], device="cpu")
    assert stats.fallbacks == 1 and stats.device_batches == 0
    jagg = jh.HashAggregator(aggs, [col(0, INT)])
    jagg.update(jh.HashAggKernel(None, [col(0, INT)], aggs)(ch))
    assert_results_equal(res, jagg.results())


def test_cond_direct_wide_span_takes_hash_branch():
    n = 64
    keys = np.where(np.arange(n) % 2 == 0, -(2 ** 62), 2 ** 62)
    ch = Chunk([Column(INT, keys.astype(np.int64), np.ones(n, bool)),
                Column(INT, np.ones(n, dtype=np.int64), np.ones(n, bool))])
    both([ch], None, [col(0, INT, "k")],
         [AggDesc(AggFunc.SUM, col(1, INT))], capacity=64)


def test_degrade_to_hash_past_direct_agg_slots():
    """A direct-mode (string-key) group-by whose capacity crosses
    tidb_tpu_direct_agg_slots is rebuilt on the packed-sort hash path in
    both packages, with the same results."""
    rng = np.random.default_rng(9)
    words = np.array([f"w{i}" for i in range(40)], dtype=object)
    ch = Chunk.from_arrays([STR, INT], [words[rng.integers(0, 40, 3000)],
                                        rng.integers(-50, 50, 3000)])
    aggs = [AggDesc(AggFunc.SUM, col(1, INT)), AggDesc(AggFunc.COUNT, None)]
    g = [col(0, STR)]
    pg = [convert.expr_from(col(0, STR))]
    pa = [convert.agg_from(a) for a in aggs]
    with jconfig.session_overlay({"tidb_tpu_direct_agg_slots": 64}), \
            pconfig.session_overlay({"tidb_tpu_direct_agg_slots": 64}):
        for cap, hashed in ((64, False), (128, True)):
            jk = jh.kernel_for(None, g, aggs, capacity=cap)
            pk = ph.kernel_for(None, pg, pa, capacity=cap, device="cpu")
            assert jk.force_hash == pk.force_hash == hashed
            assert jk.direct_limit == pk.direct_limit == 64
            assert_group_results_equal(pk(port_chunk(ch)), jk(ch))


@pytest.mark.parametrize("kind", ["int", "float", "multi"])
def test_hash_keys_bit_identical(kind):
    rng = np.random.default_rng(17)
    n = 1000
    if kind == "int":
        lanes = [(rng.integers(-(1 << 62), 1 << 62, n), rng.random(n) > 0.1)]
    elif kind == "float":
        d = rng.normal(size=n)
        d[::7] = 0.0
        d[3::7] = -0.0
        lanes = [(d, rng.random(n) > 0.1)]
    else:
        lanes = [(rng.integers(0, 5, n), rng.random(n) > 0.2),
                 (rng.normal(size=n), np.ones(n, bool)),
                 (rng.integers(-3, 3, n), rng.random(n) > 0.5)]
    for seed in (0x517CC1B727220A95, 0x2545F4914F6CDD1D):
        want = jh._hash_keys(np, lanes, n, seed=seed)
        got = ph._hash_keys([(torch.from_numpy(d), torch.from_numpy(v))
                             for d, v in lanes], n, seed, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_cond_direct_wrapped_codes_stay_in_table():
    """Two int keys whose span product passes 2^63: the runtime-selected
    table takes the hash branch, and the direct branch the port also
    computes (torch has no lax.cond) wraps its int64 codes negative; its
    scatter must stay inside the table instead of indexing out of it (a
    device assert on CUDA). The smallest input that showed it."""
    k1 = np.array([0, 1 << 31, 5], np.int64)
    k2 = np.array([0, 1 << 32, 7], np.int64)
    ch = Chunk([Column(INT, k1, np.ones(3, bool)),
                Column(INT, k2, np.ones(3, bool)),
                Column(INT, np.array([1, 2, 3], np.int64), np.ones(3, bool))])
    both([ch], None, [col(0, INT, "a"), col(1, INT, "b")],
         [AggDesc(AggFunc.SUM, col(2, INT))])
