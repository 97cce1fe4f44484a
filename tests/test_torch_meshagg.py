"""The port's plane aggregation (ops/meshagg.MeshAggKernel) against the JAX
package's, on the reference's 8-device CPU mesh and the port's 8-shard
CPU plane.

The same seeded numpy chunk goes through both kernels; their GroupResults
must be equal: keys, counts and int64 lanes bit-exact, float64 lanes
within 1e-9 relative (the shards' sums are added in another order). The
cases cover the direct merge (dict-encoded string keys), the hashed merge
(int keys, through the runtime-selected table, and computed keys through
the packed sort), a filter, every aggregate, NULLs, an empty chunk and a
no-group aggregate; a 1-shard plane must give the single-device kernel's
results; CapacityError must fire at the same capacity with the same
`needed`, on both plane sizes, and CollisionError on the same keys.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_hashagg import port_chunk
from tidb_tpu.chunk import Chunk, Column
from tidb_tpu.devplane import build_mesh as j_build_mesh
from tidb_tpu.expression import AggDesc, AggFunc
from tidb_tpu.expression.core import Op, col, const, func
from tidb_tpu.ops import meshagg as jm
from tidb_tpu.ops.hashagg import CapacityError as JCapacityError
from tidb_tpu.sqltypes import (new_decimal_field, new_double_field,
                               new_int_field, new_string_field)
from tidb_tpu_torch import convert, devplane
from tidb_tpu_torch.ops import hashagg as ph
from tidb_tpu_torch.ops import meshagg as pm

torch.set_num_threads(1)

INT = new_int_field()
DBL = new_double_field()
DEC = new_decimal_field(frac=2)
STR = new_string_field(32)

G, X, Y, D, S = (col(0, INT, "g"), col(1, INT, "x"), col(2, DBL, "y"),
                 col(3, DEC, "d"), col(4, STR, "s"))
ALL_AGGS = [AggDesc(AggFunc.COUNT, None), AggDesc(AggFunc.SUM, X),
            AggDesc(AggFunc.AVG, Y), AggDesc(AggFunc.MIN, X),
            AggDesc(AggFunc.MAX, Y), AggDesc(AggFunc.SUM, D),
            AggDesc(AggFunc.FIRST_ROW, G), AggDesc(AggFunc.FIRST_ROW, S)]


def make_chunk(n: int, groups: int = 37, seed: int = 0) -> Chunk:
    rng = np.random.default_rng(seed)
    g = rng.integers(0, groups, n).astype(np.int64)
    return Chunk([
        Column(INT, g, rng.random(n) > 0.05),
        Column(INT, rng.integers(-1000, 1000, n).astype(np.int64),
               rng.random(n) > 0.1),
        Column(DBL, rng.normal(size=n) * 1e3),
        Column(DEC, rng.integers(-10**9, 10**9, n).astype(np.int64),
               rng.random(n) > 0.02),
        Column(STR, np.array([f"name-{v}" for v in g % 7], dtype=object),
               rng.random(n) > 0.03)])


def _same(a, b):
    if isinstance(a, (float, np.floating)) or isinstance(b, (float,
                                                             np.floating)):
        return float(a) == pytest.approx(float(b), rel=1e-9, abs=0)
    if isinstance(a, np.generic):
        a = a.item()
    if isinstance(b, np.generic):
        b = b.item()
    return a == b


def assert_same(pg, jg):
    pk = {k: i for i, k in enumerate(pg.keys)}
    jk = {k: i for i, k in enumerate(jg.keys)}
    assert set(pk) == set(jk)
    for key, ji in jk.items():
        pi = pk[key]
        assert int(pg.counts[pi]) == int(jg.counts[ji]), key
        for p_lanes, j_lanes in zip(pg.partials, jg.partials):
            assert len(p_lanes) == len(j_lanes)
            for pl, jl in zip(p_lanes, j_lanes):
                assert _same(pl[pi], jl[ji]), (key, pl[pi], jl[ji])


def kernels(ndev, filter_expr, group_exprs, aggs, capacity):
    jk = jm.MeshAggKernel(j_build_mesh(ndev), filter_expr, group_exprs,
                          aggs, capacity=capacity)
    pk = pm.MeshAggKernel(devplane.build_mesh(ndev, device="cpu"),
                          convert.expr_from(filter_expr),
                          [convert.expr_from(g) for g in group_exprs],
                          [convert.agg_from(a) for a in aggs],
                          capacity=capacity)
    return jk, pk


FLT = func(Op.GT, X, const(-500))

CASES = {
    # dict-encoded string key: the direct merge over [ndev, C]
    "direct": (None, [S], ALL_AGGS, 64),
    "direct_filtered": (FLT, [S], ALL_AGGS[:5], 64),
    # bare int keys: the runtime-selected table, the hashed merge
    "cond_int": (FLT, [G], ALL_AGGS, 256),
    "cond_two_keys": (None, [S, G], ALL_AGGS[:3], 512),
    # a computed key: the packed sort, the hashed merge
    "hash_expr": (FLT, [func(Op.PLUS, G, const(1))], ALL_AGGS, 256),
    "float_key": (None, [Y], [AggDesc(AggFunc.COUNT, None)], 8192),
    # no group: one slot
    "scalar": (None, [], [AggDesc(AggFunc.COUNT, None),
                          AggDesc(AggFunc.SUM, X)], 8),
}


@pytest.mark.parametrize("ndev", [8, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_reference(case, ndev):
    flt, groups, aggs, cap = CASES[case]
    ch = make_chunk(3000, seed=len(case))
    jk, pk = kernels(ndev, flt, groups, aggs, cap)
    assert_same(pk(port_chunk(ch)), jk(ch))


def test_one_shard_is_the_single_device_kernel():
    """A 1-shard plane reduces to the single-device kernel: the same
    groups, counts and lanes as ops/hashagg.HashAggKernel."""
    ch = port_chunk(make_chunk(2000, seed=3))
    groups = [convert.expr_from(G)]
    aggs = [convert.agg_from(a) for a in ALL_AGGS[:6]]
    flt = convert.expr_from(FLT)
    plane = pm.MeshAggKernel(devplane.build_mesh(1, device="cpu"), flt,
                             groups, aggs, capacity=256)(ch)
    single = ph.HashAggKernel(flt, groups, aggs, capacity=256,
                              device="cpu")(ch)
    assert plane.keys == single.keys
    assert plane.counts.tolist() == single.counts.tolist()
    for a, b in zip(plane.partials, single.partials):
        for la, lb in zip(a, b):
            assert np.asarray(la).tolist() == np.asarray(lb).tolist()


def test_empty_and_all_filtered():
    for rows, flt in ((0, None), (500, func(Op.GT, X, const(10**6)))):
        ch = make_chunk(rows, seed=5)
        jk, pk = kernels(8, flt, [G], ALL_AGGS[:3], 64)
        jg, pg = jk(ch), pk(port_chunk(ch))
        assert pg.keys == jg.keys == []


@pytest.mark.parametrize("ndev", [8, 1])
@pytest.mark.parametrize("groups,capacity", [(40, 32), (40, 64),
                                             (4096, 64), (4096, 8192)])
def test_capacity_error_at_same_capacity(ndev, groups, capacity):
    n = 4096
    ch = Chunk([Column(INT, np.arange(n, dtype=np.int64) % groups),
                Column(INT, np.ones(n, dtype=np.int64))])
    jk, pk = kernels(ndev, None, [G], [AggDesc(AggFunc.COUNT, None)],
                     capacity)
    try:
        jg = jk(ch)
    except JCapacityError as e:
        with pytest.raises(ph.CapacityError) as pe:
            pk(port_chunk(ch))
        assert pe.value.needed == e.needed
        return
    assert_same(pk(port_chunk(ch)), jg)


def test_shards_on_one_device_copy_nothing():
    """A plane's collectives on shards that share a device hand back one
    object per device: the gather is not copied per shard."""
    plane = devplane.build_mesh(4, device="cpu")
    xs = [torch.full((3,), i, dtype=torch.int64) for i in range(4)]
    g = devplane.all_gather(xs, plane)
    assert all(t is g[0] for t in g)
    assert g[0].tolist() == [[i] * 3 for i in range(4)]
    assert devplane.all_gather(xs, plane, tiled=True)[0].shape == (12,)
    assert int(devplane.pmax([x.sum() for x in xs], plane)[2]) == 9
    blocks = [torch.arange(8, dtype=torch.int64).reshape(4, 2) + 10 * i
              for i in range(4)]
    out = devplane.all_to_all(blocks, plane)
    # shard j holds row j of every shard's block, in shard order
    assert out[1].tolist() == [[2, 3], [12, 13], [22, 23], [32, 33]]


def test_collision_error_in_both(monkeypatch):
    """A group hash that maps every key to one value (the check hash
    left as it is) makes distinct keys share a slot: CollisionError in
    both packages' finalize."""
    from tidb_tpu.ops.hashagg import CollisionError as JCollisionError
    real_j, real_p = jm._hash_keys, pm._hash_keys

    def j_hash(xp, key_cols, n, seed):
        h = real_j(xp, key_cols, n, seed)
        return h * 0 + 12345 if seed == pm._SEED1 else h

    def p_hash(key_cols, n, seed, device):
        h = real_p(key_cols, n, seed, device)
        return h * 0 + 12345 if seed == pm._SEED1 else h
    monkeypatch.setattr(jm, "_hash_keys", j_hash)
    monkeypatch.setattr(pm, "_hash_keys", p_hash)
    ch = make_chunk(2000, seed=9)
    expr = func(Op.PLUS, G, const(1))      # the packed-sort table
    jk, pk = kernels(8, None, [expr], [AggDesc(AggFunc.COUNT, None)], 64)
    with pytest.raises(JCollisionError):
        jk(ch)
    with pytest.raises(ph.CollisionError):
        pk(port_chunk(ch))
