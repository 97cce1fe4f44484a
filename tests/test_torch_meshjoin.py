"""The port's plane lookup-aggregate (ops/meshjoin.MeshLookupAggKernel)
against the JAX package's, on the reference's 8-device CPU mesh and the
port's 8-shard CPU plane (and on 1-shard planes).

The same seeded probe and dimension chunks go through both kernels, Q3's
shape (one lookup) and Q5's (a two-hop chain with a string payload as
group key); GroupResults equal, int64 lanes bit-exact, float64 within
1e-9 relative. `_BuildTable` hashes and packs its slots bit-identically,
and `BuildError` and `CapacityError` fire on the same inputs at the same
capacities. The host implementation `host_lookup_agg` agrees too.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_hashagg import port_chunk
from tests.test_torch_meshagg import assert_same
from tidb_tpu.chunk import Chunk, Column
from tidb_tpu.devplane import build_mesh as j_build_mesh
from tidb_tpu.expression import AggDesc, AggFunc
from tidb_tpu.expression.core import Op, col, const, func
from tidb_tpu.ops import meshjoin as jj
from tidb_tpu.ops.hashagg import CapacityError as JCapacityError
from tidb_tpu.sqltypes import new_double_field, new_int_field, new_string_field
from tidb_tpu_torch import convert, devplane
from tidb_tpu_torch.ops import hashagg as ph
from tidb_tpu_torch.ops import meshjoin as pj

torch.set_num_threads(1)

INT = new_int_field()
DBL = new_double_field()
STR = new_string_field()


def star(n=4000, dims=60, nations=7, seed=5):
    """probe (dim key, price, date), dim (key, nation key, dim attr),
    nation (key, name)."""
    rng = np.random.default_rng(seed)
    probe = Chunk([
        Column(INT, rng.integers(0, dims + 10, n).astype(np.int64),
               rng.random(n) > 0.03),
        Column(DBL, rng.uniform(0, 100, n)),
        Column(INT, rng.integers(0, 3650, n).astype(np.int64))])
    dim = Chunk([
        Column(INT, np.arange(dims, dtype=np.int64)),
        Column(INT, np.arange(dims, dtype=np.int64) % nations),
        Column(INT, np.arange(dims, dtype=np.int64) % 5)])
    nation = Chunk([
        Column(INT, np.arange(nations, dtype=np.int64)),
        Column(STR, np.array([f"nation{i}" for i in range(nations)],
                             dtype=object))])
    return probe, dim, nation


def specs(pkg, probe, dim, nation, two_hops):
    mk = pkg.LookupSpec
    cv = (lambda e: e) if pkg is jj else convert.expr_from
    ch = (lambda c: c) if pkg is jj else port_chunk
    out = [mk(key_exprs=[cv(col(0, INT))], build_chunk=ch(dim),
              build_key_offsets=[0], payload_offsets=[1, 2])]
    if two_hops:
        # virtual schema: probe 0..2, dim payloads 3 (nation key), 4
        out.append(mk(key_exprs=[cv(col(3, INT))], build_chunk=ch(nation),
                      build_key_offsets=[0], payload_offsets=[1]))
    return out


def run_both(ndev, flt, two_hops, groups, aggs, capacity=64, data=None):
    probe, dim, nation = data or star()
    jk = jj.MeshLookupAggKernel(j_build_mesh(ndev), flt,
                                specs(jj, probe, dim, nation, two_hops),
                                groups, aggs, capacity=capacity)
    pk = pj.MeshLookupAggKernel(
        devplane.build_mesh(ndev, device="cpu"), convert.expr_from(flt),
        specs(pj, probe, dim, nation, two_hops),
        [convert.expr_from(g) for g in groups],
        [convert.agg_from(a) for a in aggs], capacity=capacity)
    return jk, pk, probe


AGGS = [AggDesc(AggFunc.SUM, col(1, DBL)), AggDesc(AggFunc.COUNT, None),
        AggDesc(AggFunc.MAX, col(2, INT)), AggDesc(AggFunc.AVG, col(1, DBL)),
        AggDesc(AggFunc.FIRST_ROW, col(2, INT))]


@pytest.mark.parametrize("ndev", [8, 1])
@pytest.mark.parametrize("shape", ["q3", "q5"])
def test_lookup_agg_matches_reference(shape, ndev):
    flt = func(Op.LT, col(2, INT), const(1800))
    if shape == "q3":
        groups = [col(4, INT)]
    else:
        groups = [col(5, STR)]    # the second hop's string payload
    jk, pk, probe = run_both(ndev, flt, shape == "q5", groups, AGGS)
    pg = pk(port_chunk(probe))
    assert_same(pg, jk(probe))
    # the host implementation gives the same groups
    hg = pj.host_lookup_agg(port_chunk(probe), pk.filter_expr, pk.lookups,
                            pk.group_exprs, pk.aggs)
    assert sorted(hg.keys) == sorted(pg.keys)


def test_build_table_bit_identical():
    _probe, dim, _nation = star(dims=5000)
    spec_j = jj.LookupSpec(key_exprs=[col(0, INT)], build_chunk=dim,
                           build_key_offsets=[0, 1], payload_offsets=[2])
    spec_p = pj.LookupSpec(key_exprs=[convert.expr_from(col(0, INT))],
                           build_chunk=port_chunk(dim),
                           build_key_offsets=[0, 1], payload_offsets=[2])
    bj, bp = jj._BuildTable(spec_j), pj._BuildTable(spec_p)
    assert bp.slot_pack.tolist() == bj.slot_pack.tolist()
    assert (bp.probe_depth, bp.table_size, bp.hash_quantum_bits) == \
        (bj.probe_depth, bj.table_size, bj.hash_quantum_bits)
    for a, b in zip(bp.key_bits, bj.key_bits):
        assert a.view(np.uint64).tolist() == \
            np.asarray(b).view(np.uint64).tolist()


def test_duplicate_build_keys_raise_in_both():
    dup = Chunk([Column(INT, np.array([1, 2, 2, 3], dtype=np.int64)),
                 Column(INT, np.arange(4, dtype=np.int64))])
    with pytest.raises(jj.BuildError):
        jj._BuildTable(jj.LookupSpec([col(0, INT)], dup, [0], [1]))
    with pytest.raises(pj.BuildError):
        pj._BuildTable(pj.LookupSpec([convert.expr_from(col(0, INT))],
                                     port_chunk(dup), [0], [1]))


@pytest.mark.parametrize("capacity", [2, 4, 8])
def test_capacity_error_at_same_capacity(capacity):
    """q3's groups are the 5 values of the dimension attribute: capacity
    2 and 4 overflow in both packages, 8 fits in both."""
    jk, pk, probe = run_both(8, None, False, [col(4, INT)], AGGS[:2],
                             capacity=capacity)
    try:
        jg = jk(probe)
    except JCapacityError as e:
        with pytest.raises(ph.CapacityError) as pe:
            pk(port_chunk(probe))
        assert pe.value.needed == e.needed
        return
    assert_same(pk(port_chunk(probe)), jg)
