"""The port's partitioned hybrid join and aggregation (ops/hybrid.py)
against the JAX package's, on the same seeded numpy inputs.

Routing runs on the host over `host_hash_keys`, so partition ids and
build/probe hashes must be bit-identical to the reference's; on a skewed
build both HybridJoinBuilds must lay out the same partitions, route
every probe batch into the same tasks, size the hot lane's pair
capacity the same, promote the same late-discovered hot key, and the
partitioned matcher must give the same (probe, build) pair sequences.
`partitioned_agg` and `agg_retry` must equal the reference's
GroupResults. All lanes are int64 (or float64 sums of small integers,
exact): tolerance 0.
"""

import numpy as np
import pytest
import torch

from test_torch_hashagg import assert_group_results_equal, port_chunk
from tidb_tpu import sqltypes as st
from tidb_tpu.chunk import Chunk, Column
from tidb_tpu.expression import AggDesc, AggFunc, col
from tidb_tpu.ops import hybrid as jhy
from tidb_tpu.ops import join as jj
from tidb_tpu.ops.hashagg import CapacityError as JCapacityError
from tidb_tpu.ops.hashagg import kernel_for as jkernel_for
from tidb_tpu.statistics import CMSketch as JCMSketch
from tidb_tpu.statistics import cm_key as jcm_key
from tidb_tpu_torch import convert
from tidb_tpu_torch.ops import hybrid as phy
from tidb_tpu_torch.ops import join as pj
from tidb_tpu_torch.ops.hashagg import CapacityError as PCapacityError
from tidb_tpu_torch.ops.hashagg import kernel_for as pkernel_for
from tidb_tpu_torch.statistics import CMSketch as PCMSketch
from tidb_tpu_torch.statistics import cm_key as pcm_key

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

INT = st.new_int_field()
DBL = st.new_double_field()


def test_partition_ids_and_hashes_bit_identical():
    rng = np.random.default_rng(21)
    h = rng.integers(-(1 << 63), (1 << 63) - 1, 10000, dtype=np.int64)
    for parts in (1, 3, 8, 16):
        np.testing.assert_array_equal(phy.partition_ids(h, parts),
                                      jhy.partition_ids(h, parts))
    n = 6000
    keys = [(rng.integers(-50, 50, n).astype(np.int64),
             rng.random(n) > 0.1),
            (rng.normal(size=n).round(1), rng.random(n) > 0.1)]
    keys[1][0][:20] = -0.0
    for side in ("build_hashes", "probe_hashes"):
        np.testing.assert_array_equal(getattr(phy, side)(keys, n),
                                      getattr(jhy, side)(keys, n))


def _skewed():
    """A build with one duplicated key (2000 rows) and a probe side where
    another key makes half of every batch."""
    rng = np.random.default_rng(9)
    nb, n = 8192, 6000
    key = np.arange(nb, dtype=np.int64)
    key[:2000] = 5
    bk = [(key, rng.random(nb) > 0.02)]
    cid = rng.integers(0, nb, n)
    cid[rng.random(n) < 0.5] = 4099
    pk = [(cid.astype(np.int64), rng.random(n) > 0.05)]
    return bk, pk, nb, n


def _pairs(hyb, kernel, pk, n):
    """route / ensure / dispatch / finalize by hand -> (probe, build)
    pairs in task order."""
    hp, tasks = hyb.route(pk, n)
    li_all, ri_all = [], []
    for p, idx in tasks:
        dev = hyb.ensure(p)
        rows = hyb.build_rows(p)
        sub = [(d[idx], v[idx]) for d, v in pk]
        cap = hyb.hot_out_cap(hp[idx]) if p == hyb.parts else None
        li, ri = kernel.finalize(kernel.dispatch(
            None, sub, len(rows), len(idx), out_cap=cap, build_dev=dev))
        li_all.append(idx[np.asarray(li)])
        ri_all.append(rows[np.asarray(ri)])
    return np.concatenate(li_all), np.concatenate(ri_all)


def test_skewed_build_layout_route_promote_match_reference():
    bk, pk, nb, n = _skewed()
    h = jhy.build_hashes(bk, nb)
    hot = jhy.detect_hot_hashes(h, threshold=1000)
    np.testing.assert_array_equal(phy.detect_hot_hashes(h, threshold=1000),
                                  hot)
    assert hot.size == 1
    jk, pk_ = jj.JoinKernel(1), pj.JoinKernel(1, device="cpu")
    jb = jhy.HybridJoinBuild(jk, bk, nb, parts=4, plan=object(),
                             hot_hashes=hot, threshold=1000, h=h)
    pb = phy.HybridJoinBuild(pk_, bk, nb, parts=4, hot_hashes=hot,
                             threshold=1000, h=h)
    try:
        for name in ("_order", "_bounds", "_hot_uniq", "_hot_cnt"):
            np.testing.assert_array_equal(getattr(pb, name),
                                          getattr(jb, name))
        jhp, jtasks = jb.route(pk, n)
        php, ptasks = pb.route(pk, n)
        np.testing.assert_array_equal(php, jhp)
        assert [p for p, _i in ptasks] == [p for p, _i in jtasks]
        for (_p, a), (_q, b) in zip(ptasks, jtasks):
            np.testing.assert_array_equal(a, b)
            assert pb.hot_out_cap(php[a]) == jb.hot_out_cap(jhp[b])
        # the probe side's hot key is found by the streaming sketch and
        # promoted in both
        jpro, ppro = jb.observe(jhp), pb.observe(php)
        np.testing.assert_array_equal(ppro, jpro)
        assert jpro is not None and jb.promote(jpro) and pb.promote(ppro)
        np.testing.assert_array_equal(pb._order, jb._order)
        np.testing.assert_array_equal(pb.hot, jb.hot)
        jl, jr = _pairs(jb, jk, pk, n)
        pl, pr = _pairs(pb, pk_, pk, n)
        np.testing.assert_array_equal(pl, jl)
        np.testing.assert_array_equal(pr, jr)
        assert pb.hot_rows == jb.hot_rows > 0
    finally:
        jb.close()
        pb.close()
    # against the host matcher: the same pair set
    hl, hr = jj.host_match_pairs(bk, pk, nb, n)
    assert set(zip(pl.tolist(), pr.tolist())) == \
        set(zip(hl.tolist(), hr.tolist()))


def test_residency_pin_evict():
    bk, _pk, nb, _n = _skewed()
    pb = phy.HybridJoinBuild(pj.JoinKernel(1, device="cpu"), bk, nb,
                             parts=4, threshold=0)
    dev = pb.ensure(1)
    assert pb.ensure(1) is dev                # resident: no re-upload
    pb.pin(1)
    pb.evict(1)                               # pinned: parked, still held
    assert pb._zombies[1] == [dev] and 1 not in pb._resident
    pb.unpin(1)
    assert not pb._zombies                    # unpinned: retired
    assert pb.ensure(1) is not dev            # evicted: uploads again
    pb.close()


def test_cms_seeded_hot_set_matches_reference():
    rng = np.random.default_rng(9)
    nb, n = 4096, 6000
    bk = [(np.arange(nb, dtype=np.int64), np.ones(nb, bool))]
    cid = rng.integers(0, nb, n)
    cid[rng.random(n) < 0.5] = 99
    jc, pc = JCMSketch(), PCMSketch()
    for v, c in zip(*np.unique(cid, return_counts=True)):
        assert pcm_key(int(v)) == jcm_key(int(v))
        jc.insert(jcm_key(int(v)), int(c))
        pc.insert(pcm_key(int(v)), int(c))
    np.testing.assert_array_equal(pc.table, jc.table)
    h = jhy.build_hashes(bk, nb)
    want = jhy.detect_hot_hashes(h, 1000, raw_key=bk[0], probe_cms=jc)
    got = phy.detect_hot_hashes(h, 1000, raw_key=bk[0], probe_cms=pc)
    assert want.size >= 1
    np.testing.assert_array_equal(got, want)


def _agg_chunk(case):
    rng = np.random.default_rng(11)
    k, valid = {
        "highcard": (rng.integers(0, 9000, 50000), None),
        "onekey": (np.full(4096, 3), None),
        "nulls": (rng.integers(0, 500, 8192), rng.random(8192) > 0.25),
        "pow2": (rng.integers(0, 6000, 16384), None)}[case]
    n = len(k)
    return Chunk([Column(INT, np.asarray(k, np.int64),
                         valid if valid is not None else np.ones(n, bool)),
                  Column(DBL, np.arange(n, dtype=np.float64),
                         np.ones(n, bool))])


AGGS = [AggDesc(fn=AggFunc.COUNT, arg=None),
        AggDesc(fn=AggFunc.SUM, arg=col(1, DBL, "amt"))]
GROUP = [col(0, INT, "k")]


@pytest.mark.parametrize("case", ["highcard", "onekey", "nulls", "pow2"])
def test_partitioned_agg_matches_reference(case):
    chunk = _agg_chunk(case)
    want = jhy.partitioned_agg(chunk, None, GROUP, AGGS, object(), parts=4)
    got = phy.partitioned_agg(port_chunk(chunk), None,
                              [convert.expr_from(g) for g in GROUP],
                              [convert.agg_from(a) for a in AGGS],
                              parts=4, device="cpu")
    assert got.keys == want.keys           # partition order, then groups
    assert_group_results_equal(got, want)


def test_agg_retry_from_real_capacity_error():
    chunk = _agg_chunk("highcard")
    pchunk = port_chunk(chunk)
    pg = [convert.expr_from(g) for g in GROUP]
    pa = [convert.agg_from(a) for a in AGGS]
    with pytest.raises(JCapacityError) as je:
        jkernel_for(None, GROUP, AGGS, capacity=64)(chunk)
    with pytest.raises(PCapacityError) as pe:
        pkernel_for(None, pg, pa, capacity=64, device="cpu")(pchunk)
    assert pe.value.needed == je.value.needed
    want = jhy.agg_retry(chunk, None, GROUP, AGGS, object(), je.value)
    got = phy.agg_retry(pchunk, None, pg, pa, pe.value, device="cpu")
    assert_group_results_equal(got, want)
    assert phy.escalated_capacity(pe.value.needed) == \
        jhy.escalated_capacity(je.value.needed)
