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
from tidb_tpu import memtrack as jmemtrack
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
from tidb_tpu_torch import memtrack as pmemtrack
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
    assert [d for d, _nbytes in pb._zombies[1]] == [dev] and \
        1 not in pb._resident
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


# -- under a statement memory quota ----------------------------------------


def _resident_build(mod, memtrack, kernel, plan):
    """A 4-partition HybridJoinBuild over the skewed build, billed to
    `plan`'s node of the active root, with every partition resident."""
    bk, _pk, nb, _n = _skewed()
    h = mod.build_hashes(bk, nb)
    hot = mod.detect_hot_hashes(h, threshold=1000)
    kw = {"plan": plan}
    hyb = mod.HybridJoinBuild(kernel, bk, nb, parts=4, hot_hashes=hot,
                              threshold=1000, h=h, **kw)
    for p in range(hyb.parts + 1):
        if hyb.part_rows(p):
            hyb.ensure(p)
    return hyb


@pytest.mark.parametrize("pinned", [(), (2,)])
def test_quota_spill_sheds_the_same_partitions(pinned):
    """Over the quota, the spill action sheds every resident cold
    partition but the active one, the pinned ones and the hot lane, in
    both packages: the same partitions, the same bytes back."""
    out = {}
    for name, mod, memtrack, kernel in (
            ("jax", jhy, jmemtrack, jj.JoinKernel(1)),
            ("port", phy, pmemtrack, pj.JoinKernel(1, device="cpu"))):
        plan = object()
        root = memtrack.statement_root(None, label="q")
        with memtrack.tracking(root):
            hyb = _resident_build(mod, memtrack, kernel, plan)
            for p in pinned:
                hyb.pin(p)
            held = root.total()
            root.quota = held + 10
            assert hyb.want_immediate(1) and not hyb.under_pressure()
            root.node(plan).consume(host=100)        # crosses the quota
            out[name] = (sorted(hyb._resident), hyb.spilled,
                         hyb.under_pressure(),
                         [hyb.want_immediate(p) for p in range(5)],
                         held - root.total())
            for p in pinned:
                hyb.unpin(p)
            hyb.close()
            root.node(plan).release(host=100)
        assert root.total() == 0
    assert out["port"] == out["jax"]
    resident, spilled, pressure, _want, _freed = out["port"]
    assert spilled >= 2 and pressure and resident[-1] == 4


def test_nothing_sheddable_raises_in_both():
    for mod, memtrack, kernel in (
            (jhy, jmemtrack, jj.JoinKernel(1)),
            (phy, pmemtrack, pj.JoinKernel(1, device="cpu"))):
        bk, _pk, nb, _n = _skewed()
        plan = object()
        root = memtrack.statement_root(None, label="q", quota=1000)
        with memtrack.tracking(root):
            # the build's own gathered copy is over the quota: no action
            # is registered yet, so the statement cancels
            with pytest.raises(memtrack.QuotaExceededError):
                mod.HybridJoinBuild(kernel, bk, nb, parts=4, plan=plan)
        assert root.total() == 0


@pytest.fixture(scope="module")
def join_session():
    """A JAX-package session with a probe table p (4,000 rows, four
    superchunks of 1,024) and a build table b (40,000 rows: its resident
    partitions are most of the device ledger)."""
    from tidb_tpu.session import Session
    from tidb_tpu.store.storage import new_mock_storage
    from tidb_tpu.table import Table, bulkload
    s = Session(new_mock_storage())
    s.execute("CREATE DATABASE d")
    s.execute("USE d")
    s.execute("CREATE TABLE p (id BIGINT PRIMARY KEY, k BIGINT, y BIGINT)")
    s.execute("CREATE TABLE b (id BIGINT PRIMARY KEY, k BIGINT, x BIGINT)")
    rng = np.random.default_rng(13)
    info = s.domain.info_schema()
    for name, n, hi in (("p", 4000, 20000), ("b", 40000, 20000)):
        bulkload.bulk_load(s.storage, Table(info.table("d", name),
                                            s.storage), {
            "id": np.arange(n, dtype=np.int64),
            "k": rng.integers(0, hi, n),
            "y" if name == "p" else "x": rng.integers(0, 100, n)})
    yield s
    s.close()


def _join_runs(sess, quota, monkeypatch):
    """The reference's HashJoinExec and the port's HashJoin over the same
    chunks under one quota: -> {package: (rows, partitions the spill
    counter counted, bytes left on the root, the root)}, with the port's
    run stats. The reference's storage layer (its readers' decode
    buffers) bills nodes of its own, off the statement: the port has no
    storage layer, and with it off the two ledgers move in step."""
    from tidb_tpu import config as jconfig
    from tidb_tpu import metrics as jmetrics
    from tidb_tpu.executor import ExecContext as JExecContext
    from tidb_tpu.executor import build_executor
    from tidb_tpu.plan import physical as jph
    from tidb_tpu_torch import config as pconfig
    from tidb_tpu_torch import metrics as pmetrics
    from tidb_tpu_torch.executor import ExecContext, ExecStats
    from tidb_tpu_torch.executor.join import HashJoin
    from tidb_tpu_torch.executor.scan import TableScan
    node = jmemtrack.MemTracker.node

    def off_statement(self, plan, name=None):
        if isinstance(plan, jph.PhysTableReader) or \
                type(plan).__name__ == "CopPlan":
            return jmemtrack.MemTracker("storage")
        return node(self, plan, name)
    monkeypatch.setattr(jmemtrack.MemTracker, "node", off_statement)
    overlay = {"tidb_tpu_superchunk_rows": 1024,
               "tidb_tpu_join_partitions": 4}
    plan = sess.plan("SELECT * FROM p JOIN b ON p.k = b.k")
    while not isinstance(plan, jph.PhysHashJoin):
        plan = plan.children[0]
    key = "tidb_tpu_join_spill_partitions_total"

    def ctx():
        return JExecContext(sess.storage, sess._read_ts(), None)
    out = {}
    root = jmemtrack.statement_root(None, quota=quota)
    before = jmetrics.snapshot().get(key, 0)
    with jconfig.session_overlay(overlay), jmemtrack.tracking(root):
        rows = []
        for ch in build_executor(plan).chunks(ctx()):
            rows.extend(ch.to_pylist())
        sides = [list(build_executor(c).chunks(ctx()))
                 for c in plan.children]
    out["jax"] = (rows, jmetrics.snapshot().get(key, 0) - before,
                  root.total(), root)

    def scan(name, child):
        return TableScan(name, [(c.name, convert.field_type(
            c.ft.tp, c.ft.flen, c.ft.frac, c.ft.collation))
            for c in child.schema.cols])
    left, right = (scan(t, c) for t, c in zip("pb", plan.children))
    join = HashJoin(left, right,
                    [convert.expr_from(k) for k in plan.left_keys],
                    [convert.expr_from(k) for k in plan.right_keys])
    tables = {t: [port_chunk(c) for c in chs] for t, chs in zip("pb", sides)}
    pctx = ExecContext(torch.device("cpu"), tables, ExecStats())
    root = pmemtrack.statement_root(None, quota=quota)
    before = pmetrics.snapshot().get(key, 0)
    with pconfig.session_overlay(overlay), pmemtrack.tracking(root):
        rows = []
        for ch in join.chunks(pctx):
            rows.extend(ch.to_pylist())
    out["port"] = (rows, pmetrics.snapshot().get(key, 0) - before,
                   root.total(), root)
    return out, pctx.stats


def test_quota_stages_and_drains_the_reference_pairs(join_session,
                                                     monkeypatch):
    """Under a quota the hybrid probe of both packages spills build
    partitions, stages the later probe rows bound for them and drains
    them partition by partition: the joined rows come out in the same
    sequence, the spill counters agree, and the ledgers end at 0. The
    quota sits a quarter of the device bytes below the peak an
    unreachable quota's run reached, as chip_smoke.py sets it for Q3."""
    free, _stats = _join_runs(join_session, 1 << 40, monkeypatch)
    assert free["port"][0] == free["jax"][0]
    proot = free["port"][3]
    quota = proot.total_peak - proot.device_at_peak // 4
    got, stats = _join_runs(join_session, quota, monkeypatch)
    prows, pspill, pleft, _r = got["port"]
    jrows, jspill, jleft, _r = got["jax"]
    assert prows == jrows
    assert sorted(prows) == sorted(free["jax"][0])
    assert pspill == jspill == stats.spilled_partitions > 0
    assert stats.staged_probe_rows == stats.drained_probe_rows > 0
    assert pleft == jleft == 0


def test_partition_spans_on_the_statement_trace():
    """Each hybrid build partition's upload and each partition of the
    partitioned agg is one `join.partition` span under the statement's
    trace, as in the reference."""
    from tidb_tpu_torch import trace
    bk, _pk, nb, _n = _skewed()
    pb = phy.HybridJoinBuild(pj.JoinKernel(1, device="cpu"), bk, nb,
                             parts=4, threshold=0)
    root = trace.begin("statement")
    try:
        pb.ensure(1)
        pb.ensure(1)                          # resident: no second span
    finally:
        trace.end(root)
        pb.close()
    (up,) = root.children
    assert (up.name, up.tags["partition"], up.tags["upload"]) == \
        ("join.partition", 1, 1)
    rng = np.random.default_rng(5)
    n = 5000
    ch = Chunk([Column(INT, rng.integers(0, 3000, n).astype(np.int64),
                       np.ones(n, bool)),
                Column(INT, rng.integers(0, 100, n).astype(np.int64),
                       np.ones(n, bool))])
    pch = port_chunk(ch)
    aggs = [AggDesc(AggFunc.SUM, col(1, INT))]
    root = trace.begin("statement")
    try:
        phy.partitioned_agg(pch, None, [convert.expr_from(col(0, INT))],
                            [convert.agg_from(a) for a in aggs], parts=4,
                            device="cpu")
    finally:
        trace.end(root)
    spans = [c for c in root.children if c.name == "join.partition"]
    assert len(spans) == 4 and all(c.tags["rows"] for c in spans)
    assert sum(c.tags["rows"] for c in spans) == n
    assert trace.validate(root) == []
