"""The device plane's fault handling in the port's coprocessor against the
JAX package's, under the same failpoints on the same TPC-H data (SF 0.01,
seed 42) in both stores.

Each statement is one Q1 cop request over lineitem's 4 regions on one
fan-out thread, under a memtrack statement root and a runtime-stats
collector, in each package in turn (the JAX planner's CopPlan, carried
across with convert.cop_plan_from). Under each failpoint both packages
return the same per-frame partial aggregates as a run with none armed,
and count the same fallbacks under the same reasons (`fault`,
`quarantine`):

  * `device/dispatch` once: the retry serves it on the device, no
    fallback;
  * `device/dispatch` persistently: the retry faults again, the
    statement degrades to the host path (`fault` on every task);
  * `hbm/fill` persistently over a warm host cache: the same chain;
  * three such statements: the device is quarantined and its HBM blocks
    shed — the port's hbm-cache ledger stays at 0, where the reference's
    retry of the quarantining fault re-fills one block (a fault of the
    reference, ROADMAP §C) — the next statement serves on the host under
    `quarantine`; past the window the probe readmits the device and the
    next run refills HBM and hits it again;
  * the dispatch watchdog at 120 ms against a 400 ms `device/finalize`
    delay raises the retryable DispatchTimeoutError in both, and the
    replay with the delay disarmed is clean.
"""

import contextlib
import time

import pytest
import torch

from test_torch_hashagg import assert_group_results_equal
from tidb_tpu import config as jconfig
from tidb_tpu import memtrack as jmemtrack
from tidb_tpu import metrics as jmetrics
from tidb_tpu import runtime_stats as jrs
from tidb_tpu import sched as jsched
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.kv import CopRequest as JCopRequest
from tidb_tpu.kv import KVRange as JKVRange
from tidb_tpu.kv import ReqType as JReqType
from tidb_tpu.session import Session
from tidb_tpu.store import copr as jcopr
from tidb_tpu.store import device_cache as jdc
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu.util import failpoint as jfailpoint
from tidb_tpu_torch import codec, convert, tablecodec
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import memtrack as pmemtrack
from tidb_tpu_torch import metrics as pmetrics
from tidb_tpu_torch import runtime_stats as prs
from tidb_tpu_torch import sched as psched
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.kv import CopRequest as PCopRequest
from tidb_tpu_torch.kv import KVRange as PKVRange
from tidb_tpu_torch.kv import ReqType as PReqType
from tidb_tpu_torch.ops.hashagg import HashAggregator
from tidb_tpu_torch.store import device_cache as pdc
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage
from tidb_tpu_torch.util import failpoint as pfailpoint

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

SF, SEED = 0.01, 42
FAILPOINTS = (jfailpoint, pfailpoint)


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


@contextlib.contextmanager
def armed(name, spec):
    """`name` armed with `spec` in both packages' failpoint registries."""
    for fp in FAILPOINTS:
        fp.enable(name, spec)
    try:
        yield
    finally:
        for fp in FAILPOINTS:
            fp.disable(name)


@pytest.fixture(scope="module")
def stores():
    """(jax storage, port storage, jax Q1 CopPlan, port Q1 CopPlan)."""
    js = jnew_storage()
    s = Session(js)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    jtpch.load(s, js, jtpch.ScaledTpch(SF, SEED))
    ps = pnew_storage(device="cpu")
    ptpch.load_store(ps, ptpch.ScaledTpch(SF, SEED))
    seen = []
    orig = jcopr.exec_cop_plan

    def spy(plan, chunk, *a, **k):
        seen.append(plan)
        return orig(plan, chunk, *a, **k)

    jcopr.exec_cop_plan = spy
    try:
        s.query(jtpch.Q1)
    finally:
        jcopr.exec_cop_plan = orig
    with sysvars(tidb_tpu_device_min_rows=1, tidb_tpu_cop_concurrency=1):
        yield js, ps, seen[0], convert.cop_plan_from(seen[0])
    s.close()
    js.close()
    ps.close()


@pytest.fixture
def fresh(stores):
    """Empty caches and fresh schedulers/health in both packages."""
    js, ps, _jp, _pp = stores
    for st in (js, ps):
        st.chunk_cache.clear()
        st.device_cache.shed()
    for sched in (jsched, psched):
        sched.reset_for_tests()
    yield stores
    for fp in FAILPOINTS:
        fp.disable_all()
    for sched in (jsched, psched):
        sched.reset_for_tests()


def _fallbacks(metrics) -> dict:
    """tidb_tpu_device_fallback_total by reason, summed over operators."""
    key = metrics.DEVICE_FALLBACKS
    out: dict = {}
    for k, v in metrics.snapshot().items():
        if k.startswith(key):
            reason = k.split('reason="')[1].split('"')[0]
            out[reason] = out.get(reason, 0) + v
    return out


def _statement(storage, plan, jax: bool):
    """One cop request as a statement -> (partials, {reason: fallbacks
    it counted}, degraded)."""
    lo = tablecodec.record_prefix(plan.table.id)
    rng = (lo, codec.prefix_next(lo))
    mt, rs, metrics = (jmemtrack, jrs, jmetrics) if jax else \
        (pmemtrack, prs, pmetrics)
    before = _fallbacks(metrics)
    if jax:
        req = JCopRequest(tp=JReqType.DAG, ranges=[JKVRange(*rng)],
                          plan=plan, start_ts=storage.current_ts())
    else:
        req = PCopRequest(tp=PReqType.DAG, ranges=[PKVRange(*rng)],
                          plan=plan, start_ts=storage.current_ts())
    root = mt.statement_root(None, label="q1")
    coll = rs.StatsCollector()
    try:
        with mt.tracking(root), rs.collecting(coll):
            out = [r.chunk for r in storage.client().send(req)]
    finally:
        root.detach()
    after = _fallbacks(metrics)
    counted = {k: after[k] - before.get(k, 0) for k in after
               if after[k] != before.get(k, 0)}
    if not jax:     # the port's collector counts what the metric counts
        st = coll.get(plan)
        assert (dict(st.fallback_reasons) if st else {}) == counted
    return out, counted, root.fault_degraded


def _both(stores):
    """The statement in each package -> (port partials, jax fallbacks,
    port fallbacks, (jax degraded, port degraded)), partials held
    equal."""
    js, ps, jplan, pplan = stores
    j, jfb, jdeg = _statement(js, jplan, True)
    p, pfb, pdeg = _statement(ps, pplan, False)
    assert len(p) == len(j)
    for pg, jg in zip(p, j):
        assert_group_results_equal(pg, jg)
    return p, jfb, pfb, (jdeg, pdeg)


def _rows(pplan, partials):
    agg = HashAggregator(pplan.aggs, pplan.group_exprs)
    for gr in partials:
        agg.update(gr)
    return [tuple(k) + tuple(v) for k, v in agg.results()]


def _truth():
    return ptpch.q1_truth(ptpch.ScaledTpch(SF, SEED))


def test_single_dispatch_fault_retries_on_the_device(fresh):
    with armed("device/dispatch", "1*raise(DeviceFaultError)"):
        p, jfb, pfb, degraded = _both(fresh)
    assert _rows(fresh[3], p) == _truth()
    assert pfb == jfb == {}
    assert degraded == (False, False)
    assert psched.device_health().snapshot()["faults"] == \
        jsched.device_health().snapshot()["faults"] == 1


def test_persistent_dispatch_fault_degrades_the_statement(fresh):
    with armed("device/dispatch", "raise(DeviceFaultError)"):
        p, jfb, pfb, degraded = _both(fresh)
    assert _rows(fresh[3], p) == _truth()
    assert pfb == jfb and set(pfb) == {"fault"} and pfb["fault"] > 0
    assert degraded == (True, True)
    assert psched.device_health().snapshot() == \
        jsched.device_health().snapshot() == {
            "quarantined": False, "consecutive_faults": 2, "faults": 2,
            "quarantines": 0}


def test_hbm_fill_fault_is_absorbed(fresh):
    _both(fresh)                         # warm the host chunk cache
    with armed("hbm/fill", "raise(DeviceFaultError)"):
        p, jfb, pfb, degraded = _both(fresh)
    assert _rows(fresh[3], p) == _truth()
    assert pfb == jfb and degraded[0] == degraded[1]
    assert len(fresh[1].device_cache) == len(fresh[0].device_cache) == 0


def test_three_faulting_statements_quarantine_then_readmit(fresh,
                                                          monkeypatch):
    js, ps, _jp, _pp = fresh
    # the probe window opens only when the test rewinds it: a statement
    # of either package may take longer than the default 1 s window
    for sched in (jsched, psched):
        monkeypatch.setattr(sched, "_QUARANTINE_S", 600.0)
    for _ in range(2):                   # cold, then the HBM fills
        _both(fresh)
    assert len(ps.device_cache) == len(js.device_cache) == 4
    assert pdc.tracker().device > 0
    with armed("device/dispatch", "raise(DeviceFaultError)"):
        for _ in range(3):
            p, jfb, pfb, _deg = _both(fresh)
            assert _rows(fresh[3], p) == _truth()
            assert pfb == jfb
        jh = jsched.device_health().snapshot()
        ph = psched.device_health().snapshot()
        assert ph["quarantined"] and jh["quarantined"]
        assert ph["quarantines"] == jh["quarantines"] == 1
        # quarantine shed every resident block; the reference retries the
        # quarantining fault, which re-fills one block (ROADMAP §C), the
        # port does not retry it
        assert pdc.tracker().device == 0 and len(ps.device_cache) == 0
        assert len(js.device_cache) == 1 and jdc.tracker().device > 0
        # while quarantined, statements skip the device: `quarantine`
        p, jfb, pfb, _deg = _both(fresh)
        assert _rows(fresh[3], p) == _truth()
        assert pfb == jfb and set(pfb) == {"quarantine"}
    # past the window the probe dispatch readmits the device; the next
    # statements refill the HBM blocks and hit them
    for sched in (jsched, psched):
        sched.device_health()._probe_at = time.monotonic() - 0.01
    for _ in range(2):
        p, jfb, pfb, _deg = _both(fresh)
        assert _rows(fresh[3], p) == _truth()
        assert pfb == jfb == {}
    assert not psched.device_health().snapshot()["quarantined"]
    assert not jsched.device_health().snapshot()["quarantined"]
    assert len(ps.device_cache) == len(js.device_cache) == 4
    assert pdc.tracker().device > 0


def test_watchdog_times_out_a_slow_finalize(fresh):
    js, ps, jplan, pplan = fresh
    want = _rows(pplan, _both(fresh)[0])
    with sysvars(tidb_tpu_dispatch_timeout_ms=120), \
            armed("device/finalize", "delay(400)"):
        for storage, plan, jax, fp in ((js, jplan, True, jfailpoint),
                                       (ps, pplan, False, pfailpoint)):
            with pytest.raises(fp.DispatchTimeoutError) as ei:
                _statement(storage, plan, jax)
            assert "watchdog" in str(ei.value)
    assert psched.dispatch_watchdog().snapshot()["fired"] >= 1
    assert jsched.dispatch_watchdog().snapshot()["fired"] >= 1
    # the replay, disarmed, is clean; no slot or device byte is left
    p, jfb, pfb, _deg = _both(fresh)
    assert _rows(pplan, p) == want == _truth()
    assert pfb == jfb == {}
    assert psched.device_scheduler().snapshot()["inflight"] == 0
    assert pmemtrack.SERVER.device == pdc.tracker().device
