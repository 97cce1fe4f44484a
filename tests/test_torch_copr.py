"""The port's coprocessor (store/copr.py, store/stream.py) against the JAX
package's, over the same TPC-H data at SF 0.01 in both stores.

The JAX package loads ScaledTpch through its DDL and bulk loader; the
port loads the same generator with `tpch.load_store` (the KV bytes are
identical, tests/test_torch_codec.py). The pushed plans are the ones the
JAX planner builds, captured from `exec_cop_plan` while its session runs
the SQL, and carried across with `convert.cop_plan_from`. Each package's
`CopClient.send` then runs the same request on one fan-out thread, so
region partials arrive in range order:

  * Q1 streamed (1 MiB frames, several per region) cold, then warm (the
    chunk cache hits and the HBM block fills), then hot (the block hits),
    then materialized cold and warm: the per-frame and per-region partial
    GroupResults are equal, int64 lanes exactly;
  * a string filter (l_returnflag = 'R') takes `_encoded_agg` in both,
    cold and over a resident block, with equal partials;
  * fallbacks are counted under the same reasons: `encoding` (a LIKE the
    code space cannot carry), `unsupported` (MAX over a string),
    `capacity` and `collision` (a kernel whose finalize raises the miss,
    with the radix retry off).
"""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_hashagg import assert_group_results_equal
from tidb_tpu import config as jconfig
from tidb_tpu import metrics as jmetrics
from tidb_tpu import runtime_stats as jrs
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.expression import AggDesc as JAggDesc
from tidb_tpu.expression import AggFunc as JAggFunc
from tidb_tpu.kv import CopRequest as JCopRequest
from tidb_tpu.kv import KVRange as JKVRange
from tidb_tpu.kv import ReqType as JReqType
from tidb_tpu.ops import hashagg as jhashagg
from tidb_tpu.ops import runtime as jruntime
from tidb_tpu.session import Session
from tidb_tpu.store import copr as jcopr
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import convert
from tidb_tpu_torch import metrics as pmetrics
from tidb_tpu_torch import runtime_stats as prs
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.kv import CopRequest as PCopRequest
from tidb_tpu_torch.kv import KVRange as PKVRange
from tidb_tpu_torch.kv import ReqType as PReqType
from tidb_tpu_torch.ops import hashagg as phashagg
from tidb_tpu_torch.ops import runtime as pruntime
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

SF, SEED = 0.01, 42
CUTOFF = "DATE '1998-12-01' - INTERVAL '90' DAY"
SQL = {
    "q1": jtpch.Q1,
    "encoded": "SELECT l_linestatus, SUM(l_quantity), COUNT(*) FROM "
               "lineitem WHERE l_returnflag = 'R' AND l_shipdate <= "
               f"{CUTOFF} GROUP BY l_linestatus",
    "like": "SELECT l_linestatus, SUM(l_extendedprice) FROM lineitem "
            "WHERE l_returnflag LIKE 'R%' GROUP BY l_linestatus",
}


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
def stores():
    """(jax session, jax storage, port storage, {name: jax CopPlan})."""
    js = jnew_storage()
    s = Session(js)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    jtpch.load(s, js, jtpch.ScaledTpch(SF, SEED))
    ps = pnew_storage(device="cpu")
    ptpch.load_store(ps, ptpch.ScaledTpch(SF, SEED))
    plans = {}
    orig = jcopr.exec_cop_plan

    def spy(plan, chunk, *a, **k):
        seen.append(plan)
        return orig(plan, chunk, *a, **k)

    jcopr.exec_cop_plan = spy
    try:
        for name, sql in SQL.items():
            seen = []
            s.query(sql)
            plans[name] = seen[0]
    finally:
        jcopr.exec_cop_plan = orig
    with sysvars(tidb_tpu_device_min_rows=1):
        yield s, js, ps, plans
    s.close()
    js.close()
    ps.close()


def _fresh(storage):
    storage.chunk_cache.clear()
    storage.device_cache.shed()


def _send(storage, plan, jax: bool, device_time: bool = False):
    """One request over the plan's table on one fan-out thread -> (the
    partials in range order, the plan's OpStats). `device_time` makes
    the collector time the dispatches (runtime_stats.device_section)."""
    from tidb_tpu_torch import codec, tablecodec
    lo = tablecodec.record_prefix(plan.table.id)
    hi = codec.prefix_next(lo)
    if jax:
        req = JCopRequest(tp=JReqType.DAG, ranges=[JKVRange(lo, hi)],
                          plan=plan, start_ts=storage.current_ts(),
                          concurrency=1)
        coll = jrs.StatsCollector(device=device_time)
        with jrs.collecting(coll):
            out = [r.chunk for r in storage.client().send(req)]
    else:
        req = PCopRequest(tp=PReqType.DAG, ranges=[PKVRange(lo, hi)],
                          plan=plan, start_ts=storage.current_ts(),
                          concurrency=1)
        coll = prs.StatsCollector(device=device_time)
        with prs.collecting(coll):
            out = [r.chunk for r in storage.client().send(req)]
    return out, coll.get(plan)


def _both(stores, name, jplan=None):
    _s, js, ps, plans = stores
    jplan = jplan or plans[name]
    pplan = convert.cop_plan_from(jplan)
    j, jst = _send(js, jplan, True)
    p, pst = _send(ps, pplan, False)
    assert len(p) == len(j)
    for pg, jg in zip(p, j):
        assert_group_results_equal(pg, jg)
    return p, jst, pst


@pytest.mark.parametrize("device_time", [False, True])
def test_device_section_times_dispatches(stores, device_time):
    """A collector made with device=True takes the dispatches' time on
    the plan's node in both packages (the port's by the host clock on a
    CPU tensor, by a CUDA event pair on the card); without it, none."""
    _s, js, ps, plans = stores
    jplan = plans["q1"]
    pplan = convert.cop_plan_from(jplan)
    _j, jst = _send(js, jplan, True, device_time)
    _p, pst = _send(ps, pplan, False, device_time)
    assert (jst.device_time_ns > 0) == device_time
    assert (pst.device_time_ns > 0) == device_time
    assert pst.cop_tasks == jst.cop_tasks


def test_q1_plan_is_the_planners(stores):
    """The CopPlan run_q1_store builds equals the JAX planner's."""
    jplan = stores[3]["q1"]
    port = ptpch.q1_cop_plan(ptpch.table_infos()["lineitem"])
    assert [c.to_json() for c in port.cols] == \
        [c.to_json() for c in jplan.cols]
    assert port.table.to_json() == jplan.table.to_json()
    assert pruntime.plan_fingerprint(port.filter, port.group_exprs,
                                     port.aggs) == \
        jruntime.plan_fingerprint(jplan.filter, jplan.group_exprs,
                                  jplan.aggs)


def test_q1_partials_cold_warm_streamed_and_materialized(stores):
    _s, js, ps, _plans = stores
    _fresh(js)
    _fresh(ps)
    with sysvars(tidb_tpu_copr_stream=1,
                 tidb_tpu_copr_stream_frame_bytes=1 << 20):
        cold, _j, _p = _both(stores, "q1")
        assert len(cold) > 4                    # several frames a region
        warm, _j, pst = _both(stores, "q1")     # host hit, HBM fill
        assert len(warm) == 4 and len(ps.device_cache) == 4
        assert pst.encoding == "direct-agg"
        hot, _j, _p = _both(stores, "q1")       # HBM hit
        assert len(hot) == 4
    _fresh(js)
    _fresh(ps)
    with sysvars(tidb_tpu_copr_stream=0):
        mat, _j, _p = _both(stores, "q1")       # materialized cold
        assert len(mat) == 4
        again, _j, _p = _both(stores, "q1")
        assert len(again) == 4


def test_encoded_string_filter(stores):
    _s, js, ps, _plans = stores
    for _ in range(3):          # cold, block fill, block hit
        _p, jst, pst = _both(stores, "encoded")
        assert pst.encoding == jst.encoding
        assert pst.mode == jst.mode
        assert pst.fallbacks == jst.fallbacks == 0
    assert pst.encoding in ("encoded", "direct-agg")


def _fallbacks(metrics) -> dict:
    key = metrics.DEVICE_FALLBACKS
    return {k: v for k, v in metrics.snapshot().items() if k.startswith(key)}


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _fallback_run(stores, name, jplan=None):
    jb, pb = _fallbacks(jmetrics), _fallbacks(pmetrics)
    _p, jst, pst = _both(stores, name, jplan)
    jd = _delta(jb, _fallbacks(jmetrics))
    pd = _delta(pb, _fallbacks(pmetrics))
    assert pd == jd
    assert pst.fallbacks == jst.fallbacks
    assert pst.fallback_reasons == {
        r: n for r, n in ((k.split('reason="')[1].rstrip('"}'), v)
                          for k, v in pd.items())}
    return pd


def test_encoding_fallback(stores):
    got = _fallback_run(stores, "like")
    assert list(got) == ['tidb_tpu_device_fallback_total{op="CopPlan",'
                         'reason="encoding"}']


def test_unsupported_fallback(stores):
    from tidb_tpu.expression import col
    jq1 = stores[3]["q1"]
    flag = jq1.cols[7]
    jplan = type(jq1)(table=jq1.table, cols=jq1.cols, filter=jq1.filter,
                      group_exprs=jq1.group_exprs,
                      aggs=[JAggDesc(JAggFunc.MAX, col(7, flag.ft, flag.name),
                                     name="max_flag")])
    got = _fallback_run(stores, None, jplan)
    assert set(got) == {'tidb_tpu_device_fallback_total{op="CopPlan",'
                        'reason="unsupported"}'}


@pytest.mark.parametrize("reason", ["capacity", "collision"])
def test_miss_fallbacks(stores, reason, monkeypatch):
    def raising(pkg):
        def finalize(self, chunk, pending):
            if reason == "collision":
                raise pkg.CollisionError("injected")
            err = pkg.CapacityError("injected")
            err.needed = 1 << 40            # hopeless: no escalation
            raise err
        return finalize

    for pkg in (jhashagg, phashagg):
        monkeypatch.setattr(pkg.HashAggKernel, "finalize", raising(pkg))
    with sysvars(tidb_tpu_join_partitions=0):
        got = _fallback_run(stores, "q1")
    assert set(got) == {'tidb_tpu_device_fallback_total{op="CopPlan",'
                        f'reason="{reason}"}}'}
    assert sum(got.values()) >= 4           # every region on the host


def test_run_q1_store_equals_truth(stores):
    """run_q1_store over the same store: rows equal the numpy truth
    cold (streamed) and warm, and each statement's ledger ends at 0."""
    from tidb_tpu_torch.executor.agg import run_q1_store
    ps = stores[2]
    _fresh(ps)
    truth = ptpch.q1_truth(ptpch.ScaledTpch(SF, SEED))
    for _ in range(3):
        res = run_q1_store(device="cpu", storage=ps)
        assert res.rows == truth
        assert res.stats.mem_left == 0 and res.stats.mem_peak > 0
        assert not res.stats.fallbacks
    assert np.all([len(g.keys) == 6 for g in res.partials])
