"""The port's tenant meter (tidb_tpu_torch/meter.py) against the JAX
package's (tidb_tpu/meter.py), case by case on the same inputs: the
statement -> session -> user -> SERVER rollup, unattributed work on the
SERVER node, metering()/suspended() nesting, busy sections that never
bill a nanosecond twice, pipeline_map's device/host split of its tokens,
and the interval roll with the per-digest fold. Exact counts are equal
in both packages; wall-clock intervals are held to the same bounds.
Then the coprocessor: Q1 from the port's store under a statement meter
credits every pool and stream worker's dispatch bytes and device time to
that statement."""

import time

import pytest
import torch

from tidb_tpu import meter as jmeter
from tidb_tpu.ops import runtime as jruntime
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import meter as pmeter
from tidb_tpu_torch.ops import runtime as pruntime

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

PKGS = {"jax": (jmeter, jruntime), "port": (pmeter, pruntime)}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    meter, runtime = PKGS[request.param]
    meter.reset_for_tests()
    yield meter, runtime
    meter.reset_for_tests()


def _rollup(meter):
    sm = meter.session_meter(7001, "alice")
    stmt = meter.statement_meter(sm)
    stmt.add(device_ns=1000, rows_sent=5)
    stmt.add(host_fallback_ns=300, slot_wait_ns=20)
    user = [u for u in meter.users_snapshot() if u["user"] == "alice"][0]
    return (stmt.totals(), sm.totals(), user["device_ns"],
            user["host_fallback_ns"], meter.SERVER.totals())


def _unattributed(meter):
    meter.session_meter(7002, "bob")
    meter.note_device(500)         # no meter installed on this thread
    return meter.SERVER.totals()["device_ns"], meter.attributed_device_ns()


def _metering(meter):
    sm = meter.session_meter(7003, "carol")
    with meter.metering(sm):
        meter.note_device(100)
        with meter.suspended():
            meter.note_device(40)   # internal work: SERVER only
        with meter.metering(None):  # None nests transparently
            meter.note_device(60)
    return sm.totals()["device_ns"], meter.SERVER.totals()["device_ns"]


def _digest_fold(meter):
    sm = meter.session_meter(7004, "dave")
    out = []
    for ns in (900, 100):
        stmt = meter.statement_meter(sm)
        stmt.add(device_ns=ns, statements=1)
        meter.finish_statement(stmt, "digest-x", "SELECT ?")
        meter.roll_interval()
        snap = [s for s in meter.sessions_snapshot()
                if s["session_id"] == 7004][0]
        out.append((snap["interval"]["device_ns"], snap["device_ns"]))
    top = meter.top_digests()[0]
    return out, (top["digest"], top["device_ns"], top["statements"])


@pytest.mark.parametrize("case", [_rollup, _unattributed, _metering,
                                  _digest_fold])
def test_exact_counts_equal_the_references(case):
    got = {}
    for name, (meter, _rt) in PKGS.items():
        meter.reset_for_tests()
        try:
            got[name] = case(meter)
        finally:
            meter.reset_for_tests()
    assert got["port"] == got["jax"]


def test_busy_sections_never_double_count(pkg):
    """Nested busy intervals bill each nanosecond once, the inner
    classification winning: never more than the outer wall interval."""
    meter, _rt = pkg
    sm = meter.session_meter(7005, "erin")
    t0 = time.perf_counter_ns()
    with meter.metering(sm):
        with meter.busy_section("device"):
            time.sleep(0.002)
            with meter.busy_section("device"):   # a nested retry
                time.sleep(0.002)
            meter.note_host_fallback(1_000_000)  # a degraded slice
    wall = time.perf_counter_ns() - t0
    tot = sm.totals()
    assert tot["host_fallback_ns"] == 1_000_000
    assert tot["device_ns"] > 0
    assert tot["device_ns"] + tot["host_fallback_ns"] <= wall


def test_pipeline_map_classifies_host_tokens(pkg):
    """None and ("host", ...) tokens are host-path items, any other
    token device work: both ledgers fill, results stay in order."""
    meter, runtime = pkg
    sm = meter.session_meter(7006, "frank")

    def dispatch(it):
        return ("host", it, 0) if it % 2 else object()

    with meter.metering(sm):
        out = list(runtime.pipeline_map([0, 1, 2, 3], dispatch,
                                        lambda it, tok: it, depth=2))
    assert out == [0, 1, 2, 3]
    tot = sm.totals()
    assert tot["device_ns"] > 0 and tot["host_fallback_ns"] > 0


def test_store_workers_credit_the_issuing_statement():
    """Q1 from the store fans out over 4 regions on worker threads,
    streamed and materialized: the statement meter installed on the
    issuing thread takes every dispatch byte the SERVER node gained, and
    device time."""
    from tidb_tpu_torch.executor.agg import run_q1_store
    pmeter.reset_for_tests()
    stmt = pmeter.statement_meter(pmeter.session_meter(7007, "gina"))
    with pconfig.session_overlay({"tidb_tpu_device_min_rows": 1}):
        with pmeter.metering(stmt):
            res = run_q1_store(sf=0.002, seed=7, device="cpu")
        try:
            for stream in (1, 0):
                with pconfig.session_overlay(
                        {"tidb_tpu_copr_stream": stream}), \
                        pmeter.metering(stmt):
                    run_q1_store(device="cpu", storage=res.storage)
        finally:
            res.storage.close()
    mine, server = stmt.totals(), pmeter.SERVER.totals()
    assert 0 < mine["device_ns"] <= server["device_ns"]
    assert 0 < mine["bytes_encoded"] == server["bytes_encoded"]
    pmeter.reset_for_tests()
