"""The port's device plane (tidb_tpu_torch/sched.py, util/supervisor.py)
against the JAX package's, case by case with the same calls in both:

  * DeviceScheduler: the slot cap and release, the scheduler off as a
    no-op, the bytes gate over the SERVER device ledger with its
    min-progress pass, the bypass valve, and pipeline_map handing every
    slot back when its consumer abandons it or the window is one slot;
  * DeviceHealth: three consecutive faults quarantine the device and
    shed every HBM-resident block (the hbm-cache ledger at 0), the probe
    window admits one dispatch, its success readmits; degrade_statement
    latches the statement root;
  * DispatchWatchdog: off by default with no monitor thread; at
    tidb_tpu_dispatch_timeout_ms = 120 a 400 ms section raises the
    retryable DispatchTimeoutError and cancel-latches its statement;
  * supervisor.run_once restarts a crashing job with counted restarts
    and gives up after its retries; supervise restarts a crashing beat;
  * the port's one deviation: pipelines nested on one thread (a join
    tree's probes) drain or bypass at once instead of waiting out the
    2 s valve per dispatch.

Margins are the reference suite's (120 ms against 400 ms; the probe
window fast-forwarded by rewinding `_probe_at`), no tight timing.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tidb_tpu import config as jconfig
from tidb_tpu import memtrack as jmemtrack
from tidb_tpu import metrics as jmetrics
from tidb_tpu import sched as jsched
from tidb_tpu.ops import runtime as jruntime
from tidb_tpu.util import failpoint as jfailpoint
from tidb_tpu.util import supervisor as jsupervisor
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import memtrack as pmemtrack
from tidb_tpu_torch import metrics as pmetrics
from tidb_tpu_torch import sched as psched
from tidb_tpu_torch.ops import runtime as pruntime
from tidb_tpu_torch.util import failpoint as pfailpoint
from tidb_tpu_torch.util import supervisor as psupervisor

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)


class Pkg:
    def __init__(self, name, sched, config, memtrack, metrics, runtime,
                 failpoint, supervisor):
        self.name, self.sched, self.config = name, sched, config
        self.memtrack, self.metrics, self.runtime = memtrack, metrics, \
            runtime
        self.failpoint, self.supervisor = failpoint, supervisor


PKGS = {"jax": Pkg("jax", jsched, jconfig, jmemtrack, jmetrics, jruntime,
                   jfailpoint, jsupervisor),
        "port": Pkg("port", psched, pconfig, pmemtrack, pmetrics, pruntime,
                    pfailpoint, psupervisor)}
_VARS = ("tidb_tpu_sched_inflight", "tidb_tpu_sched_inflight_bytes",
         "tidb_tpu_dispatch_timeout_ms")


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    """One package with fresh scheduler singletons and restored
    sysvars."""
    p = PKGS[request.param]
    saved = {v: p.config.get_var(v) for v in _VARS}
    p.sched.reset_for_tests()
    try:
        yield p
    finally:
        for k, v in saved.items():
            p.config.set_var(k, v)
        p.failpoint.disable_all()
        p.sched.reset_for_tests()


def test_slot_cap_and_release(pkg):
    pkg.config.set_var("tidb_tpu_sched_inflight", 2)
    s = pkg.sched.DeviceScheduler()
    a, b = s.acquire(), s.acquire()
    assert a.granted and b.granted
    assert s.acquire(timeout=0.05) is None      # window full
    s.release(a)
    c = s.acquire(timeout=1.0)
    assert c is not None and c.granted
    s.release(b)
    s.release(c)
    snap = s.snapshot()
    assert (snap["inflight"], snap["waiting"], snap["grants"]) == (0, 0, 3)


def test_disabled_is_noop(pkg):
    pkg.config.set_var("tidb_tpu_sched_inflight", 0)
    s = pkg.sched.DeviceScheduler()
    assert all(s.acquire() is not None for _ in range(100))
    assert s.snapshot()["inflight"] == 0


def test_bytes_gate_reads_server_ledger(pkg):
    pkg.config.set_var("tidb_tpu_sched_inflight", 4)
    pkg.config.set_var("tidb_tpu_sched_inflight_bytes", 1000)
    s = pkg.sched.DeviceScheduler()
    node = pkg.memtrack.server_node("sched-test-resident")
    node.consume(device=4096)       # ledger over the gate
    try:
        a = s.acquire(timeout=0.2)
        assert a is not None and a.granted      # min-progress
        assert s.acquire(timeout=0.1) is None   # the gate holds
        s.release(a)
    finally:
        node.release(device=4096)
        node.detach()
    c = s.acquire(timeout=0.5)
    assert c is not None and c.granted
    s.release(c)


def test_bypass_valve_never_hangs(pkg, monkeypatch):
    pkg.config.set_var("tidb_tpu_sched_inflight", 1)
    monkeypatch.setattr(pkg.sched, "_BYPASS_S", 0.05)
    s = pkg.sched.DeviceScheduler()
    a = s.acquire()
    t0 = time.monotonic()
    b = s.acquire_or_bypass()       # window full: bypasses
    assert time.monotonic() - t0 < 2.0
    assert not b.granted
    s.release(b)                    # a bypass slot's release no-ops
    snap = s.snapshot()
    assert (snap["inflight"], snap["bypasses"]) == (1, 1)
    s.release(a)


def test_pipeline_map_releases_on_abandonment(pkg):
    pkg.config.set_var("tidb_tpu_sched_inflight", 2)
    pkg.sched.reset_for_tests()
    gen = pkg.runtime.pipeline_map(range(100), lambda i: i,
                                   lambda i, t: t, depth=2)
    assert next(gen) == 0
    gen.close()                     # abandon with tokens in flight
    snap = pkg.sched.device_scheduler().snapshot()
    assert snap["inflight"] == 0 and snap["waiting"] == 0


def test_pipeline_map_order_under_a_one_slot_window(pkg):
    pkg.config.set_var("tidb_tpu_sched_inflight", 1)
    pkg.sched.reset_for_tests()
    out = list(pkg.runtime.pipeline_map(range(20), lambda i: i * 3,
                                        lambda i, t: (i, t), depth=4))
    assert out == [(i, i * 3) for i in range(20)]
    assert pkg.sched.device_scheduler().snapshot()["grants"] == 20


def test_pipeline_map_fault_feeds_health_and_propagates(pkg):
    pkg.failpoint.enable("device/dispatch", "raise(DeviceFaultError)")
    with pytest.raises(pkg.failpoint.DeviceFaultError):
        list(pkg.runtime.pipeline_map(range(3), lambda i: i,
                                      lambda i, t: t, depth=2))
    pkg.failpoint.disable("device/dispatch")
    health = pkg.sched.device_health().snapshot()
    assert (health["faults"], health["consecutive_faults"]) == (1, 1)
    assert pkg.sched.device_scheduler().snapshot()["inflight"] == 0


def _quarantines(pkg, event):
    return int(pkg.metrics.snapshot().get(
        pkg.metrics.DEVICE_QUARANTINES + f'{{event="{event}"}}', 0))


def _resident_block(name):
    """One filled HBM block in a fresh device cache of `name`'s package
    (the port's on the CPU): -> (cache, its hbm-cache tracker)."""
    if name == "jax":
        from tidb_tpu.chunk import Chunk, Column
        from tidb_tpu.sqltypes import FieldType, TypeCode
        from tidb_tpu.store.device_cache import DeviceCache, tracker
        cache = DeviceCache()
    else:
        from tidb_tpu_torch.chunk import Chunk, Column
        from tidb_tpu_torch.sqltypes import FieldType, TypeCode
        from tidb_tpu_torch.store.device_cache import DeviceCache, tracker
        cache = DeviceCache(device="cpu")
    ft = FieldType(TypeCode.LONGLONG)
    chunk = Chunk([Column(ft, np.arange(2048, dtype=np.int64),
                          np.ones(2048, dtype=bool))])
    assert cache.fill(("k",), 1, 10, chunk) is not None
    return cache, tracker()


def test_quarantine_sheds_hbm_and_reprobes(pkg):
    cache, node = _resident_block(pkg.name)
    assert cache.resident_bytes() > 0 and node.device > 0
    health = pkg.sched.DeviceHealth()
    before = (_quarantines(pkg, "quarantine"), _quarantines(pkg, "readmit"))
    for _ in range(3):
        assert health.available()
        health.note_fault()
    assert not health.available()           # quarantined, window open
    assert _quarantines(pkg, "quarantine") == before[0] + 1
    assert cache.resident_bytes() == 0 and node.device == 0
    snap = health.snapshot()
    assert snap["quarantined"] and snap["quarantines"] == 1
    health._probe_at = time.monotonic() - 0.01   # window passed
    assert health.available()               # the one probe
    assert not health.available()           # everyone else: host path
    health.note_ok()                        # the probe succeeded
    assert not health.snapshot()["quarantined"]
    assert _quarantines(pkg, "readmit") == before[1] + 1


def test_failed_probe_rearms_the_window(pkg):
    health = pkg.sched.DeviceHealth()
    for _ in range(3):
        health.note_fault()
    health._probe_at = time.monotonic() - 0.01
    assert health.available()
    health.note_fault()                     # the probe failed
    assert not health.available()
    assert health.snapshot()["quarantines"] == 1


def test_degrade_statement_latches_the_root(pkg):
    assert not pkg.sched.statement_degraded()   # no statement: no latch
    pkg.sched.degrade_statement()
    root = pkg.memtrack.statement_root(None, label="degrade")
    try:
        with pkg.memtrack.tracking(root):
            assert not pkg.sched.statement_degraded()
            pkg.sched.degrade_statement()
            assert pkg.sched.statement_degraded()
        assert root.fault_degraded
    finally:
        root.detach()


def test_watchdog_off_by_default_no_thread(pkg):
    assert pkg.config.dispatch_timeout_ms() == 0
    with pkg.sched.finalize_watch("x"):
        pass
    with pkg.sched.device_slot():
        pass
    wd = pkg.sched.dispatch_watchdog()
    assert wd.snapshot() == {"watching": 0, "fired": 0}
    assert wd._thread is None


def test_watchdog_times_out_a_slow_section(pkg):
    pkg.config.set_var("tidb_tpu_dispatch_timeout_ms", 120)
    before = int(pkg.metrics.snapshot().get(
        pkg.metrics.DISPATCH_TIMEOUTS, 0))
    root = pkg.memtrack.statement_root(None, label="slow")
    try:
        with pkg.memtrack.tracking(root):
            with pytest.raises(pkg.failpoint.DispatchTimeoutError) as ei:
                with pkg.sched.finalize_watch("slow-finalize"):
                    time.sleep(0.4)
        assert "watchdog" in str(ei.value)
        assert isinstance(ei.value, pkg.failpoint.DeviceFaultError)
        # the monitor latched the statement's cancel
        assert root._cancel_msg is not None and \
            "watchdog" in root._cancel_msg
        assert root.cancel("again") is False
    finally:
        root.detach()
    assert int(pkg.metrics.snapshot().get(
        pkg.metrics.DISPATCH_TIMEOUTS, 0)) == before + 1
    assert pkg.sched.dispatch_watchdog().snapshot()["fired"] == 1
    # a section inside the limit passes
    with pkg.sched.finalize_watch("fast"):
        pass


def _restarts(pkg, worker):
    return int(pkg.metrics.snapshot().get(
        pkg.metrics.WORKER_RESTARTS + f'{{worker="{worker}"}}', 0))


def test_run_once_restarts_then_gives_up(pkg, monkeypatch):
    monkeypatch.setattr(pkg.supervisor, "BACKOFF_BASE_S", 0.001)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("injected crash")

    base = _restarts(pkg, "once-ok")
    assert pkg.supervisor.run_once("once-ok", flaky, retries=2) is True
    assert calls["n"] == 3 and _restarts(pkg, "once-ok") == base + 2

    def dead():
        raise RuntimeError("always")

    base = _restarts(pkg, "once-dead")
    assert pkg.supervisor.run_once("once-dead", dead, retries=1) is False
    assert _restarts(pkg, "once-dead") == base + 2


def test_supervise_restarts_a_crashing_beat(pkg):
    calls = {"n": 0}
    stop = threading.Event()

    def beat():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("injected crash")

    worker = f"beat-{pkg.name}"
    base = _restarts(pkg, worker)
    t = pkg.supervisor.supervise(worker, beat, stop, interval=0.01)
    deadline = time.time() + 5.0
    while calls["n"] < 4 and time.time() < deadline:
        time.sleep(0.01)
    stop.set()
    t.join(timeout=6.0)
    assert calls["n"] >= 4
    assert _restarts(pkg, worker) == base + 2


def test_nested_pipelines_on_one_thread_never_wait_out_the_valve():
    """A join tree's probe pipelines nest as generators on one thread:
    five levels at depth 2 hold up to 10 tokens against a window of 4.
    The port's nested acquire drains or bypasses at once (the JAX
    package waits the 2 s valve for each): every result arrives in
    order, the bypasses are counted, and the whole tree waits far less
    than one valve."""
    saved = pconfig.get_var("tidb_tpu_sched_inflight")
    pconfig.set_var("tidb_tpu_sched_inflight", 4)
    psched.reset_for_tests()
    try:
        items = range(6)
        for _level in range(5):
            items = pruntime.pipeline_map(items, lambda i: i + 1,
                                          lambda i, t: t, depth=2)
        assert list(items) == [i + 5 for i in range(6)]
        snap = psched.device_scheduler().snapshot()
        assert snap["bypasses"] >= 5 and snap["inflight"] == 0
        assert snap["stall_seconds"] < 1.0
    finally:
        pconfig.set_var("tidb_tpu_sched_inflight", saved)
        psched.reset_for_tests()
