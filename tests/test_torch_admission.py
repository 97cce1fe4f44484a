"""Admission and the shed chain: the port against the reference.

Under a server quota pinched below one statement's recorded digest peak
(`tidb_tpu_server_mem_quota`), concurrent statements through both
packages' servers either complete with the right rows or get the
retryable 9008 (ER_SERVER_BUSY_ADMISSION) before they run, never the
8175 of an OOM cancel in the middle of one; control statements still
run; `shed_server` (the status port's /shed) frees the HBM cache and
returns its ledger to 0. The reference's own admission and shed cases
(`tests/test_sched.py` TestAdmission, TestRunSpillActions,
TestSessionAdmission; `tests/test_concurrent_serving.py`
TestPinchedServerQuota, TestStatusPort, TestHeartbeatCacheStability)
are replayed against the port.
"""

import re
import threading
import time

import pytest

from tests.test_torch_server import (Pair, WireClient, fast_schema_lease,  # noqa: F401
                                     replay)
from tidb_tpu import config as jconfig
from tidb_tpu import perfschema as jperf
from tidb_tpu import sched as jsched
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import perfschema as pperf
from tidb_tpu_torch import sched as psched

_KNOBS = ("tidb_tpu_server_mem_quota", "tidb_tpu_admission_timeout_ms",
          "tidb_tpu_device_min_rows")


@pytest.fixture
def pair():
    saved = [(cfg, {k: cfg.get_var(k) for k in _KNOBS})
             for cfg in (jconfig, pconfig)]
    for s in (jsched, psched):
        s.reset_for_tests()
    p = Pair()
    yield p
    p.close()
    for cfg, vals in saved:
        for k, v in vals.items():
            cfg.set_var(k, v)
    for s in (jsched, psched):
        s.reset_for_tests()


AGG = "SELECT g, COUNT(*), SUM(v) FROM pin GROUP BY g ORDER BY g"


def _pinched_run(srv, cfg, perf, sched):
    """4 concurrent aggregates under a quota below the digest's peak:
    -> (outcome per statement, admission counters, rows of each
    completion)."""
    admin = WireClient("127.0.0.1", srv.port)
    admin.query("CREATE DATABASE test")
    admin.use("test")
    admin.query("CREATE TABLE pin (id BIGINT PRIMARY KEY, g BIGINT, "
                "v BIGINT)")
    admin.query("INSERT INTO pin VALUES " + ", ".join(
        f"({i}, {i % 97}, {i % 13})" for i in range(6000)))
    truth = admin.query(AGG)
    peak = perf.digest_max_mem(AGG)
    assert peak > 0
    admin.run(f"SET GLOBAL tidb_tpu_server_mem_quota = {peak // 2}")
    admin.run("SET GLOBAL tidb_tpu_admission_timeout_ms = 100")
    # the running statement's reserve holds the rest out: hold one
    ticket = sched.admission().admit(1 << 20)
    outcomes, rows = [], []
    barrier = threading.Barrier(4)

    def client():
        c = WireClient("127.0.0.1", srv.port, db="test")
        barrier.wait(timeout=30)
        r = c.run(AGG)
        outcomes.append(r[1] if r[0] == "err" else "ok")
        if r[0] == "rs":
            rows.append(r[2])
        c.close()

    ths = [threading.Thread(target=client) for _ in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(60)
    sched.admission().finish(ticket)
    # control statements run on a saturated server; then it recovers
    after = admin.run(AGG)
    admin.run("SET GLOBAL tidb_tpu_server_mem_quota = 0")
    admin.close()
    counts = sched.stats()["admission"]
    return sorted(map(str, outcomes)), counts, rows, truth, after


def test_pinched_quota_gives_9008_before_8175_as_the_reference(pair):
    j = _pinched_run(pair.jsrv, jconfig, jperf, jsched)
    p = _pinched_run(pair.psrv, pconfig, pperf, psched)
    for outcomes, counts, rows, truth, after in (j, p):
        assert set(outcomes) <= {"ok", "9008"}, outcomes
        assert "8175" not in outcomes
        assert all(r == truth[1] for r in rows)
        assert after[0] == "rs" and after[2] == truth[1]
        assert counts["rejected"] == outcomes.count("9008")
    # the same traffic, the same outcome counts
    assert p[0] == j[0]
    assert {k: p[1][k] for k in ("admitted", "rejected")} == \
        {k: j[1][k] for k in ("admitted", "rejected")}


def test_admission_outcome_on_the_wire_equals_the_reference(pair):
    got = []
    for srv, sched in ((pair.jsrv, jsched), (pair.psrv, psched)):
        c = WireClient("127.0.0.1", srv.port)
        c.query("CREATE DATABASE a")
        c.use("a")
        c.query("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
        c.query("INSERT INTO t VALUES (1, 10), (2, 20)")
        c.run("SET GLOBAL tidb_tpu_server_mem_quota = 100")
        c.run("SET GLOBAL tidb_tpu_admission_timeout_ms = 50")
        blocker = sched.admission().admit(1 << 20)
        out = [c.run("SELECT SUM(v) FROM t"),
               c.run("SET @@tidb_tpu_superchunk_rows = 4096"),
               c.run("SHOW VARIABLES LIKE 'tidb_tpu_server_mem_quota'"),
               c.run("INSERT INTO t VALUES (3, 30)")]
        sched.admission().finish(blocker)
        out.append(c.run("SELECT SUM(v) FROM t"))
        c.run("SET GLOBAL tidb_tpu_server_mem_quota = 0")
        c.close()
        # the message names the session, whose id counts the sessions
        # each package made before
        got.append([tuple(re.sub(r"session-\d+", "session-N", v)
                          if isinstance(v, str) else v for v in r)
                    for r in out])
    assert got[1] == got[0]
    assert got[1][0][:3] == ("err", 9008, "HY000")
    # the INSERT was refused before it ran: the sum is the old one
    assert got[1][-1][0] == "rs" and got[1][-1][2] == [("30",)]


def test_shed_server_returns_the_hbm_ledger_to_zero():
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store import device_cache
    from tidb_tpu_torch.store.storage import new_mock_storage
    st = new_mock_storage(device="cpu")
    s = Session(st)
    s.execute("CREATE DATABASE d; USE d")
    s.execute("SET @@tidb_tpu_device_min_rows = 1")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    s.execute("INSERT INTO t VALUES " + ",".join(
        f"({i}, {i % 5})" for i in range(4096)))
    q = "SELECT v, COUNT(*) FROM t GROUP BY v ORDER BY v"
    rows = [s.query(q).rows for _ in range(3)]
    assert rows[0] == rows[1] == rows[2]
    node = device_cache.tracker()
    freed = psched.shed_server(0)
    assert freed >= 0 and node.device == 0
    assert s.query(q).rows == rows[0]
    s.close()
    st.close()


replay("test_sched.py", globals(), drop={
    "TestDeviceScheduler": "the port's scheduler is held by "
                           "test_torch_sched.py",
    "TestEwmaPlacement": "multi-chip placement: the port drives one device",
}, subs={"cache = DeviceCache()": 'cache = DeviceCache(device="cpu")'})

_GET_JSON = ("statusclient = type('statusclient', (), {'get_json': "
             "staticmethod(lambda host, port, path, timeout=10: "
             "__import__('json').loads(__import__('urllib.request')"
             ".request.urlopen(f'http://{host}:{port}{path}', "
             "timeout=timeout).read()))})\n")
replay("test_concurrent_serving.py", globals(), drop={
    "TestMultiClientIsolation": "reads information_schema.memory_usage, "
                                "not ported",
    "TestResourceMetering": "reads information_schema.resource_usage, "
                            "not ported",
    "TestServeBenchHeavy": "drives the reference's bench.py",
}, subs={"from tidb_tpu.util import statusclient\n": _GET_JSON})
