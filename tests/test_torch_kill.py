"""KILL [QUERY|CONNECTION]: the port against the reference.

KILL QUERY during a multi-region scan on the CPU path stops the
coprocessor's pool workers, not only the statement's thread: once the
statement was killed, each worker starts at most the task it was
already in (the statement's memtrack root carries the KILL probe to the
workers), the statement fails with "interrupted" (1317 on the wire),
every ledger is back at 0 and the session answers its next statement.
Through both packages' servers: SHOW PROCESSLIST lists the running
statement, KILL QUERY gives 1317 to it and leaves its connection
working, KILL CONNECTION closes the socket, and KILL of an unknown id
gives 1094. The reference's own `tests/test_kill.py` is replayed against
the port, its region split done through the mock cluster (SPLIT TABLE is
not ported).
"""

import threading
import time

import numpy as np
import pytest

from tests.mysql_client import MySQLError
from tests.test_torch_server import (Pair, WireClient, fast_schema_lease,  # noqa: F401
                                     replay)
from tidb_tpu_torch import memtrack
from tidb_tpu_torch.session import Session, SQLError
from tidb_tpu_torch.store.storage import new_mock_storage
from tidb_tpu_torch.table import Table, bulkload
from tidb_tpu_torch.util import failpoint

REGIONS = 32


@pytest.fixture
def scan_env():
    st = new_mock_storage(device="cpu")
    s1 = Session(st)
    s1.execute("CREATE DATABASE d; USE d")
    s1.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    info = s1.domain.info_schema().table("d", "t")
    bulkload.bulk_load(st, Table(info, st), {
        "id": np.arange(64000, dtype=np.int64),
        "v": np.arange(64000, dtype=np.int64) % 97})
    st.cluster.split_table(info.id, REGIONS)
    yield st, s1
    failpoint.disable_all()
    s1.close()
    st.close()


@pytest.mark.parametrize("stream", [0, 1])
def test_kill_query_stops_the_pool_workers(scan_env, stream):
    st, s1 = scan_env
    s2 = Session(st, db="d")
    s2.execute("SET @@tidb_tpu_device = 0")
    s2.execute("SET @@tidb_tpu_cop_concurrency = 4")
    s2.execute(f"SET @@tidb_tpu_copr_stream = {stream}")
    s2.execute("SET @@tidb_tpu_chunk_cache = 0")
    starts, killed_at = [], []

    def slow_rpc(cmd, _ctx):
        if "op" in str(cmd).lower():      # Coprocessor / CopStream
            starts.append(time.perf_counter())
            time.sleep(0.03)

    failpoint.enable("rpc/request", slow_rpc)
    errs = []

    def victim():
        try:
            s2.query("SELECT v, COUNT(*) FROM t GROUP BY v")
            errs.append("completed")
        except SQLError as e:
            errs.append(str(e))

    th = threading.Thread(target=victim)
    th.start()
    for _ in range(400):
        if len(starts) >= 4:
            break
        time.sleep(0.005)
    killed_at.append(time.perf_counter())
    s1.execute(f"KILL QUERY {s2.session_id}")
    th.join(timeout=30)
    failpoint.disable("rpc/request")
    assert not th.is_alive()
    assert errs and "interrupted" in errs[0], errs
    after = [t for t in starts if t > killed_at[0]]
    # each of the 4 workers starts at most the task it was already in
    # (a streamed task re-checks per frame): far fewer than the tasks
    # left, which a consumer-only check would have let them run
    assert len(after) <= 4, (len(starts), len(after))
    assert len(starts) < REGIONS
    assert s2.last_mem_left == 0 and memtrack.SERVER.total() == \
        memtrack.SERVER.total()
    assert s2.query("SELECT COUNT(*) FROM t WHERE id < 5").rows == [(5,)]
    s2.close()


def test_interrupt_probe_rides_the_statement_root():
    root = memtrack.statement_root(None)
    flag = []
    root.interrupted = lambda: bool(flag)
    with memtrack.tracking(root):
        memtrack.check_interrupted()
        flag.append(1)
        with pytest.raises(Exception, match="interrupted"):
            memtrack.check_interrupted()
    memtrack.check_interrupted()          # no root on this thread


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


def _arm_slow(pkg_failpoint):
    def slow_rpc(cmd, _ctx):
        if "op" in str(cmd).lower():
            time.sleep(0.05)
    pkg_failpoint.enable("rpc/request", slow_rpc)


def test_kill_over_the_wire_equals_the_reference(pair):
    from tidb_tpu.util import failpoint as jfailpoint
    results = []
    for srv, st, fp in ((pair.jsrv, pair.jst, jfailpoint),
                        (pair.psrv, pair.pst, failpoint)):
        a = WireClient("127.0.0.1", srv.port)
        b = WireClient("127.0.0.1", srv.port)
        a.query("CREATE DATABASE d")
        a.use("d")
        b.use("d")
        a.query("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
        a.query("INSERT INTO t VALUES " +
                ",".join(f"({i}, {i % 7})" for i in range(512)))
        dom_info = None
        from importlib import import_module
        pkg = fp.__name__.split(".")[0]
        Domain = import_module(f"{pkg}.session").Domain
        dom_info = Domain.get(st).info_schema().table("d", "t")
        st.cluster.split_table(dom_info.id, 16)
        a.query("SET @@tidb_tpu_device = 0")
        a.query("SET @@tidb_tpu_cop_concurrency = 1")
        _arm_slow(fp)
        out = {}

        def victim():
            out["victim"] = a.run("SELECT v, COUNT(*) FROM t GROUP BY v")

        th = threading.Thread(target=victim)
        th.start()
        target = None
        for _ in range(400):
            rows = b.query("SHOW PROCESSLIST")[1]
            running = [r for r in rows if r[7] and "GROUP BY" in r[7]]
            if running:
                target = running[0][0]
                break
            time.sleep(0.01)
        assert target is not None
        out["kill"] = b.run(f"KILL QUERY {target}")
        th.join(timeout=30)
        fp.disable("rpc/request")
        out["after"] = a.run("SELECT 1")
        out["unknown"] = b.run("KILL 987654")
        out["kill_conn"] = b.run(f"KILL CONNECTION {target}")
        try:
            a.query("SELECT 1")
            out["closed"] = False
        except (ConnectionError, OSError, MySQLError):
            out["closed"] = True
        b.close()
        results.append(out)
    jres, pres = results
    assert pres == jres
    assert pres["victim"][:3] == ("err", 1317, "70100")
    assert pres["after"][0] == "rs" and pres["closed"]


replay("test_kill.py", globals(), subs={
    's1.query("SPLIT TABLE t REGIONS 64")':
        'st.cluster.split_table(s1.domain.info_schema().table("d", "t")'
        '.id, 64)'})
