"""The DDL owner lease and the schema plane: the port against the
reference.

Both packages' DDL takes the owner lease (`m_owner_ddl`, owner.py)
through the session's Domain: with no schema worker a DDL campaigns and
runs its job inline, so the same DDL writes the same keys in both
stores; with the schema worker running (as a Server runs it) the
submitting session waits while another participant holds the lease,
and the worker's tick runs the job once the lease expires. The schema
version is published under `m_schema_sync_<owner id>` and
`wait_schema_convergence` answers for it. The reference's own
`tests/test_multi_server_schema.py` owner-election cases are replayed
against the port (its two-server cases need the remote store plane,
which is not ported).
"""

import time

import pytest

from tests.test_torch_server import replay
from tidb_tpu.session import Session as JSession
from tidb_tpu.store import new_mock_storage as j_storage
from tidb_tpu_torch.owner import DDL_OWNER_KEY, OwnerManager
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as p_storage

DDL = ["CREATE DATABASE d", "USE d",
       "CREATE TABLE t (a BIGINT PRIMARY KEY, b INT, c VARCHAR(8))",
       "CREATE INDEX ib ON t (b)", "ALTER TABLE t ADD COLUMN e INT",
       "INSERT INTO t VALUES (1, 2, 'x', 3)", "TRUNCATE TABLE t",
       "DROP INDEX ib ON t", "DROP TABLE t"]


def _keys(storage):
    snap = storage.snapshot(storage.current_ts())
    return sorted(k for k, _v in snap.iter_range(b"", b""))


def test_inline_ddl_writes_the_reference_keys():
    jst, pst = j_storage(), p_storage(device="cpu")
    js, ps = JSession(jst), PSession(pst)
    for sql in DDL:
        js.execute(sql)
        ps.execute(sql)
    jkeys, pkeys = _keys(jst), _keys(pst)
    assert DDL_OWNER_KEY in pkeys and DDL_OWNER_KEY in jkeys
    assert pkeys == jkeys
    for s, st in ((js, jst), (ps, pst)):
        s.close()
        st.close()


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_ddl_waits_for_the_lease_and_the_worker_runs_it(pkg):
    if pkg == "reference":
        from tidb_tpu.owner import OwnerManager as Owner
        st, Sess = j_storage(), JSession
    else:
        Owner, st, Sess = OwnerManager, p_storage(device="cpu"), PSession
    s = Sess(st)
    dom = s.domain
    old = dom.SCHEMA_LEASE_MS
    type(dom).SCHEMA_LEASE_MS = 100
    other = Owner(st, lease_ms=400)
    try:
        assert other.campaign()          # another server owns the lease
        dom.start_schema_worker()
        assert dom.schema_worker_running()
        t0 = time.monotonic()
        s.execute("CREATE DATABASE w")
        waited = time.monotonic() - t0
        assert waited >= 0.25, waited    # ran only after the lease ended
        assert dom.ddl_owner().is_owner() and not other.is_owner()
        s.execute("CREATE TABLE w.t (a BIGINT PRIMARY KEY)")
        s.execute("INSERT INTO w.t VALUES (1), (2)")
        assert s.query("SELECT COUNT(*) FROM w.t").rows == [(2,)]
        ver = dom.info_schema().version
        deadline = time.monotonic() + 5
        while dom.live_schema_versions().get(dom.ddl_owner().id) != ver:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert dom.wait_schema_convergence(ver, timeout_ms=500)
    finally:
        dom.stop_schema_worker()
        type(dom).SCHEMA_LEASE_MS = old
        s.close()
        st.close()


def test_schema_worker_tick_drains_a_queued_job():
    st = p_storage(device="cpu")
    s = PSession(st)
    s.execute("CREATE DATABASE q")
    dom = s.domain
    from tidb_tpu_torch.ddl import DDL
    from tidb_tpu_torch.parser import parse
    ddl = DDL(st)
    build = ddl._build_CreateTableStmt(
        parse("CREATE TABLE q.t (a BIGINT PRIMARY KEY)")[0], "q")[0]
    job = ddl._enqueue(build)
    assert job is not None
    assert not dom.info_schema().has_table("q", "t")
    dom.schema_worker_tick()
    assert dom.info_schema().has_table("q", "t")
    s.close()
    st.close()


replay("test_multi_server_schema.py", globals(), drop={
    "TestTwoServers": "two SQL servers over the remote store plane "
                      "(store/remote.py), not ported"},
    subs={"from tidb_tpu.store.remote import StorageServer, connect\n": ""})


def test_stats_worker_tick_keeps_the_caches_warm():
    """The stats worker's auto-analyze saves a statistics blob; in the
    reference that save bumps the engine's data_version (every cache
    goes cold), in the port it does not (a deviation: the blob changes
    no row and no schema)."""
    bumps = []
    for Sess, st in ((JSession, j_storage()),
                     (PSession, p_storage(device="cpu"))):
        s = Sess(st)
        s.execute("CREATE DATABASE a; USE a")
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
        s.execute("INSERT INTO t VALUES (1, 1), (2, 2), (3, 3)")
        v0 = st.engine.data_version
        assert s.domain.auto_analyze_tick()        # t had pseudo stats
        bumps.append(st.engine.data_version - v0)
        assert s.query("SELECT SUM(v) FROM t").rows[0][0] == 6
        s.close()
        st.close()
    assert bumps[0] > 0 and bumps[1] == 0, bumps


def test_lease_commits_do_not_veto_chunk_cache_fills():
    """With the schema worker committing its lease and schema version
    every 20 ms, an aggregate's second and third runs read every range
    from the chunk cache: the lease keys are ephemeral, so their commits
    neither raise the engine's max_commit_ts nor sit in its lock set
    (in the reference they do, and a scan that outlives a tick never
    fills the cache)."""
    st = p_storage(device="cpu")
    s = PSession(st)
    s.execute("CREATE DATABASE c; USE c")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, g BIGINT, v BIGINT)")
    s.execute("INSERT INTO t VALUES " + ",".join(
        f"({i}, {i % 5}, {i})" for i in range(3000)))
    st.cluster.split_table(s.domain.info_schema().table("c", "t").id, 4)
    dom = s.domain
    old = dom.SCHEMA_LEASE_MS
    type(dom).SCHEMA_LEASE_MS = 40
    dom.start_schema_worker()
    try:
        eng = st.engine
        before = eng.max_commit_ts
        time.sleep(0.1)
        assert dom.ddl_owner().is_owner()          # the worker ticked
        assert eng.max_commit_ts == before and not eng._locked_keys
        q = "SELECT g, SUM(v) FROM t GROUP BY g ORDER BY g"
        rows = s.query(q).rows
        h0 = st.chunk_cache.hits
        for _ in range(2):
            assert s.query(q).rows == rows
        assert st.chunk_cache.hits - h0 >= 2 * 4
    finally:
        dom.stop_schema_worker()
        type(dom).SCHEMA_LEASE_MS = old
        s.close()
        st.close()
