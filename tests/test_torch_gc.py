"""The GC worker in the port against the JAX package's (ported from
tests/test_gc.py).

Each scenario runs once per package over a fresh mock store of its own
(the port's on `device="cpu"`), with gc_life_time 0 so the safepoint
lands at "now" (a short sleep puts earlier writes strictly below it),
and the observations must be equal: the safepoint advances, persists
and never moves back; a read below it is refused (GCTooEarlyError); a
second worker is not the leader; superseded versions are pruned, with
the same pruned count; the delete ranges of DROP TABLE, TRUNCATE and
DROP INDEX are drained, with the same remaining KV pairs; a stale lock
of a dead writer is resolved; the safepoint stays below an in-flight
reorg's snapshot.
"""

import time
import types

import pytest
import torch

from tests.test_torch_txn import table_kv
from tidb_tpu import kv as jkv
from tidb_tpu.meta import Meta as JMeta
from tidb_tpu.session import Session as JSession
from tidb_tpu.store import backoff as jbackoff
from tidb_tpu.store import txn as jtxn
from tidb_tpu.store.gcworker import GCWorker as JGCWorker
from tidb_tpu.store.oracle import compose_ts as jcompose
from tidb_tpu.store.oracle import physical_ms as jphysical
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch import kv as pkv
from tidb_tpu_torch.meta import Meta as PMeta
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store import backoff as pbackoff
from tidb_tpu_torch.store import txn as ptxn
from tidb_tpu_torch.store.gcworker import GCWorker as PGCWorker
from tidb_tpu_torch.store.oracle import compose_ts as pcompose
from tidb_tpu_torch.store.oracle import physical_ms as pphysical
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

torch.set_num_threads(1)

REF = types.SimpleNamespace(
    Session=JSession, GCWorker=JGCWorker, Meta=JMeta, kv=jkv,
    backoff=jbackoff, txn=jtxn, compose_ts=jcompose,
    physical_ms=jphysical, new_storage=jnew_storage, port=False)
PORT = types.SimpleNamespace(
    Session=PSession, GCWorker=PGCWorker, Meta=PMeta, kv=pkv,
    backoff=pbackoff, txn=ptxn, compose_ts=pcompose,
    physical_ms=pphysical, new_storage=lambda: pnew_storage(device="cpu"),
    port=True)


def _gc(pkg, storage) -> dict:
    time.sleep(0.02)    # move the ms clock past every prior commit
    return pkg.GCWorker(storage, gc_life_time_ms=0).run_once()


def _pending(pkg, storage) -> int:
    txn = storage.begin()
    try:
        return len(pkg.Meta(txn).pending_delete_ranges())
    finally:
        txn.rollback()


def parity(scenario, same_kv=True):
    """Run `scenario(pkg, storage, session) -> observations` in both
    packages; the observations (and the table-data KV pairs) must be
    equal."""
    out, kvs = [], []
    for pkg in (REF, PORT):
        storage = pkg.new_storage()
        storage.async_commit_secondaries = False
        s = pkg.Session(storage)
        s.execute("CREATE DATABASE test; USE test")
        try:
            out.append(scenario(pkg, storage, s))
            kvs.append(table_kv(storage, port=pkg.port))
        finally:
            s.close()
            storage.close()
    assert out[1] == out[0]
    if same_kv:
        assert kvs[1] == kvs[0]
    return out[1]


def test_safepoint_advances_and_persists():
    def scenario(pkg, storage, _s):
        w = pkg.GCWorker(storage, gc_life_time_ms=0)
        time.sleep(0.02)
        stats = w.run_once()
        again = w.run_once(now_ts=stats["safepoint"])
        return (stats["leader"], stats["advanced"],
                0 < stats["safepoint"] <= storage.current_ts(),
                w.saved_safepoint() == stats["safepoint"] ==
                storage.safepoint, again["advanced"], sorted(stats))
    got = parity(scenario)
    assert got[:5] == (True, True, True, True, False)


def test_reads_below_the_safepoint_are_refused():
    def scenario(pkg, storage, s):
        s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY)")
        s.execute("INSERT INTO t VALUES (1)")
        old_ts = storage.current_ts()
        stats = _gc(pkg, storage)
        with pytest.raises(pkg.kv.GCTooEarlyError):
            storage.snapshot(old_ts).get(b"anything")
        return (stats["advanced"], storage.safepoint > old_ts,
                s.query("SELECT * FROM t").rows)
    assert parity(scenario) == (True, True, [(1,)])


def test_second_worker_is_not_leader():
    def scenario(pkg, storage, _s):
        time.sleep(0.02)
        first = pkg.GCWorker(storage, gc_life_time_ms=0).run_once()
        second = pkg.GCWorker(storage, gc_life_time_ms=0).run_once()
        return first["leader"], second
    assert parity(scenario) == (True, {"leader": False})


def _owner_versions(storage) -> int:
    """Versions of the DDL owner lease (`m_owner_ddl`), renewed by each
    DDL in both packages: the GC prunes all but its newest, and the
    scenarios count the table's keys and versions without it."""
    return len(storage.engine.mvcc_by_key(b"m_owner_ddl")["writes"])


def test_old_versions_are_pruned():
    def scenario(pkg, storage, s):
        s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
        s.execute("INSERT INTO t VALUES (1, 0)")
        for i in range(1, 6):
            s.execute(f"UPDATE t SET b = {i} WHERE a = 1")
        owner = _owner_versions(storage)
        keys = storage.engine.num_keys() - (owner > 0)
        stats = _gc(pkg, storage)
        return (stats["pruned"] - max(owner - 1, 0), keys,
                storage.engine.num_keys() - (owner > 0),
                s.query("SELECT b FROM t").rows)
    pruned, _k, _k2, rows = parity(scenario)
    assert pruned >= 5 and rows == [(5,)]


_LOAD = ["CREATE TABLE t (a BIGINT PRIMARY KEY, b INT, KEY kb (b))",
         "INSERT INTO t VALUES " + ",".join(f"({i}, {i})" for i in range(50))]


@pytest.mark.parametrize("drop", ["DROP TABLE t", "TRUNCATE TABLE t",
                                  "DROP INDEX kb ON t"])
def test_delete_ranges_are_drained(drop):
    def scenario(pkg, storage, s):
        for sql in _LOAD:
            s.execute(sql)
        before = storage.engine.num_keys()
        s.execute(drop)
        queued = _pending(pkg, storage)
        owner = _owner_versions(storage)
        stats = _gc(pkg, storage)
        rows = s.query("SELECT COUNT(*) FROM t").rows \
            if drop != "DROP TABLE t" else None
        return (queued, stats["delete_ranges"], _pending(pkg, storage),
                storage.engine.num_keys() < before, rows,
                stats["pruned"] - max(owner - 1, 0))
    got = parity(scenario)
    assert got[:4] == (1, 1, 0, True)
    assert got[4] == {"DROP TABLE t": None, "TRUNCATE TABLE t": [(0,)],
                      "DROP INDEX kb ON t": [(50,)]}[drop]


def test_stale_lock_is_resolved():
    def scenario(pkg, storage, _s):
        old_ts = pkg.compose_ts(pkg.physical_ms(storage.current_ts())
                                - 3_600_000)
        txn = storage.begin(start_ts=old_ts)
        txn.set(b"zz_orphan", b"v")
        muts = txn.mutations()
        c = pkg.txn.TwoPhaseCommitter(
            storage.shim, storage.region_cache, storage.oracle,
            storage.resolver, muts, old_ts, async_secondaries=False)
        c._on_batches(pkg.backoff.Backoffer(5000), list(muts.keys()),
                      c._prewrite_batch, primary_first=False)
        stats = _gc(pkg, storage)
        return (stats["resolved_locks"],
                storage.snapshot(storage.current_ts()).get(b"zz_orphan"))
    assert parity(scenario) == (1, None)


def test_safepoint_stays_below_a_reorg_snapshot():
    """An ADD INDEX stopped in WRITE_REORG: the GC's safepoint stays at
    the reorg's snapshot, so the backfill that resumes reads it without
    GCTooEarlyError."""
    def scenario(pkg, storage, s):
        for sql in _LOAD:
            s.execute(sql)
        from importlib import import_module
        root = "tidb_tpu_torch" if pkg.port else "tidb_tpu"
        ddl = import_module(root + ".ddl")
        worker = import_module(root + ".ddl.worker")
        parse = import_module(root + ".parser").parse
        d = ddl.DDL(storage, worker=worker.DDLWorker(storage))
        d.worker.run_job = lambda job_id: None       # enqueue only
        d.execute(parse("CREATE INDEX ib ON t (b)")[0], "test")
        stepper = worker.DDLWorker(storage)
        for _ in range(3):
            job = stepper.run_one_step()
        stats = _gc(pkg, storage)
        done = worker.DDLWorker(storage).run_job(job.id)
        return (stats["safepoint"] == job.snapshot_ver,
                done.state.name,
                s.query("SELECT a FROM t WHERE b = 7").rows)
    assert parity(scenario) == (True, "DONE", [(7,)])
