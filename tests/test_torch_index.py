"""Secondary indexes and online DDL in the port against the JAX package.

Ported from tests/test_ddl_online.py: each scenario runs once per
package, over a fresh mock store of its own (the port's on
`device="cpu"`), with that package's DDL front end, worker, parser and
Session, and the observations must be equal: the F1 state walks of
ADD INDEX, DROP TABLE and ADD/DROP COLUMN (the worker's state-change
hook), DML from a second session during WRITE_ONLY and DELETE_ONLY, an
UPDATE during the reorg, the checkpointed backfill (batches of
BACKFILL_BATCH) and its resume after a crash, a unique violation
rolling the job back, index ids never reused, TRUNCATE and RENAME, the
schema versions per transition; then every table-data KV pair
byte-equal.

The index readers and joins through SQL: IndexReader, IndexLookUp (also
with `tidb_tpu_sched_inflight = 1` and the device path, where the
lookup's pool workers must not wait out the scheduler's bypass valve),
IndexJoin (pk handle and secondary index, in a transaction that wrote
the inner table too) and MergeJoin give the reference's rows and
EXPLAIN trees.
"""

import types

import pytest
import torch

from tests.test_torch_txn import env, sysvars, table_kv  # noqa: F401
from tidb_tpu import codec as jcodec
from tidb_tpu import tablecodec as jtablecodec
from tidb_tpu.ddl import DDL as JDDL
from tidb_tpu.ddl.job import JobType as JJobType
from tidb_tpu.ddl.worker import BACKFILL_BATCH as JBATCH
from tidb_tpu.ddl.worker import DDLWorker as JWorker
from tidb_tpu.meta import Meta as JMeta
from tidb_tpu.parser import parse as jparse
from tidb_tpu.schema.model import SchemaState as JState
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch import codec as pcodec
from tidb_tpu_torch import sched as psched
from tidb_tpu_torch import tablecodec as ptablecodec
from tidb_tpu_torch.ddl import DDL as PDDL
from tidb_tpu_torch.ddl.job import JobType as PJobType
from tidb_tpu_torch.ddl.worker import BACKFILL_BATCH as PBATCH
from tidb_tpu_torch.ddl.worker import DDLWorker as PWorker
from tidb_tpu_torch.meta import Meta as PMeta
from tidb_tpu_torch.parser import parse as pparse
from tidb_tpu_torch.schema.model import SchemaState as PState
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

torch.set_num_threads(1)

REF = types.SimpleNamespace(
    name="ref", Session=JSession, DDL=JDDL, Worker=JWorker, parse=jparse,
    Meta=JMeta, JobType=JJobType, State=JState, codec=jcodec,
    tablecodec=jtablecodec, new_storage=jnew_storage)
PORT = types.SimpleNamespace(
    name="port", Session=PSession, DDL=PDDL, Worker=PWorker, parse=pparse,
    Meta=PMeta, JobType=PJobType, State=PState, codec=pcodec,
    tablecodec=ptablecodec, new_storage=lambda: pnew_storage(device="cpu"))


def test_backfill_batch_is_the_references():
    assert PBATCH == JBATCH == 256


class Run:
    """One package's store and session in database `test`."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.storage = pkg.new_storage()
        self.storage.async_commit_secondaries = False
        self.s = pkg.Session(self.storage)
        self.s.execute("CREATE DATABASE test; USE test")

    def q(self, sql):
        return self.s.query(sql).rows

    def ddl(self, sql, worker=None):
        self.pkg.DDL(self.storage, worker=worker).execute(
            self.pkg.parse(sql)[0], "test")

    def entries(self, table: str, index: str) -> int:
        info = self.s.domain.info_schema().table("test", table)
        idx = info.index_by_name(index)
        prefix = self.pkg.tablecodec.index_prefix(info.id, idx.id)
        txn = self.storage.begin()
        try:
            return sum(1 for _ in txn.iter_range(
                prefix, self.pkg.codec.prefix_next(prefix)))
        finally:
            txn.rollback()

    def meta(self):
        txn = self.storage.begin()
        return txn, self.pkg.Meta(txn)

    def close(self):
        self.s.close()
        self.storage.close()


def parity(scenario):
    """Run `scenario(run) -> observations` in both packages; the
    observations and the table-data KV pairs must be equal."""
    out = []
    kvs = []
    for pkg in (REF, PORT):
        r = Run(pkg)
        try:
            out.append(scenario(r))
            kvs.append(table_kv(r.storage, port=pkg is PORT))
        finally:
            r.close()
    assert out[1] == out[0]
    assert kvs[1] == kvs[0]
    return out[1]


def _rows(n, fn=lambda i: i):
    return ",".join(f"({i}, {fn(i)})" for i in range(n))


# -- state walks -------------------------------------------------------------

def test_add_index_states():
    def scenario(r):
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
        r.s.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
        states = []

        def hook(job):
            if job.tp == r.pkg.JobType.ADD_INDEX:
                states.append(int(job.schema_state))
        r.ddl("CREATE INDEX ib ON t (b)", r.pkg.Worker(
            r.storage, on_state_change=hook))
        return states, r.entries("t", "ib"), r.q("SELECT a FROM t "
                                                 "WHERE b = 20")
    states, n, rows = parity(scenario)
    assert states == [int(PState.DELETE_ONLY), int(PState.WRITE_ONLY),
                      int(PState.WRITE_REORG), int(PState.PUBLIC)]
    assert (n, rows) == (2, [(2,)])


def test_drop_table_states_queue_a_delete_range():
    def scenario(r):
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY)")
        r.s.execute("INSERT INTO t VALUES (1)")
        states = []

        def hook(job):
            if job.tp == r.pkg.JobType.DROP_TABLE:
                states.append(int(job.schema_state))
        r.ddl("DROP TABLE t", r.pkg.Worker(r.storage,
                                           on_state_change=hook))
        txn, m = r.meta()
        try:
            ranges = len(m.pending_delete_ranges())
        finally:
            txn.rollback()
        with pytest.raises(Exception):
            r.q("SELECT * FROM t")
        return states, ranges
    states, ranges = parity(scenario)
    assert states == [int(PState.WRITE_ONLY), int(PState.DELETE_ONLY),
                      int(PState.DELETE_ONLY)] and ranges == 1


def test_add_and_drop_column_states():
    def scenario(r):
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY)")
        r.s.execute("INSERT INTO t VALUES (1), (2)")
        states = []
        w = r.pkg.Worker(r.storage, on_state_change=lambda job:
                         states.append((job.tp.name,
                                        int(job.schema_state))))
        r.ddl("ALTER TABLE t ADD COLUMN c INT DEFAULT 7", w)
        added = r.q("SELECT c FROM t ORDER BY a")
        r.ddl("ALTER TABLE t DROP COLUMN c", w)
        return states, added, r.q("SELECT * FROM t ORDER BY a")
    states, added, rows = parity(scenario)
    assert added == [(7,), (7,)] and rows == [(1,), (2,)]
    assert len(states) == 8


# -- DML during the walk -----------------------------------------------------

@pytest.mark.parametrize("state,sql", [
    ("WRITE_ONLY", "INSERT INTO t VALUES (2, 20)"),
    ("DELETE_ONLY", "DELETE FROM t WHERE a = 2"),
    ("WRITE_ONLY", "UPDATE t SET b = 21 WHERE a = 2")])
def test_dml_during_the_walk_keeps_the_index_whole(state, sql):
    def scenario(r):
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
        r.s.execute("INSERT INTO t VALUES (1, 10)" +
                    ("" if sql.startswith("INSERT") else ", (2, 20)"))
        other = r.pkg.Session(r.storage, db="test")
        fired = []

        def hook(job):
            if job.tp == r.pkg.JobType.ADD_INDEX and not fired and \
                    job.schema_state == int(getattr(r.pkg.State, state)):
                fired.append(other.execute(sql))
        r.ddl("CREATE INDEX ib ON t (b)", r.pkg.Worker(
            r.storage, on_state_change=hook))
        other.close()
        return (fired, r.entries("t", "ib"),
                r.q("SELECT a FROM t WHERE b = 20"),
                r.q("SELECT a, b FROM t WHERE b > 0 ORDER BY a"))
    fired, _n, _rows, _all = parity(scenario)
    assert fired == [[1]]


def test_update_during_reorg_is_not_resurrected():
    n = PBATCH + 50
    target = PBATCH + 10           # in the second batch

    def scenario(r):
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
        r.s.execute("INSERT INTO t VALUES " + _rows(n))
        other = r.pkg.Session(r.storage, db="test")
        fired = []

        def on_batch(jb, cnt):
            if not fired:
                fired.append(cnt)
                other.execute(f"UPDATE t SET b = 999999 WHERE a = {target}")
        r.ddl("CREATE INDEX ib ON t (b)",
              r.pkg.Worker(r.storage, on_backfill_batch=on_batch))
        other.close()
        return (r.entries("t", "ib"),
                r.q(f"SELECT a FROM t WHERE b = {target}"),
                r.q("SELECT a FROM t WHERE b = 999999"))
    assert parity(scenario) == (n, [], [(target,)])


# -- the backfill ------------------------------------------------------------

def test_batched_backfill_with_checkpoints():
    n = PBATCH * 2 + 37

    def scenario(r):
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
        r.s.execute("INSERT INTO t VALUES " + _rows(n, lambda i: i % 97))
        batches = []
        r.ddl("CREATE INDEX ib ON t (b)", r.pkg.Worker(
            r.storage, on_backfill_batch=lambda jb, cnt:
            batches.append((jb.reorg_handle, cnt))))
        return batches, r.entries("t", "ib")
    batches, entries = parity(scenario)
    assert [c for _h, c in batches] == [PBATCH, PBATCH, 37]
    assert entries == n


def test_backfill_resumes_from_its_checkpoint():
    n = PBATCH * 3

    class Crash(Exception):
        pass

    def scenario(r):
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
        r.s.execute("INSERT INTO t VALUES " + _rows(n))
        ddl = r.pkg.DDL(r.storage, worker=r.pkg.Worker(r.storage))
        ddl.worker.run_job = lambda job_id: None     # enqueue only
        ddl.execute(r.pkg.parse("CREATE INDEX ib ON t (b)")[0], "test")
        stepper = r.pkg.Worker(r.storage)
        for _ in range(3):
            job = stepper.run_one_step()
            if job.schema_state == int(r.pkg.State.WRITE_REORG):
                break

        def crash(jb, cnt):
            raise Crash()
        with pytest.raises(Crash):
            r.pkg.Worker(r.storage,
                         on_backfill_batch=crash)._backfill_index(job)
        txn, m = r.meta()
        try:
            jb = m.first_job()
        finally:
            txn.rollback()
        resumed = []
        done = r.pkg.Worker(r.storage, on_backfill_batch=lambda j, c:
                            resumed.append(c)).run_job(jb.id)
        return (jb.reorg_handle, done.state.name, sum(resumed),
                r.entries("t", "ib"))
    checkpoint, _state, resumed, entries = parity(scenario)
    assert checkpoint == PBATCH - 1
    assert resumed == n - PBATCH and entries == n


def test_unique_violation_rolls_the_job_back():
    def scenario(r):
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
        r.s.execute("INSERT INTO t VALUES (1, 5), (2, 5)")
        with pytest.raises(Exception, match="[Dd]uplicate"):
            r.s.execute("ALTER TABLE t ADD UNIQUE INDEX ub (b)")
        info = r.s.domain.info_schema().table("test", "t")
        r.s.execute("INSERT INTO t VALUES (3, 5)")
        return info.index_by_name("ub") is None, r.q("SELECT * FROM t")
    assert parity(scenario)[0]


def test_schema_versions_and_index_ids():
    def scenario(r):
        txn, m = r.meta()
        v0 = m.schema_version()
        txn.rollback()
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT, "
                    "KEY k1 (b))")
        r.s.execute("CREATE INDEX ib ON t (b)")
        txn, m = r.meta()
        try:
            v1 = m.schema_version()
        finally:
            txn.rollback()
        id1 = r.s.domain.info_schema().table("test", "t") \
            .index_by_name("k1").id
        r.s.execute("DROP INDEX k1 ON t")
        r.s.execute("CREATE INDEX k2 ON t (b)")
        id2 = r.s.domain.info_schema().table("test", "t") \
            .index_by_name("k2").id
        return v1 - v0, id1, id2
    dv, id1, id2 = parity(scenario)
    assert dv == 5 and id2 > id1


def test_truncate_and_rename():
    def scenario(r):
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT, KEY kb (b))")
        r.s.execute("INSERT INTO t VALUES (1, 1), (2, 2)")
        old = r.s.domain.info_schema().table("test", "t").id
        r.s.execute("TRUNCATE TABLE t")
        new = r.s.domain.info_schema().table("test", "t").id
        empty = r.q("SELECT COUNT(*) FROM t")
        r.s.execute("INSERT INTO t VALUES (3, 3)")
        r.s.execute("RENAME TABLE t TO u")
        r.s.execute("ALTER TABLE u RENAME TO v")
        r.s.execute("ALTER TABLE v MODIFY COLUMN b BIGINT")
        txn, m = r.meta()
        try:
            ranges = len(m.pending_delete_ranges())
        finally:
            txn.rollback()
        return (new != old, empty, r.q("SELECT * FROM v WHERE b = 3"),
                ranges)
    assert parity(scenario) == (True, [(0,)], [(3, 3)], 1)


# -- the index readers and joins through SQL ---------------------------------

_SETUP = [
    "CREATE TABLE c (c_id BIGINT PRIMARY KEY, c_nation BIGINT, "
    "c_seg VARCHAR(10), KEY i_nation (c_nation, c_seg))",
    "CREATE TABLE o (o_id BIGINT PRIMARY KEY, o_cust BIGINT, "
    "o_amt DECIMAL(12,2), KEY i_cust (o_cust))",
    "INSERT INTO c VALUES " + ", ".join(
        f"({i}, {i % 5}, '{'AB'[i % 2]}{i % 3}')" for i in range(60)),
    "INSERT INTO o VALUES " + ", ".join(
        f"({i}, {i * 13 % 70}, {i % 17}.50)" for i in range(400)),
]

QUERIES = {
    "index_reader_agg": "SELECT n, COUNT(*) FROM (SELECT c_nation AS n "
                        "FROM c WHERE c_nation IN (1, 3)) x GROUP BY n "
                        "ORDER BY n",
    "index_reader_scan": "SELECT c_nation, c_seg FROM c WHERE c_nation > 2 "
                         "ORDER BY c_id",
    "index_lookup": "SELECT o_id, o_amt FROM o WHERE o_cust = 12 "
                    "ORDER BY o_id",
    "index_lookup_agg": "SELECT m, COUNT(*), SUM(a) FROM (SELECT o_cust AS "
                        "m, o_amt AS a FROM o WHERE o_cust < 9) x "
                        "GROUP BY m ORDER BY m",
    "join_on_handle": "SELECT o_id, c_seg FROM o, c WHERE o_cust = c_id "
                      "AND o_id < 40 ORDER BY o_id",
    "join_on_index": "SELECT c_id, o_id FROM c, o WHERE c_id = o_cust "
                     "AND c_id < 6 ORDER BY c_id, o_id",
    "left_join": "SELECT c_id, o_id FROM c LEFT JOIN o ON c_id = o_cust "
                 "WHERE c_id < 8 ORDER BY c_id, o_id",
    "join_agg": "SELECT c_nation, COUNT(*), SUM(o_amt) FROM c, o "
                "WHERE c_id = o_cust GROUP BY c_nation ORDER BY c_nation",
    "self_merge": "SELECT x.c_id, y.c_seg FROM c x, c y "
                  "WHERE x.c_id = y.c_id ORDER BY x.c_id",
    "merge_left": "SELECT x.o_id, y.o_amt FROM o x LEFT JOIN o y "
                  "ON x.o_id = y.o_id AND y.o_amt > 10 ORDER BY x.o_id",
}


def _plan_ops(pair, sql):
    return [r[0] for r in pair.run("EXPLAIN " + sql)[0]]


@pytest.fixture
def indexed(env):  # noqa: F811 - the imported fixture
    a, b, stores = env
    for sql in _SETUP:
        a.run(sql)
    return a, b, stores


@pytest.mark.parametrize("analyzed", [False, True])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_index_paths_equal_the_reference(indexed, name, analyzed):
    a, _b, _stores = indexed
    if analyzed:
        a.run("ANALYZE TABLE c, o")
    sql = QUERIES[name]
    _plan_ops(a, sql)
    a.run(sql)
    with sysvars({"tidb_tpu_device_min_rows": 1}):
        a.run(sql)


def test_the_index_operators_are_reached(indexed):
    a, _b, _stores = indexed
    a.run("ANALYZE TABLE c, o")
    seen = " ".join(" ".join(_plan_ops(a, sql)) for sql in QUERIES.values())
    for op in ("IndexReader", "IndexLookUp", "IndexJoin", "MergeJoin"):
        assert op in seen, op


def test_index_lookup_with_one_scheduler_slot(indexed):
    """The lookup's table plans run on the statement's thread: with one
    scheduler slot and the device path, no dispatch waits out the
    bypass valve."""
    a, _b, _stores = indexed
    a.run("INSERT INTO o VALUES " + ", ".join(
        f"({i}, 5, 1.25)" for i in range(1000, 3600)))
    sql = "SELECT m, COUNT(*), SUM(a) FROM (SELECT o_cust AS m, o_amt AS " \
          "a FROM o WHERE o_cust = 5) x GROUP BY m"
    assert "IndexLookUp" in " ".join(_plan_ops(a, sql))
    before = psched.stats()["scheduler"]["bypasses"]
    with sysvars({"tidb_tpu_sched_inflight": 1,
                  "tidb_tpu_device_min_rows": 1}):
        a.run(sql)
    assert psched.stats()["scheduler"]["bypasses"] == before


def test_dirty_transaction_reads_through_the_index_paths(indexed):
    a, _b, stores = indexed
    a.run("ANALYZE TABLE c, o")
    a.run("BEGIN")
    a.run("INSERT INTO c VALUES (500, 1, 'N')")
    a.run("UPDATE c SET c_nation = 1 WHERE c_id = 2")
    a.run("DELETE FROM c WHERE c_id = 6")
    a.run("INSERT INTO o VALUES (900, 500, 1.00), (901, 2, 2.00)")
    for sql in QUERIES.values():
        a.run(sql)
    a.run("COMMIT")
    for sql in QUERIES.values():
        a.run(sql)
    assert table_kv(stores[1], port=True) == table_kv(stores[0], port=False)


def test_ddl_recolds_and_index_writes_do_not():
    """A DDL's meta commits bump the engine's data_version (every cached
    chunk and HBM block goes cold), the backfill's batches included,
    since each commits the job's checkpoint with its index entries; an
    INSERT into the indexed table, whose index keys only advance a
    watermark, does not. The counts are the reference's."""
    n = PBATCH * 2 + 10

    def scenario(r):
        r.s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
        r.s.execute("INSERT INTO t VALUES " + _rows(n))
        v0 = r.storage.engine.data_version
        batches = []
        r.ddl("CREATE INDEX ib ON t (b)", r.pkg.Worker(
            r.storage, on_backfill_batch=lambda jb, c: batches.append(c)))
        v1 = r.storage.engine.data_version
        r.s.execute(f"INSERT INTO t VALUES ({n}, 1)")
        return len(batches), v1 - v0, r.storage.engine.data_version - v1
    batches, ddl_bumps, insert_bumps = parity(scenario)
    assert batches == 3 and ddl_bumps > batches and insert_bumps == 0
