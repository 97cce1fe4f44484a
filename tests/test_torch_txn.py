"""Transactions and SQL writes in the port against the JAX package.

Each test runs the same statements through both packages' `Session`,
each over a fresh mock store of its own (the port's on `device="cpu"`,
where the segment-sum kernel runs as its plain version), and holds:

  * every statement's result equal: rows (integer and DECIMAL lanes
    exact), affected-row counts, and the error where the reference
    raises one;
  * after each commit, every table-data KV pair (record and index keys)
    byte-equal;
  * BEGIN / COMMIT / ROLLBACK, `autocommit = 0`, own writes visible
    inside a transaction (the union scan, in scan and aggregate plans),
    snapshot isolation between sessions, the commit retry's replay of a
    conflicted transaction, statement-level atomicity after a failed
    statement, the schema check at commit, UPDATE and DELETE in their
    single- and multi-table forms with a primary-key move, SELECT ...
    FOR UPDATE and its conflicts (ported from tests/test_session.py's
    transaction cases, tests/test_select_for_update.py and
    tests/test_htap.py's visibility case, without the wire);
  * TPC-H lineitem write batches as SQL (`tpch.sql_batch`) at SF 0.01:
    the delta journal's rows, the HBM block cache's hits and misses and
    the patch count equal the reference's, and Q1 equals `Q1Mirror`'s
    truth, after a rolled-back and a committed batch.
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from tidb_tpu import config as jconfig
from tidb_tpu import metrics as jmetrics
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.kv import IsolationLevel as JIso
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import metrics as pmetrics
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.kv import IsolationLevel as PIso
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

TS = 1 << 62


@contextlib.contextmanager
def sysvars(values):
    """Set the same sysvars in both packages' registries."""
    old = {k: (jconfig.get_var(k), pconfig.get_var(k)) for k in values}
    for k, v in values.items():
        jconfig.set_var(k, v)
        pconfig.set_var(k, v)
    try:
        yield
    finally:
        for k, (jv, pv) in old.items():
            jconfig.set_var(k, jv)
            pconfig.set_var(k, pv)


def _value(r):
    return r.rows if hasattr(r, "rows") else r


def _same(got, want) -> bool:
    if isinstance(want, float) or isinstance(got, float):
        return math.isclose(got, want, rel_tol=1e-9)
    if isinstance(want, (list, tuple)):
        return isinstance(got, (list, tuple)) and len(got) == len(want) \
            and all(_same(a, b) for a, b in zip(got, want))
    return type(got) is type(want) and got == want


class Pair:
    """The same SQL through one session of each package."""

    def __init__(self, pair_of_stores, db="test"):
        self.stores = pair_of_stores
        self.j = JSession(pair_of_stores[0], db=db)
        self.p = PSession(pair_of_stores[1], db=db)

    def run(self, sql):
        """Run `sql` in both; -> the port's results, after holding them
        equal to the reference's (or both raising)."""
        want = got = None
        try:
            want = [_value(r) for r in self.j.execute(sql)]
        except Exception as e:   # noqa: BLE001 - compared below
            want = e
        try:
            got = [_value(r) for r in self.p.execute(sql)]
        except Exception as e:   # noqa: BLE001 - compared below
            got = e
        if isinstance(want, Exception) or isinstance(got, Exception):
            assert type(got).__name__ == type(want).__name__, (sql, got,
                                                               want)
            raise got
        assert _same(got, want), (sql, got, want)
        return got

    def raises(self, sql, match=None):
        with pytest.raises(Exception, match=match) as ei:
            self.run(sql)
        return ei.value

    def close(self):
        self.j.close()
        self.p.close()


def table_kv(store, port: bool) -> dict:
    """Every table-data KV pair (record and index keys) of `store`."""
    kvs = store.engine.scan(b"t", b"u", 1 << 30, TS,
                            PIso.SI if port else JIso.SI)
    return dict(kvs)


@pytest.fixture
def env():
    """(pair, second pair, stores): two session pairs over one store per
    package, in database `test`."""
    stores = (jnew_storage(), pnew_storage(device="cpu"))
    for st in stores:
        st.async_commit_secondaries = False
    a = Pair(stores, db="")
    a.run("CREATE DATABASE test")
    a.run("USE test")
    b = Pair(stores)
    yield a, b, stores
    a.close()
    b.close()
    for st in stores:
        st.close()


def same_kv(stores):
    want = table_kv(stores[0], port=False)
    got = table_kv(stores[1], port=True)
    assert got == want
    return len(got)


# -- BEGIN / COMMIT / ROLLBACK ------------------------------------------------

def test_own_writes_visible_then_rolled_back(env):
    a, _b, stores = env
    a.run("CREATE TABLE t (id BIGINT PRIMARY KEY, v INT)")
    a.run("INSERT INTO t VALUES (1, 1)")
    a.run("BEGIN")
    a.run("INSERT INTO t VALUES (2, 2)")
    assert a.run("UPDATE t SET v = 100 WHERE id = 1") == [1]
    assert a.run("SELECT v FROM t ORDER BY id") == [[(100,), (2,)]]
    a.run("ROLLBACK")
    assert a.run("SELECT v FROM t ORDER BY id") == [[(1,)]]
    assert same_kv(stores) == 1


def test_commit_persists(env):
    a, _b, stores = env
    a.run("CREATE TABLE t (id BIGINT PRIMARY KEY, v INT)")
    a.run("BEGIN; INSERT INTO t VALUES (1, 5); COMMIT")
    assert a.run("SELECT v FROM t") == [[(5,)]]
    same_kv(stores)


def test_two_sessions_snapshot_isolation(env):
    a, b, stores = env
    a.run("CREATE TABLE t (id BIGINT PRIMARY KEY, v INT)")
    a.run("INSERT INTO t VALUES (1, 1)")
    b.run("BEGIN")
    assert b.run("SELECT v FROM t") == [[(1,)]]
    a.run("UPDATE t SET v = 2 WHERE id = 1")
    assert b.run("SELECT v FROM t") == [[(1,)]]     # b's snapshot
    b.run("COMMIT")
    assert b.run("SELECT v FROM t") == [[(2,)]]
    same_kv(stores)


def test_conflicted_commit_replays_its_history(env):
    a, b, stores = env
    a.run("CREATE TABLE t (id BIGINT PRIMARY KEY, v INT)")
    a.run("INSERT INTO t VALUES (1, 0)")
    a.run("BEGIN")
    a.run("UPDATE t SET v = v + 1 WHERE id = 1")
    b.run("UPDATE t SET v = v + 10 WHERE id = 1")   # commits first
    a.run("COMMIT")                                  # retried by replay
    assert a.run("SELECT v FROM t") == [[(11,)]]
    same_kv(stores)


def test_autocommit_off_keeps_the_transaction_open(env):
    a, b, stores = env
    a.run("CREATE TABLE t (id BIGINT PRIMARY KEY, v INT)")
    a.run("SET @@autocommit = 0")
    a.run("INSERT INTO t VALUES (1, 1)")
    assert a.p.txn is not None and a.j.txn is not None
    assert b.run("SELECT COUNT(*) FROM t") == [[(0,)]]
    a.run("UPDATE t SET v = 7 WHERE id = 1")
    a.run("COMMIT")
    a.run("SET @@autocommit = 1")
    assert b.run("SELECT v FROM t") == [[(7,)]]
    same_kv(stores)


def test_failed_statement_rolls_back_only_itself(env):
    a, _b, stores = env
    a.run("CREATE TABLE t (id BIGINT PRIMARY KEY, v INT, UNIQUE KEY uv (v))")
    a.run("INSERT INTO t VALUES (1, 1)")
    a.run("BEGIN")
    a.run("INSERT INTO t VALUES (2, 2)")
    # the second row collides on uv: the whole statement goes, the txn
    # stays
    a.raises("INSERT INTO t VALUES (3, 3), (4, 1)")
    assert a.run("SELECT id FROM t ORDER BY id") == [[(1,), (2,)]]
    a.run("COMMIT")
    assert a.run("SELECT id, v FROM t ORDER BY id") == [[(1, 1), (2, 2)]]
    assert same_kv(stores) == 4


def test_implicit_commit_before_ddl(env):
    a, b, stores = env
    a.run("CREATE TABLE t (id BIGINT PRIMARY KEY)")
    a.run("BEGIN")
    a.run("INSERT INTO t VALUES (1)")
    a.run("CREATE TABLE u (id BIGINT PRIMARY KEY)")
    assert a.p.txn is None and a.j.txn is None
    assert b.run("SELECT id FROM t") == [[(1,)]]
    same_kv(stores)


# -- UPDATE / DELETE ----------------------------------------------------------

_SETUP = ["CREATE TABLE t (id BIGINT PRIMARY KEY, v INT, d DECIMAL(10,2), "
          "s VARCHAR(8), KEY iv (v), UNIQUE KEY us (s))",
          "CREATE TABLE u (k BIGINT PRIMARY KEY, w INT, KEY iw (w))",
          "INSERT INTO t VALUES (1, 10, 1.50, 'a'), (2, 20, 2.25, 'b'), "
          "(3, 30, NULL, 'c'), (4, 40, 4.00, NULL)",
          "INSERT INTO u VALUES (1, 100), (2, 200), (9, 900)"]

WRITES = {
    "update_arith": ["UPDATE t SET v = v * 2, d = d + 0.5 WHERE id > 1"],
    "update_all_nulls": ["UPDATE t SET d = NULL, s = NULL"],
    "update_order_limit": ["UPDATE t SET v = 0 ORDER BY v DESC LIMIT 2"],
    "update_pk_move": ["UPDATE t SET id = id + 10 WHERE id < 3",
                       "SELECT id, v FROM t WHERE v = 20"],
    "update_pk_move_collides": ["UPDATE t SET id = 2 WHERE id = 1"],
    "update_unique_collides": ["UPDATE t SET s = 'a' WHERE id = 2"],
    "delete_where": ["DELETE FROM t WHERE v >= 20 AND v < 40"],
    "delete_in": ["DELETE FROM t WHERE id IN (1, 4, 7)"],
    "delete_order_limit": ["DELETE FROM t ORDER BY v LIMIT 3"],
    "multi_update": ["UPDATE t, u SET t.v = u.w, u.w = u.w + 1 "
                     "WHERE t.id = u.k"],
    "multi_update_pk_move": ["UPDATE t, u SET t.id = t.id + 100 "
                             "WHERE t.id = u.k"],
    "multi_delete": ["DELETE t, u FROM t, u WHERE t.id = u.k AND u.w > 150"],
    "multi_delete_using": ["DELETE FROM t USING t, u WHERE t.id = u.k"],
}


@pytest.mark.parametrize("in_txn", [False, True])
@pytest.mark.parametrize("name", sorted(WRITES))
def test_writes_equal_the_reference(env, name, in_txn):
    a, _b, stores = env
    for sql in _SETUP:
        a.run(sql)
    if in_txn:
        a.run("BEGIN")
    for sql in WRITES[name]:
        try:
            a.run(sql)
        except Exception:   # noqa: BLE001 - both raised, held by run()
            pass
    # inside the txn the reads go through the union store
    for q in ("SELECT id, v, d, s FROM t ORDER BY id",
              "SELECT COUNT(*), SUM(v), SUM(d), MAX(s) FROM t",
              "SELECT v, COUNT(*) FROM t GROUP BY v ORDER BY v",
              "SELECT k, w FROM u ORDER BY k",
              "SELECT id FROM t WHERE v = 20",
              "SELECT t.id, u.w FROM t, u WHERE t.id = u.k ORDER BY t.id"):
        a.run(q)
    if in_txn:
        a.run("COMMIT")
    same_kv(stores)


# -- the union scan -----------------------------------------------------------

UNION_QUERIES = [
    "SELECT * FROM t ORDER BY id",
    "SELECT id, v FROM t WHERE v > 15 AND s IS NOT NULL ORDER BY id",
    "SELECT COUNT(*), SUM(v), SUM(d), MIN(d), MAX(v) FROM t",
    "SELECT v % 3, COUNT(*), SUM(d) FROM t GROUP BY v % 3 ORDER BY 1",
    "SELECT id FROM t ORDER BY id LIMIT 2",
]


@pytest.mark.parametrize("min_rows", [1, 2048])
@pytest.mark.parametrize("sql", UNION_QUERIES)
def test_union_scan_reads_own_writes(env, sql, min_rows):
    """A dirty transaction's scan and aggregate plans through the union
    store: on the device path (tidb_tpu_device_min_rows = 1) and on the
    host path below it; the table the transaction emptied gives the
    final empty chunk."""
    a, _b, _stores = env
    for q in _SETUP[:1] + _SETUP[2:3]:
        a.run(q)
    with sysvars({"tidb_tpu_device_min_rows": min_rows}):
        a.run("BEGIN")
        a.run("INSERT INTO t VALUES (5, 50, 5.55, 'e')")
        a.run("UPDATE t SET v = v + 1, d = d * 2 WHERE id = 2")
        a.run("DELETE FROM t WHERE id = 3")
        a.run(sql)
        a.run("DELETE FROM t")
        a.run(sql)
        a.run("ROLLBACK")
        a.run(sql)


def test_committed_write_visible_to_the_next_analytic_read(env):
    """A committed write is visible to the next read of a warm, cached
    aggregate (served as base ⋈ delta), as the reference's wire test
    holds."""
    a, b, stores = env
    n = 3000
    a.run("CREATE TABLE stock (s_id BIGINT PRIMARY KEY, s_seg BIGINT, "
          "s_qty BIGINT, s_cnt BIGINT)")
    a.run("INSERT INTO stock VALUES " + ", ".join(
        f"({i}, {i % 7}, 50, 0)" for i in range(n)))
    q = "SELECT COUNT(*), SUM(s_qty), MAX(s_cnt) FROM stock"
    with sysvars({"tidb_tpu_device_min_rows": 1}):
        a.run(q)
        a.run(q)
        served = (jmetrics.snapshot().get(jmetrics.CACHE_DELTA_SERVES, 0),
                  pmetrics.snapshot().get(pmetrics.CACHE_DELTA_SERVES, 0))
        for i in range(1, 6):
            b.run(f"UPDATE stock SET s_qty = s_qty - 1, s_cnt = {i} "
                  f"WHERE s_id = {i}")
            got = a.run(q)[0][0]
            assert (got[0], int(got[1]), got[2]) == (n, 50 * n - i, i)
    assert jmetrics.snapshot().get(jmetrics.CACHE_DELTA_SERVES, 0) > \
        served[0]
    assert pmetrics.snapshot().get(pmetrics.CACHE_DELTA_SERVES, 0) > \
        served[1]
    same_kv(stores)


# -- the schema check at commit ----------------------------------------------

def test_commit_after_ddl_on_a_written_table_replays(env):
    a, b, stores = env
    a.run("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
    a.run("BEGIN")
    a.run("INSERT INTO t VALUES (1, 10)")
    b.run("CREATE INDEX ib ON t (b)")
    a.run("COMMIT")          # SchemaChangedError -> replay
    assert a.run("SELECT a FROM t WHERE b = 10") == [[(1,)]]
    assert same_kv(stores) == 2


def test_commit_after_unrelated_ddl_passes(env):
    a, b, stores = env
    a.run("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
    a.run("CREATE TABLE u (x BIGINT PRIMARY KEY)")
    a.run("BEGIN")
    a.run("INSERT INTO t VALUES (1, 10)")
    b.run("CREATE INDEX ix ON u (x)")
    a.run("COMMIT")
    assert a.run("SELECT * FROM t") == [[(1, 10)]]
    same_kv(stores)


def test_multi_update_commit_checks_its_targets_schema(env):
    """A multi-table UPDATE whose target gained an index before COMMIT:
    the port's schema check covers the UPDATE's targets, so the commit
    replays and the new index holds the updated value. The reference
    adds no target of a multi-table UPDATE to the checked tables
    (tidb_tpu/session/__init__.py, _exec_dml_in_txn) and commits the
    row without its index entry (ROADMAP §C)."""
    a, b, stores = env
    a.run("CREATE TABLE t (id BIGINT PRIMARY KEY, v INT)")
    a.run("CREATE TABLE u (k BIGINT PRIMARY KEY, w INT)")
    a.run("INSERT INTO t VALUES (1, 5)")
    a.run("INSERT INTO u VALUES (1, 7)")
    for s in (a.j, a.p):
        s.execute("BEGIN")
        s.execute("UPDATE t, u SET t.v = u.w + 100 WHERE t.id = u.k")
    b.run("CREATE INDEX iv ON t (v)")
    for s in (a.j, a.p):
        s.execute("COMMIT")
    q = "SELECT id FROM t WHERE v = 107"
    assert a.p.query(q).rows == [(1,)]
    assert a.j.query(q).rows == []           # the reference's fault
    info = a.p.domain.info_schema().table("test", "t")
    idx = info.index_by_name("iv")
    from tidb_tpu_torch import codec, tablecodec
    prefix = tablecodec.index_prefix(info.id, idx.id)
    got = table_kv(stores[1], port=True)
    assert sum(k.startswith(prefix) for k in got) == 1


# -- SELECT ... FOR UPDATE ----------------------------------------------------

@pytest.fixture
def locked(env):
    a, b, stores = env
    a.run("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    a.run("INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)")
    return a, b, stores


def test_for_update_conflict_is_not_replayed(locked):
    a, b, stores = locked
    a.run("BEGIN")
    assert a.run("SELECT v FROM t WHERE id = 1 FOR UPDATE") == [[(10,)]]
    b.run("UPDATE t SET v = 99 WHERE id = 1")
    a.run("INSERT INTO t VALUES (9, 90)")
    a.raises("COMMIT")
    assert b.run("SELECT v FROM t WHERE id = 1") == [[(99,)]]
    assert b.run("SELECT COUNT(*) FROM t WHERE id = 9") == [[(0,)]]
    same_kv(stores)


def test_for_update_clean_commit_and_lock_only(locked):
    a, b, stores = locked
    a.run("BEGIN")
    a.run("SELECT v FROM t WHERE id = 2 FOR UPDATE")
    a.run("UPDATE t SET v = 21 WHERE id = 2")
    a.run("COMMIT")
    a.run("BEGIN")
    a.run("SELECT v FROM t WHERE id = 2 FOR UPDATE")
    a.run("COMMIT")
    b.run("BEGIN")
    b.run("SELECT v FROM t WHERE id = 1 FOR UPDATE")
    a.run("UPDATE t SET v = 111 WHERE id = 3")       # another row
    b.run("UPDATE t SET v = 11 WHERE id = 1")
    b.run("COMMIT")
    assert b.run("SELECT v FROM t ORDER BY id") == [[(11,), (21,), (111,)]]
    same_kv(stores)


@pytest.mark.parametrize("sql", [
    "SELECT x.v FROM t x, t y WHERE x.id = y.id AND x.id = 1 FOR UPDATE",
    "SELECT * FROM (SELECT v FROM t FOR UPDATE) x"])
def test_for_update_beyond_one_table_is_refused(locked, sql):
    a, _b, _stores = locked
    a.run("BEGIN")
    a.raises(sql, match="single-table")
    assert a.run("SELECT 1 FOR UPDATE") == [[(1,)]]
    a.run("ROLLBACK")


def test_for_update_under_autocommit_off_starts_a_transaction(locked):
    a, _b, _stores = locked
    a.run("SET @@autocommit = 0")
    assert a.p.txn is None
    a.run("SELECT v FROM t WHERE id = 1 FOR UPDATE")
    assert a.p.txn is not None and a.p.txn.lock_keys == a.j.txn.lock_keys
    a.run("ROLLBACK")
    a.run("SET @@autocommit = 1")
    assert a.run("SELECT v FROM t WHERE id = 1 FOR UPDATE") == [[(10,)]]
    assert a.p.txn is None


# -- TPC-H write batches as SQL ----------------------------------------------

SF = 0.01


@pytest.fixture(scope="module")
def tpch_pair():
    d = ptpch.ScaledTpch(SF, 42)
    stores = (jnew_storage(), pnew_storage(device="cpu"))
    sessions = (JSession(stores[0]), PSession(stores[1]))
    for st, s, mod in zip(stores, sessions, (jtpch, ptpch)):
        st.async_commit_secondaries = False
        s.execute("CREATE DATABASE tpch")
        s.execute("USE tpch")
        mod.load(s, st, mod.ScaledTpch(SF, 42))
    yield d, stores, sessions
    for st, s in zip(stores, sessions):
        s.close()
        st.close()


def _hbm(metrics_mod) -> tuple:
    snap = metrics_mod.snapshot()

    def total(name):
        return sum(v for k, v in snap.items()
                   if k == name or k.startswith(name + "{"))
    return (total(metrics_mod.HBM_CACHE_HITS),
            total(metrics_mod.HBM_CACHE_MISSES))


def _patches(cache) -> int:
    """Blocks `cache` patched during the next Q1 (the reference keeps no
    patch counter: each package's DeviceCache._patch_locked is wrapped)."""
    orig = cache._patch_locked
    count = [0]

    def counted(*a, **kw):
        out = orig(*a, **kw)
        count[0] += out is not None
        return out
    cache._patch_locked = counted
    return count


def _q1_both(stores, sessions):
    """Q1 through both; -> (rows, (hits, misses, patches, journal rows))
    of each package over the run, the reference's first."""
    out = []
    rows = []
    for st, s, m in zip(stores, sessions, (jmetrics, pmetrics)):
        h0 = _hbm(m)
        count = _patches(st.device_cache)
        try:
            rows.append(s.query(ptpch.Q1).rows)
        finally:
            del st.device_cache._patch_locked
        h1 = _hbm(m)
        out.append((h1[0] - h0[0], h1[1] - h0[1], count[0],
                    st.delta_store.rows_current()))
    return rows, out


def test_sql_batches_patch_the_blocks_as_the_reference(tpch_pair):
    d, stores, sessions = tpch_pair
    mirror = ptpch.Q1Mirror(d)
    n = d.counts["lineitem"]
    with sysvars({"tidb_tpu_device_min_rows": 1}):
        _q1_both(stores, sessions)
        (jrows, rows), (jw, pw) = _q1_both(stores, sessions)  # HBM fill
        assert rows == jrows and pw == jw and pw[1] == 4
        b = ptpch.write_batch(d, np.arange(n), 7, updates=200, inserts=50,
                              deletes=50, next_handle=n, new_flag="X")
        stmts = ptpch.sql_batch(b)
        assert len(stmts) == 202
        # rolled back: Q1 stays hot, nothing journaled or patched
        for s in sessions:
            s.execute("BEGIN")
            for sql in stmts[:100]:
                s.execute(sql)
            s.execute("ROLLBACK")
        (jrows, rows), (jr, pr) = _q1_both(stores, sessions)
        assert rows == jrows == ptpch.as_session_rows("q1", mirror.truth())
        assert pr == jr == (4, 0, 0, 0)
        # committed: journaled once, the touched blocks patched
        for s in sessions:
            s.execute("BEGIN")
            for sql in stmts:
                s.execute(sql)
            s.execute("COMMIT")
        mirror.apply(b)
        # the reference finalizes a patched block at device positions
        # and its rows differ from the truth by design (ROADMAP §C):
        # only its counters are held
        (_jrows, rows), (jc, pc) = _q1_both(stores, sessions)
        assert rows == ptpch.as_session_rows("q1", mirror.truth())
        assert pc == jc and pc[2] > 0 and pc[3] == 300
    assert table_kv(stores[1], port=True) == table_kv(stores[0],
                                                      port=False)


def _live_keys(base):
    """A SortedDict whose irange iterates the live key list, and raises
    if a key is added under the iterator, as `sortedcontainers` does
    when an insert splits the sublist it iterates."""
    class Live(base):
        def __setitem__(self, key, value):
            if key not in self:
                self.generation = getattr(self, "generation", 0) + 1
            super().__setitem__(key, value)

        def irange(self, *a, **kw):
            gen = getattr(self, "generation", 0)
            for k in super().irange(*a, **kw):
                if getattr(self, "generation", 0) != gen:
                    raise IndexError("list index out of range")
                yield k
    return Live


def test_dml_through_the_union_scan_past_one_chunk(monkeypatch):
    """A DELETE in a transaction that wrote its table reads through the
    union scan, whose reader yields a chunk per 65,536 rows while the
    statement writes its tombstones into the same buffer. The reference
    iterates the buffer's live key tree (tidb_tpu/kv/__init__.py,
    MemBuffer.iter_range) and fails where the tree changes under the
    iterator (IndexError with `sortedcontainers`; ROADMAP §C); the port
    iterates the keys the range held when the scan began."""
    from tidb_tpu import kv as jkv
    from tidb_tpu.table import Table as JTable
    from tidb_tpu.table import bulkload as jbulkload
    from tidb_tpu.util import sorteddict as jsd
    from tidb_tpu_torch import kv as pkv
    from tidb_tpu_torch.table import Table as PTable
    from tidb_tpu_torch.table import bulkload as pbulkload
    from tidb_tpu_torch.util import sorteddict as psd
    n = 66_000
    cols = {"id": np.arange(n, dtype=np.int64),
            "v": np.arange(n, dtype=np.int64) % 7}
    out = {}
    for name, new, kvm, sd, table, bulk, sess in (
            ("ref", jnew_storage, jkv, jsd, JTable, jbulkload, JSession),
            ("port", lambda: pnew_storage(device="cpu"), pkv, psd, PTable,
             pbulkload, PSession)):
        st = new()
        s = sess(st)
        s.execute("CREATE DATABASE d; USE d")
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
        bulk.bulk_load(st, table(s.domain.info_schema().table("d", "t"),
                                 st), cols)
        live = _live_keys(sd.SortedDict)
        real_init = kvm.MemBuffer.__init__

        def init(self, real_init=real_init, live=live):
            real_init(self)
            self._d = live()
        monkeypatch.setattr(kvm.MemBuffer, "__init__", init)
        s.execute("BEGIN")
        # dirty keys all through the table: the buffer's iterator is
        # still live when the scan's first chunk reaches the DELETE
        s.execute("UPDATE t SET v = 100 WHERE v = 3")
        try:
            out[name] = s.execute("DELETE FROM t WHERE v < 7")
        except IndexError as e:
            out[name] = e
        out[name + "_left"] = s.query("SELECT COUNT(*) FROM t").rows
        s.execute("ROLLBACK")
        s.close()
        st.close()
    kept = int((cols["v"] == 3).sum())
    assert isinstance(out["ref"], IndexError)
    assert out["port"] == [n - kept] and out["port_left"] == [(kept,)]
