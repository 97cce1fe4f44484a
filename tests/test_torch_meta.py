"""The metadata plane and DDL in the port (structure/, meta/, ddl/, the
auto-increment ids of table/) against the JAX package's, each over a
fresh mock store.

  * the same operations through TxStructure write byte-equal KV pairs;
  * after the same DDL and INSERT sequence through each package's
    Session, every KV pair of the store (meta, schema versions and
    diffs, DDL job history, table records and index entries) is
    byte-equal, the DDL owner lease (`m_owner_ddl`) included, with two
    values masked: that lease's (it names each process's owner id and
    lease expiry) and the timestamp that seals a dropped table's delete
    range (an oracle time, different in each run);
  * the TableInfos that CREATE TABLE makes from tpch.DDL have the
    columns, types, flags and primary-key handle of the hand-built
    `tpch.table_infos()` the earlier storage path uses (ids may differ);
  * INSERT into a table without a primary key allocates the same handles
    in both packages (auto-id batches of Table.AUTO_ID_STEP from meta),
    and Table.alloc_auto_id / rebase_auto_id no longer raise.
"""

import json

import pytest
import torch

from tidb_tpu.kv import IsolationLevel as JIso
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu.structure import TxStructure as JTxStructure
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.kv import IsolationLevel as PIso
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage
from tidb_tpu_torch.structure import TxStructure as PTxStructure
from tidb_tpu_torch.table import Table as PTable

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

TS = 1 << 62
_DDL = [s for s in ptpch.DDL.split(";") if s.strip()]

SEQUENCES = {
    "tpch": ["CREATE DATABASE tpch", "USE tpch"] + _DDL,
    "indexes_and_inserts": [
        "CREATE DATABASE d", "USE d",
        "CREATE TABLE t (a BIGINT, b VARCHAR(10) UNIQUE, "
        "c DECIMAL(10,2), INDEX ic (c))",
        "INSERT INTO t VALUES (1, 'x', 1.5), (2, NULL, 2.25)",
        "INSERT INTO t (a) VALUES (7)",
        "CREATE TABLE u (k BIGINT PRIMARY KEY, v DATE)",
        "INSERT INTO u VALUES (3, '1995-03-15'), (9, NULL)",
        "INSERT INTO t (a, c) SELECT k, 0.5 FROM u"],
    "drops": ["CREATE DATABASE tpch", "USE tpch"] + _DDL + [
        "DROP TABLE nation", "DROP TABLE IF EXISTS nation, region",
        "CREATE DATABASE other", "USE other",
        "CREATE TABLE x (a BIGINT)", "DROP DATABASE other"],
}


def _store_kv(seq, port: bool):
    st = pnew_storage(device="cpu") if port else jnew_storage()
    s = (PSession if port else JSession)(st)
    try:
        for sql in seq:
            s.execute(sql)
        return st.engine.scan(b"", b"\xff" * 8, 1 << 30, TS,
                              PIso.SI if port else JIso.SI)
    finally:
        s.close()
        st.close()


def _unstamped(kvs):
    """KV pairs without the DDL owner lease (its value names each
    process's owner id and lease expiry), with the oracle timestamp of
    each sealed delete range checked and masked."""
    out = {}
    for k, v in kvs:
        if k == b"m_owner_ddl":
            continue
        if k.startswith(b"mhDeleteRanges"):
            rec = json.loads(v)
            assert rec.pop("ts") > 0
            v = json.dumps(rec).encode()
        out[k] = v
    return out


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_ddl_and_insert_kv_pairs_byte_equal(name):
    want = _store_kv(SEQUENCES[name], port=False)
    got = _store_kv(SEQUENCES[name], port=True)
    assert any(k == b"m_owner_ddl" for k, _v in want)
    assert any(k == b"m_owner_ddl" for k, _v in got)
    assert _unstamped(got) == _unstamped(want)
    assert len(got) == len(want)


def _structure_ops(s):
    s.set(b"k", b"v")
    s.inc(b"n", 5)
    s.inc(b"n", -2)
    s.hset(b"h", b"f1", b"a")
    s.hset(b"h", b"f2", b"b")
    s.hdel(b"h", b"f1")
    s.rpush(b"l", b"1", b"2", b"3")
    s.lpush(b"l", b"0")
    s.lset(b"l", 2, b"two")
    s.lpop(b"l")
    s.lrem_at(b"l", 1)
    return (s.get(b"k"), s.get_int(b"n"), s.hgetall(b"h"), s.hlen(b"h"),
            s.litems(b"l"), s.llen(b"l"))


def test_txstructure_ops_write_the_same_bytes():
    out = []
    for new, tx, iso in ((jnew_storage, JTxStructure, JIso.SI),
                         (lambda: pnew_storage(device="cpu"),
                          PTxStructure, PIso.SI)):
        st = new()
        txn = st.begin()
        seen = _structure_ops(tx(txn, prefix=b"x"))
        txn.commit()
        out.append((seen, st.engine.scan(b"", b"\xff" * 8, 1 << 30, TS,
                                         iso)))
        st.close()
    assert out[0] == out[1]


@pytest.fixture(scope="module")
def created_infos():
    st = pnew_storage(device="cpu")
    s = PSession(st)
    for sql in SEQUENCES["tpch"]:
        s.execute(sql)
    ischema = s.domain.info_schema()
    infos = {name: ischema.table("tpch", name)
             for name in ptpch.TABLE_COLUMNS}
    s.close()
    st.close()
    return infos


@pytest.mark.parametrize("table", sorted(ptpch.TABLE_COLUMNS))
def test_create_table_infos_equal_the_hand_built(created_infos, table):
    got, want = created_infos[table], ptpch.table_infos()[table]
    assert (got.pk_is_handle, got.pk_col_name, got.max_column_id) == \
        (want.pk_is_handle, want.pk_col_name, want.max_column_id)
    assert [(c.id, c.name, c.offset, c.ft, c.has_default, c.default,
             c.auto_increment) for c in got.columns] == \
        [(c.id, c.name, c.offset, c.ft, c.has_default, c.default,
          c.auto_increment) for c in want.columns]
    assert got.indexes == want.indexes == []


def _nopk_handles(port: bool, batches):
    st = pnew_storage(device="cpu") if port else jnew_storage()
    s = (PSession if port else JSession)(st)
    try:
        s.execute("CREATE DATABASE d")
        s.execute("USE d")
        s.execute("CREATE TABLE t (a BIGINT, b VARCHAR(10))")
        counts = []
        for rows in batches:
            vals = ", ".join(f"({i}, 'r{i}')" for i in rows)
            counts.append(s.execute(f"INSERT INTO t VALUES {vals}")[0])
        info = s.domain.info_schema().table("d", "t")
        from tidb_tpu_torch import tablecodec
        lo = tablecodec.record_prefix(info.id)
        kvs = st.engine.scan(lo, lo + b"\xff", 1 << 30, TS,
                             PIso.SI if port else JIso.SI)
        rows = s.query("SELECT a, b FROM t ORDER BY a").rows
        return counts, [k for k, _v in kvs], rows
    finally:
        s.close()
        st.close()


@pytest.mark.parametrize("batches", [[range(3)], [range(2), range(5, 9)],
                                     [range(1), range(1), range(1)]],
                         ids=["one", "two", "three"])
def test_insert_without_pk_allocates_the_same_handles(batches):
    got = _nopk_handles(True, batches)
    want = _nopk_handles(False, batches)
    assert got == want
    assert len(got[1]) == sum(len(b) for b in batches)


def test_auto_ids_come_from_meta():
    st = pnew_storage(device="cpu")
    s = PSession(st)
    s.execute("CREATE DATABASE d")
    s.execute("USE d")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY AUTO_INCREMENT, "
              "v BIGINT)")
    s.execute("INSERT INTO t (v) VALUES (10), (20)")
    info = s.domain.info_schema().table("d", "t")
    tbl = PTable(info, st)
    first = tbl.alloc_auto_id()
    assert first == 3 and tbl.first_alloc_id == 3
    tbl.rebase_auto_id(100)
    s.execute("INSERT INTO t (v) VALUES (30)")
    assert s.query("SELECT id, v FROM t ORDER BY id").rows == \
        [(1, 10), (2, 20), (101, 30)]
    s.close()
    st.close()
