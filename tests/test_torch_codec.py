"""The port's storage codecs against the JAX package's, byte for byte.

`codec`, `tablecodec` and `table.bulkload` are copies in the port: the
same datums must give the same bytes. The TableInfos the port builds for
TPC-H (`tpch.table_infos`) must equal the ones the JAX DDL gives, so the
KV pairs a bulk load writes are identical in both packages. Decoding
those pairs must agree three ways: the port's native decoder (its
codec.cc decodes strings too), the port's Python decoder, and the JAX
package's `kvrows_to_chunk`. Every lineitem and orders column kind is
covered (BIGINT, DECIMAL(15,2), CHAR(1), DATE, VARCHAR(15)), with NULLs,
negative decimals, empty, multi-group and non-ASCII strings. Exact. The
decode bench's JAX-package rule (a string column sends the row set to
the Python decoder) is checked with its CPU run.
"""

import numpy as np
import pytest
import torch

from tidb_tpu import codec as jcodec
from tidb_tpu import tablecodec as jtc
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.kv import IsolationLevel as JIso
from tidb_tpu.session import Session
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu.table import Table as JTable
from tidb_tpu.table import bulkload as jbulk
from tidb_tpu.table import kvrows_to_chunk as jkvrows_to_chunk
from tidb_tpu_torch import codec as pcodec
from tidb_tpu_torch import convert
from tidb_tpu_torch import native
from tidb_tpu_torch import table as ptable
from tidb_tpu_torch import tablecodec as ptc
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.kv import IsolationLevel as PIso
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage
from tidb_tpu_torch.table import bulkload as pbulk

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

TS = 1 << 62
ALPHABET = list("abcXYZ09 _-é中ß")


@pytest.fixture(scope="module")
def jax_infos():
    """{table: TableInfo} as the JAX DDL builds them."""
    s = Session(jnew_storage())
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    for stmt in jtpch.DDL.strip().split(";"):
        if stmt.strip():
            s.execute(stmt)
    isch = s.domain.info_schema()
    return {t: isch.table("tpch", t) for t in ptpch.TABLE_IDS}


def test_table_infos_match_the_ddl(jax_infos):
    port = ptpch.table_infos()
    for name, jinfo in jax_infos.items():
        assert port[name].to_json() == jinfo.to_json(), name
        assert convert.table_info_from(jinfo).to_json() == jinfo.to_json()


def _strings(rng, n, lo, hi):
    return np.array(["".join(rng.choice(ALPHABET, rng.integers(lo, hi + 1)))
                     for _ in range(n)], dtype=object)


def _columns(table: str, n: int, seed: int) -> dict:
    """{column: (data, valid)} for `table`: every non-key column ~10 %
    NULL; decimals signed; dates around the TPC-H range; CHAR(1) one
    character; VARCHAR(15) 0-15 characters, some past one 8-byte group."""
    rng = np.random.default_rng(seed)
    out = {}
    for j, (name, ft) in enumerate(ptpch.TABLE_COLUMNS[table]):
        valid = np.ones(n, dtype=bool) if j == 0 else rng.random(n) > 0.1
        tp = int(ft.tp)
        if j == 0:
            data = rng.permutation(n).astype(np.int64) * 3
        elif tp == 246:                                   # DECIMAL(15,2)
            data = rng.integers(-10 ** 12, 10 ** 12, n)
        elif tp == 10:                                    # DATE
            data = ptpch._days_us(rng.integers(-400, 3000, n))
        elif tp == 254:                                   # CHAR(1)
            data = _strings(rng, n, 1, 1)
        elif tp == 15:                                    # VARCHAR
            data = _strings(rng, n, 0, ft.flen)
        else:                                             # BIGINT
            data = rng.integers(-(1 << 62), 1 << 62, n)
        out[name] = (data, valid)
    return out


def _scan(storage, table_id: int, iso):
    lo = ptc.record_prefix(table_id)
    return storage.engine.scan(lo, pcodec.prefix_next(lo), 1 << 30, TS,
                               iso)


@pytest.fixture(scope="module")
def loaded(jax_infos):
    """Both packages' stores after bulk-loading the same columns of
    lineitem and orders: {table: (jax kv rows, port kv rows)}."""
    js, ps = jnew_storage(), pnew_storage(device="cpu")
    pinfos = ptpch.table_infos()
    out = {}
    for seed, table in enumerate(("lineitem", "orders")):
        cols = _columns(table, 3000, seed)
        jbulk.bulk_load(js, JTable(jax_infos[table], js), cols)
        pbulk.bulk_load(ps, ptable.Table(pinfos[table], ps), cols,
                        rebase_autoid=False)
        out[table] = (_scan(js, jax_infos[table].id, JIso.SI),
                      _scan(ps, pinfos[table].id, PIso.SI))
    yield out
    js.close()
    ps.close()


@pytest.mark.parametrize("table", ["lineitem", "orders"])
def test_bulkload_kv_bytes_identical(loaded, table):
    jrows, prows = loaded[table]
    assert len(prows) == 3000
    assert prows == jrows


def test_datum_and_row_encodings_identical():
    datums = [None, 0, -1, 1 << 62, -(1 << 63), 2.5, -0.0, -1e300, b"",
              b"12345678", b"123456789", "é中", (2, -12345), (2, 10 ** 14),
              b"\x00\xff"]
    for d in datums:
        assert pcodec.encode_key([d]) == jcodec.encode_key([d]), d
        assert pcodec.decode_key(jcodec.encode_key([d])) == \
            jcodec.decode_key(jcodec.encode_key([d]))
    assert pcodec.encode_key(datums) == jcodec.encode_key(datums)
    ids = list(range(1, len(datums) + 1))
    assert ptc.encode_row(ids, datums) == jtc.encode_row(ids, datums)
    for h in (0, 7, -3, (1 << 63) - 1):
        assert ptc.record_key(13, h) == jtc.record_key(13, h)
        assert ptc.decode_record_key(jtc.record_key(13, h)) == (13, h)
    assert ptc.index_key(13, 2, [5, "x"], handle=9) == \
        jtc.index_key(13, 2, [5, "x"], handle=9)


def _assert_chunks_equal(got, want):
    assert got.num_rows == want.num_rows
    assert got.num_cols == want.num_cols
    for j, (a, b) in enumerate(zip(got.columns, want.columns)):
        np.testing.assert_array_equal(a.valid, b.valid, err_msg=str(j))
        assert a.data.dtype == b.data.dtype, j
        assert list(a.data) == list(b.data), j


@pytest.mark.parametrize("table", ["lineitem", "orders"])
@pytest.mark.parametrize("handle_col", [None, 1])
def test_native_python_and_jax_decode_agree(loaded, jax_infos, table,
                                            handle_col, monkeypatch):
    jrows, prows = loaded[table]
    jinfo = jax_infos[table]
    pinfo = ptpch.table_infos()[table]
    for pick in (slice(None), slice(1, None, 2)):
        jcols, pcols = jinfo.columns[pick], pinfo.columns[pick]
        want = jkvrows_to_chunk(jinfo, jcols, jrows,
                                with_handle_col=handle_col)
        assert native.lib() is not None
        nat = ptable._kvrows_to_chunk_native(pcols, prows, handle_col)
        assert nat is not None          # the native path took every kind
        _assert_chunks_equal(nat, want)
        via = ptable.kvrows_to_chunk(pinfo, pcols, prows,
                                     with_handle_col=handle_col)
        _assert_chunks_equal(via, want)
        with monkeypatch.context() as m:
            m.setattr(ptable, "_kvrows_to_chunk_native", lambda *a: None)
            py = ptable.kvrows_to_chunk(pinfo, pcols, prows,
                                        with_handle_col=handle_col)
        _assert_chunks_equal(py, want)


def test_native_strings_fast_and_row_paths():
    """The one-width, all-valid fast path (np.unique over packed bytes)
    and the row loop give the Python decoder's values."""
    info = ptpch.table_infos()["orders"]
    rng = np.random.default_rng(3)
    for lo, hi, null in ((1, 1, False), (8, 8, False), (3, 3, True),
                         (0, 15, False), (9, 15, False)):
        n = 500
        vals = _strings(rng, n, lo, hi)
        valid = np.ones(n, bool) if not null else rng.random(n) > 0.2
        keys = [ptc.record_key(info.id, h) for h in range(n)]
        rows = [(k, ptc.encode_row([5], [v.encode() if ok else None]))
                for k, v, ok in zip(keys, vals, valid)]
        col = [info.columns[4]]
        nat = ptable._kvrows_to_chunk_native(col, rows, None)
        assert nat is not None
        py = ptable.rows_to_chunk([col[0].ft], [
            [ptable.decode_datum_for_col(ptc.decode_row(v).get(5), col[0].ft)]
            for _k, v in rows])
        _assert_chunks_equal(nat, py)


def test_store_decode_bench_runs_both_decoders(loaded, capsys):
    """benchmarks/store_decode_bench: under `strings_in_python` the
    native decoder declines a row set with a string column, as the JAX
    package's does, and still takes the other kinds; on the CPU at a
    tiny scale its three cold runs (native, Python, native) each equal
    Q1's truth."""
    import json

    from tidb_tpu_torch.benchmarks import store_decode_bench as bench
    _jrows, prows = loaded["lineitem"]
    cols = ptpch.table_infos()["lineitem"].columns
    with bench.strings_in_python():
        assert ptable._kvrows_to_chunk_native(cols, prows, None) is None
        assert ptable._kvrows_to_chunk_native(cols[:7], prows,
                                              None) is not None
    assert ptable._kvrows_to_chunk_native(cols, prows, None) is not None
    assert bench.main(["--sf", "0.002", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["decoder"] for x in lines if "decoder" in x] == \
        ["native", "python", "native"]


def test_load_store_writes_the_references_bytes():
    """tpch.load_store writes, table by table, the KV pairs the JAX
    package's tpch.load writes for the same ScaledTpch, and splits the
    same regions."""
    js = jnew_storage()
    s = Session(js)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    jtpch.load(s, js, jtpch.ScaledTpch(0.002, 5))
    ps = pnew_storage(device="cpu")
    ptpch.load_store(ps, ptpch.ScaledTpch(0.002, 5))
    for name, tid in ptpch.TABLE_IDS.items():
        assert _scan(ps, tid, PIso.SI) == _scan(js, tid, JIso.SI), name
    lo = ptc.record_prefix(ptpch.TABLE_IDS["region"])
    assert [(r.start, r.end) for r in ps.cluster.all_regions()
            if r.start >= lo] == \
        [(r.start, r.end) for r in js.cluster.all_regions()
         if r.start >= lo]
    s.close()
    js.close()
    ps.close()
