"""LOAD DATA (with the native scanner) and SPLIT TABLE through the port's
Session against the JAX package's.

The same files go through both packages' `LOAD DATA INFILE` into a
table of the same DDL (the port's storage on the CPU), and the table's
KV pairs (record keys, values and index entries) must be equal byte for
byte:

  * ScaledTpch(sf=0.002, seed=42)'s lineitem written by
    `tpch.write_tsv` (tab-separated, the default format) into a table
    with lineitem's DDL under another name: the port's native scanner
    serves every chunk (its counter counts them, no fallback), SPLIT
    TABLE ... REGIONS 8 reports the reference's 7 splits, and TPC-H Q1
    over the table equals `tpch.q1_truth` with 8 cop tasks;
  * a CSV with an enclosure, escapes, NULLs and IGNORE 1 LINES, and one
    with a two-byte field terminator, which the native scanner cannot
    take: the Python scanner serves it, counted under "separators";
  * the first statement after SPLIT TABLE sends a cop task per new
    region (the reference's sends one over the stale cached region).

The reference's own `tests/test_loaddata_split.py` and
`test_native_loadscan.py` are replayed against the port (`replay`).
"""

import pytest

from tests.test_torch_server import replay
from tests.test_torch_session import sysvars
from tidb_tpu import tablecodec as jtc
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch import tablecodec as ptc
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.executor import loaddata
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

SF, SEED = 0.002, 42
SYSVARS = {"tidb_tpu_device_min_rows": 1, "tidb_tpu_superchunk_rows": 4096}
LINEITEM_DDL = [s for s in ptpch.DDL.split(";")
                if "TABLE lineitem" in s][0].replace("lineitem (",
                                                     "lineitem_load (")


@pytest.fixture
def pair():
    js, ps = jnew_storage(), pnew_storage(device="cpu")
    jsess, psess = JSession(js), PSession(ps)
    for s in (jsess, psess):
        s.execute("CREATE DATABASE d")
        s.execute("USE d")
    with sysvars(SYSVARS):
        yield jsess, psess
    for s, st in ((jsess, js), (psess, ps)):
        s.close()
        st.close()


def _table_kv(sess, tc, name):
    info = sess.domain.info_schema().table("d", name)
    lo, hi = tc.table_prefix_range(info.id)
    st = sess.storage
    return list(st.snapshot(st.current_ts()).iter_range(lo, hi))


def _both(pair, sql):
    """Run `sql` through both sessions: the same affected-row counts, or
    the same result columns and rows."""
    jsess, psess = pair
    want = jsess.execute(sql)
    got = psess.execute(sql)

    def plain(res):
        return [(r.columns, r.rows) if hasattr(r, "rows") else r
                for r in res]
    assert plain(got) == plain(want), sql
    return got


def test_lineitem_tsv_loads_the_references_bytes(pair, tmp_path):
    jsess, psess = pair
    d = ptpch.ScaledTpch(SF, SEED)
    path = tmp_path / "lineitem.tsv"
    n = ptpch.write_tsv(d, "lineitem", path)
    _both(pair, LINEITEM_DDL)
    loaddata.reset_scan_stats()
    assert _both(pair, f"LOAD DATA INFILE '{path}' INTO TABLE "
                       "lineitem_load") == [n]
    st = loaddata.scan_stats()
    assert st["native_chunks"] > 0 and st["native_rows"] == n
    assert st["fallbacks"] == {}
    assert psess.last_mem_left == 0
    assert _table_kv(psess, ptc, "lineitem_load") == \
        _table_kv(jsess, jtc, "lineitem_load")
    got = _both(pair, "SPLIT TABLE lineitem_load REGIONS 8")
    assert got[0].rows == [(7,)]
    q1 = ptpch.Q1.replace("FROM lineitem", "FROM lineitem_load")
    rows = psess.query(q1).rows
    assert rows == ptpch.as_session_rows("q1", ptpch.q1_truth(d))
    assert rows == jsess.query(q1).rows
    reader = [o for o in psess.last_collector.ops()
              if o.name == "TableReader"]
    assert reader and reader[0].cop_tasks == 8


def test_csv_options_load_the_references_bytes(pair, tmp_path):
    jsess, psess = pair
    path = tmp_path / "t.csv"
    path.write_text('id,name,amt,day\n1,"a,b",1.50,2024-01-02\n'
                    '2,"say ""hi""",\\N,\\N\n3,tab\\there,-0.25,'
                    '1999-12-31\n')
    _both(pair, "CREATE TABLE t (id BIGINT PRIMARY KEY, name "
                "VARCHAR(20), amt DECIMAL(10,2), day DATE, KEY (name))")
    sql = (f"LOAD DATA INFILE '{path}' INTO TABLE t FIELDS TERMINATED "
           "BY ',' ENCLOSED BY '\"' LINES TERMINATED BY '\\n' "
           "IGNORE 1 LINES")
    assert _both(pair, sql) == [3]
    assert _table_kv(psess, ptc, "t") == _table_kv(jsess, jtc, "t")
    assert psess.query("SELECT * FROM t ORDER BY id").rows == \
        jsess.query("SELECT * FROM t ORDER BY id").rows


def test_multibyte_separator_takes_the_python_scanner(pair, tmp_path):
    jsess, psess = pair
    path = tmp_path / "t.txt"
    path.write_text("1||x\n2||y\n")
    _both(pair, "CREATE TABLE t (id BIGINT PRIMARY KEY, v VARCHAR(4))")
    loaddata.reset_scan_stats()
    assert _both(pair, f"LOAD DATA INFILE '{path}' INTO TABLE t FIELDS "
                       "TERMINATED BY '||'") == [2]
    st = loaddata.scan_stats()
    assert st["fallbacks"] == {"separators": 1}
    assert st["native_chunks"] == 0
    assert _table_kv(psess, ptc, "t") == _table_kv(jsess, jtc, "t")


def test_split_refreshes_the_region_cache(pair):
    """The first statement after SPLIT TABLE sees the new regions: the
    reference's client keeps the split region's stale epoch cached and
    sends one cop task over it (a fault the port fixes, ROADMAP §C)."""
    jsess, psess = pair
    # t's rows land in the store's last region, [a's split, +inf)
    _both(pair, "CREATE TABLE a (id BIGINT PRIMARY KEY)")
    _both(pair, "INSERT INTO a VALUES (1), (2000)")
    _both(pair, "SPLIT TABLE a AT (1000)")
    _both(pair, "CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    _both(pair, "INSERT INTO t VALUES " +
          ",".join(f"({i}, {i % 7})" for i in range(4000)))
    _both(pair, "SELECT COUNT(*) FROM t")      # caches t's region
    _both(pair, "SPLIT TABLE t AT (1000), (2000), (3000)")
    sql = "EXPLAIN ANALYZE SELECT COUNT(*), SUM(v) FROM t"

    def tasks(sess):
        return [r[7] for r in sess.query(sql).rows
                if "TableReader" in r[0]]
    assert tasks(psess) == [4]
    assert tasks(jsess) == [1]          # the stale region, one task
    assert tasks(jsess) == [4]          # after its epoch error


replay("test_loaddata_split.py", globals())
replay("test_native_loadscan.py", globals())
