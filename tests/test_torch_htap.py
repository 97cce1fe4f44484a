"""The HTAP write mix (benchmarks/htap.py, the port's counterpart of the
JAX package's `bench.py htap`) against the JAX package, without threads.

Both packages create the reference's stock and orders tables and load
the same 4,096 seeded stock rows (the port through `htap.setup`, the
reference through its own bulk load of `htap.stock_columns`), warm the
analytic GROUP BY twice (the second serve fills the HBM block cache),
then take the new-order/payment writes one at a time from a second
session. After each write the analytic rows equal the reference's, the
port's host path's (`SET @@tidb_tpu_device = 0`) and the numpy replay
of the committed statements (`StockMirror`): integer and DECIMAL lanes
exactly, SUM(s_ytd) within 1e-9 relative. The warm reads are served
from the cached block with the delta (`served_with_delta` grows, no HBM
miss after the fill), and every statement's ledger reads 0.
"""

import math

import numpy as np
import pytest
import torch

from tests.test_torch_txn import sysvars
from tidb_tpu import metrics as jmetrics
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu.table import Table as JTable
from tidb_tpu.table import bulkload as jbulkload
from tidb_tpu_torch import metrics as pmetrics
from tidb_tpu_torch.benchmarks import htap
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

torch.set_num_threads(1)

ROWS = 4096
WRITES = 24


def _same(got, want) -> bool:
    return len(got) == len(want) and all(
        (g[0], g[1], g[2], g[4]) == (w[0], w[1], w[2], w[4]) and
        math.isclose(g[3], w[3], rel_tol=1e-9) for g, w in zip(got, want))


def _counters(m) -> dict:
    snap = m.snapshot()
    return {name: sum(v for k, v in snap.items()
                      if k == name or k.startswith(name + "{"))
            for name in (m.CACHE_DELTA_SERVES, m.HBM_CACHE_MISSES)}


@pytest.fixture
def mix():
    js, ps = jnew_storage(), pnew_storage(device="cpu")
    jsess, psess = JSession(js), PSession(ps)
    for s in (jsess, psess):
        s.execute("CREATE DATABASE htap")
        s.execute("USE htap")
    mirror = htap.setup(psess, ps, ROWS)
    for sql in htap.DDL:
        jsess.execute(sql)
    jbulkload.bulk_load(js, JTable(jsess.domain.info_schema().table(
        "htap", "stock"), js), htap.stock_columns(ROWS))
    writers = (JSession(js, db="htap"), PSession(ps, db="htap"))
    yield (jsess, psess), writers, mirror
    for s in (*writers, jsess, psess):
        s.close()
    js.close()
    ps.close()


def test_setup_loads_the_references_rows(mix):
    (jsess, psess), _w, mirror = mix
    want = jsess.query(htap.ANALYTIC).rows
    assert _same(psess.query(htap.ANALYTIC).rows, want)
    assert _same(want, mirror.truth())
    assert sum(r[1] for r in want) == ROWS


def test_write_statements_are_the_references():
    assert htap.write_statements(1, 60000) == [
        "UPDATE stock SET s_qty = s_qty - 1, s_cnt = 1 WHERE s_id = 7919",
        "INSERT INTO orders VALUES (1, 7919, 9.99)"]
    assert htap.write_statements(2, 60000) == [
        "UPDATE stock SET s_ytd = s_ytd + 1.5, s_cnt = 2 "
        "WHERE s_id = 15838"]


@pytest.mark.parametrize("min_rows", [1, 2048])
def test_each_write_is_read_back_by_the_next_analytic(mix, min_rows):
    (jsess, psess), writers, mirror = mix
    with sysvars({"tidb_tpu_device_min_rows": min_rows}):
        for s in (jsess, psess):
            s.query(htap.ANALYTIC)
            s.query(htap.ANALYTIC)          # the HBM fill
        served = {"ref": 0, "port": 0}
        misses = {"ref": 0, "port": 0}
        for seq in range(1, WRITES + 1):
            for i, sql in enumerate(htap.write_statements(seq, ROWS)):
                for w in writers:
                    assert w.execute(sql) == [1]
                mirror.apply(seq, i)
            for side, sess, m in (("ref", jsess, jmetrics),
                                  ("port", psess, pmetrics)):
                c0 = _counters(m)
                rows = sess.query(htap.ANALYTIC).rows
                c1 = _counters(m)
                served[side] += c1[m.CACHE_DELTA_SERVES] - \
                    c0[m.CACHE_DELTA_SERVES]
                misses[side] += c1[m.HBM_CACHE_MISSES] - \
                    c0[m.HBM_CACHE_MISSES]
                if side == "ref":
                    want = rows
                else:
                    got = rows
            assert psess.last_mem_left == 0
            assert _same(got, want) and _same(got, mirror.truth())
            assert max(r[4] for r in got) == seq
            psess.execute("SET @@tidb_tpu_device = 0")
            try:
                host = psess.query(htap.ANALYTIC).rows
            finally:
                psess.execute("SET @@tidb_tpu_device = 1")
            assert _same(host, got)
    assert served["port"] == served["ref"] > 0
    assert misses["port"] == misses["ref"]
    orders = psess.query("SELECT COUNT(*), SUM(o_item) FROM orders").rows
    odd = np.arange(1, WRITES + 1, 2)
    assert orders[0][0] == len(odd)
    assert int(orders[0][1]) == int(((odd * 7919) % ROWS).sum())


def test_sweep_replays_to_the_mirror(mix):
    """The threaded sweep at two short windows: every analytic read sums
    COUNT to the row count, and the final rows equal the replay of the
    logged statements."""
    (_jsess, psess), _w, mirror = mix
    psess.query(htap.ANALYTIC)
    res = htap.sweep(psess, psess.storage, ROWS, rates=(0, 50),
                     window=0.3)
    assert set(res["rates"]) == {"0", "50"}
    assert not res["rates"]["0"]["errors"] and \
        not res["rates"]["50"]["errors"]
    assert res["rates"]["0"]["achieved_writes_per_sec"] == 0
    for seq, i in res["committed"]:
        mirror.apply(seq, i)
    assert htap.same_rows(psess.query(htap.ANALYTIC).rows, mirror.truth())
    assert res["rates"]["50"]["ledger_left_max"] == 0
