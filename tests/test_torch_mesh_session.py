"""SQL on the device plane: the port's Session against the JAX package's,
each under a plane of 8 (the reference's 8-device CPU mesh, the port's
8-shard CPU plane).

Both packages load the same `ScaledTpch(0.002, 42)` and the same SSB
lineorder columns (benchmarks/ssb.columns, 4 regions), then run the same
SQL:

  * TPC-H Q1, Q3, Q5, SSB Q1.1 and its grouped query: EXPLAIN gives the
    reference's operator tree line for line (MeshAgg for Q1 and the
    grouped SSB query, MeshLookupAgg for Q3 and Q5, the plain cop path
    for Q1.1's scalar aggregate), and the rows are the reference's and
    the exact truths;
  * with `tidb_tpu_stream_rows` below the table size the statements
    stream in batches, and `stream_stats()` (streams, batches, host
    batches, largest batch, overlapped launches) is the reference's;
  * with the escalation cap below the group count every streamed batch
    falls back to the host under the same `reason` label in both, and
    the rows do not change;
  * every statement's memory ledger reads 0 after it.
"""

import contextlib

import numpy as np
import pytest
import torch

from tidb_tpu import devplane as jplane
from tidb_tpu import metrics as jmetrics
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.executor import mesh as jmesh
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu.table import Table as JTable
from tidb_tpu.table import bulkload as jbulk
from tidb_tpu_torch import devplane as pplane
from tidb_tpu_torch import metrics as pmetrics
from tidb_tpu_torch.benchmarks import ssb
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.executor import mesh as pmesh
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage
from tests.test_torch_session import assert_same_rows, sysvars

torch.set_num_threads(1)

SF, SEED = 0.002, 42
SSB_ROWS = 30_000
SYSVARS = {"tidb_tpu_device_min_rows": 1, "tidb_tpu_superchunk_rows": 4096}
TRUTHS = {"q1": ptpch.q1_truth, "q3": ptpch.q3_truth, "q5": ptpch.q5_truth}


@pytest.fixture(scope="module")
def sessions():
    """(reference session, port session, tpch data, ssb truth)."""
    d = ptpch.ScaledTpch(SF, SEED)
    js, ps = jnew_storage(), pnew_storage(device="cpu")
    jsess, psess = JSession(js), PSession(ps)
    for s in (jsess, psess):
        s.execute("CREATE DATABASE tpch")
        s.execute("USE tpch")
    jtpch.load(jsess, js, jtpch.ScaledTpch(SF, SEED))
    ptpch.load(psess, ps, d)
    cols = ssb.columns(SSB_ROWS)
    for s, st, table in ((jsess, js, JTable), (psess, ps, None)):
        if table is None:
            ssb.setup(st, SSB_ROWS, 4, cols=cols)
            continue
        s.execute("CREATE DATABASE ssb")
        s.execute("USE ssb")
        s.execute(ssb.DDL)
        info = s.domain.info_schema().table("ssb", "lineorder")
        jbulk.bulk_load(st, table(info, st), cols)
        s.execute("SPLIT TABLE lineorder REGIONS 4")
        s.execute("USE tpch")
    with sysvars(SYSVARS):
        yield jsess, psess, d, ssb.truth(cols)
    for s, st in ((psess, ps), (jsess, js)):
        s.close()
        st.close()


@pytest.fixture
def planes():
    jplane.enable_mesh(8)
    pplane.enable_mesh(8, device="cpu")
    yield
    jplane.disable_mesh()
    pplane.disable_mesh()


@contextlib.contextmanager
def streaming(rows):
    with sysvars({"tidb_tpu_stream_rows": rows}):
        jmesh.reset_stream_stats()
        pmesh.reset_stream_stats()
        yield


STATEMENTS = {
    "q1": ("USE tpch", ptpch.Q1, "MeshAgg"),
    "q3": ("USE tpch", ptpch.Q3, "MeshLookupAgg"),
    "q5": ("USE tpch", ptpch.Q5, "MeshLookupAgg"),
    "ssb_q11": ("USE ssb", ssb.Q11, None),
    "ssb_qgrp": ("USE ssb", ssb.QGRP + " ORDER BY lo_discount", "MeshAgg"),
}


def _both(sessions, name, sql_of=lambda s: s):
    jsess, psess, _d, _t = sessions
    use, sql, _op = STATEMENTS[name]
    for s in (jsess, psess):
        s.execute(use)
    return (jsess.query(sql_of(sql)), psess.query(sql_of(sql)))


def _truth(sessions, name):
    _j, _p, d, ssb_truth = sessions
    if name.startswith("ssb_"):
        return ssb_truth[name[4:]]
    return ptpch.as_session_rows(name, TRUTHS[name](d))


def _plain(rows):
    return [tuple(int(v) if isinstance(v, (int, np.integer)) or
                  (hasattr(v, "as_integer_ratio") and not isinstance(v, float)
                   and v == int(v)) else v for v in r) for r in rows]


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_explain_names_the_reference_operators(sessions, planes, name):
    want, got = _both(sessions, name, lambda s: "EXPLAIN " + s)
    assert [r[0] for r in got.rows] == [r[0] for r in want.rows]
    op = STATEMENTS[name][2]
    text = "\n".join(r[0] for r in got.rows)
    if op is None:
        assert "Mesh" not in text
    else:
        assert op in text


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_rows_equal_the_reference_and_the_truth(sessions, planes, name):
    want, got = _both(sessions, name)
    assert_same_rows(got.rows, want.rows)
    truth = _truth(sessions, name)
    if name.startswith("ssb_"):
        assert _plain(got.rows) == truth
    else:
        assert_same_rows(got.rows, truth)
    assert sessions[1].last_mem.total() == 0


@pytest.mark.parametrize("name", ["q1", "q3", "q5", "ssb_qgrp"])
def test_streaming_matches_the_reference(sessions, planes, name):
    with streaming(4096):
        want, got = _both(sessions, name)
        jstats, pstats = jmesh.stream_stats(), pmesh.stream_stats()
    assert_same_rows(got.rows, want.rows)
    assert pstats == jstats
    assert pstats["batches"] > 1 and pstats["overlapped_launches"] > 0
    assert pstats["host_batches"] == 0
    assert sessions[1].last_stats.fallbacks == 0
    assert sessions[1].last_mem.total() == 0


def _fallbacks(metrics) -> dict:
    out: dict = {}
    for k, v in metrics.snapshot().items():
        if k.startswith(metrics.DEVICE_FALLBACKS) and 'reason="' in k:
            reason = k.split('reason="', 1)[1].split('"', 1)[0]
            out[reason] = out.get(reason, 0) + int(v)
    return out


def test_fallback_labels_match_the_reference(sessions, planes, monkeypatch):
    """An escalation cap below the group count: each streamed batch of
    the grouped SSB query overflows, cannot re-plan, and aggregates on
    the host, counted as "capacity" in both packages."""
    for mod in (jmesh, pmesh):
        monkeypatch.setattr(mod, "DEFAULT_CAPACITY", 4)
        monkeypatch.setattr(mod, "MAX_CAPACITY", 4)
    j0, p0 = _fallbacks(jmetrics), _fallbacks(pmetrics)
    with streaming(8192):
        want, got = _both(sessions, "ssb_qgrp")
        jstats, pstats = jmesh.stream_stats(), pmesh.stream_stats()
    assert_same_rows(got.rows, want.rows)
    assert _plain(got.rows) == _truth(sessions, "ssb_qgrp")
    jd = {k: v - j0.get(k, 0) for k, v in _fallbacks(jmetrics).items()
          if v != j0.get(k, 0)}
    pd = {k: v - p0.get(k, 0) for k, v in _fallbacks(pmetrics).items()
          if v != p0.get(k, 0)}
    assert pd == jd == {"capacity": pstats["batches"]}
    assert pstats == jstats and pstats["host_batches"] == pstats["batches"]
    assert sessions[1].last_stats.fallback_reasons == {
        "capacity": pstats["batches"]}
