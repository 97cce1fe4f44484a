"""The port's delta store and device patch (store/delta.py,
DeviceCache._patch_locked) against the JAX package's, under the same
write batches on the same TPC-H data (SF 0.01) in both stores.

Both stores warm Q1's HBM blocks, then commit the same OLTP batch to
lineitem's last region (updates of l_quantity and l_returnflag, inserts
with one l_returnflag the block's dictionary lacks, deletes) and serve Q1
again, which patches that region's block on the device:

  * the patched block's lanes, read back as numpy, equal the JAX
    package's patched block (the same rows in the same device order, the
    same extended dictionaries, the same position index);
  * in handle order they equal a fresh fill from the merged host chunk;
  * the port's Q1 rows equal the numpy truth of the mutated arrays (the
    JAX package reads each group's key at the device position of its
    representative row in the host chunk, which a patch reorders: the
    port maps positions through the block's position index, ROADMAP §C);
  * a second batch past tidb_tpu_delta_merge_rows merges in both: the
    journal keeps the same rows, both caches keep the reference's merged
    entry (and, in the port, the three regions no write touched,
    re-stamped), a window below the new floor answers STALE, and Q1
    stays exact;
  * after one committed update in the last region and a merge, a Q1
    run hits both caches in the three untouched regions in the port and
    misses them in the reference.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from tidb_tpu import config as jconfig
from tidb_tpu import tablecodec as jtc
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.kv import CopRequest as JCopRequest
from tidb_tpu.kv import KVRange as JKVRange
from tidb_tpu.kv import ReqType as JReqType
from tidb_tpu.session import Session
from tidb_tpu.store import copr as jcopr
from tidb_tpu.store import delta as jdelta
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu.table import Table as JTable
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.executor.agg import run_q1_store
from tidb_tpu_torch.store import delta as pdelta
from tidb_tpu_torch.store import device_cache as pdc
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

SF, SEED = 0.01, 42
LINEITEM = ptpch.TABLE_IDS["lineitem"]


@contextlib.contextmanager
def sysvars(**values):
    old = [(cfg, k, cfg.get_var(k)) for cfg in (jconfig, pconfig)
           for k in values]
    for cfg in (jconfig, pconfig):
        for k, v in values.items():
            cfg.set_var(k, v)
    try:
        yield
    finally:
        for cfg, k, v in old:
            cfg.set_var(k, v)


def _jax_commit(js, info, b):
    """tpch.commit_batch's transaction through the JAX package's Table."""
    table = JTable(info, js)
    txn = js.begin()

    def old(h):
        return jtc.decode_row(txn.get(jtc.record_key(info.id, int(h))))
    for h, q, f in zip(b.updates, b.upd_qty, b.upd_flag):
        table.update_record(txn, int(h), old(h),
                            {"l_quantity": (2, int(q)), "l_returnflag": f})
    for h in b.deletes:
        table.remove_record(txn, int(h), old(h))
    for i in range(len(b.inserts.get("l_id", ()))):
        table.add_record(txn, {
            k: (2, int(v[i])) if info.col_by_name(k).ft.frac == 2 else
            (v[i] if isinstance(v[i], str) else int(v[i]))
            for k, v in b.inserts.items()})
    txn.commit()


def _jax_q1(js, plan):
    from tidb_tpu_torch import codec, tablecodec
    lo = tablecodec.record_prefix(LINEITEM)
    req = JCopRequest(tp=JReqType.DAG,
                      ranges=[JKVRange(lo, codec.prefix_next(lo))],
                      plan=plan, start_ts=js.current_ts(), concurrency=1)
    return list(js.client().send(req))


def _wait_merged(dstore, rows: int) -> None:
    deadline = time.time() + 30
    while dstore.rows_current() > rows and time.time() < deadline:
        time.sleep(0.05)


def _last_block(cache):
    """(key, block) of lineitem's last region: the largest range start."""
    key = max((e[0] for e in cache.snapshot_table(LINEITEM)),
              key=lambda k: k[0][6])
    return key, cache._entries[key][2]


def _np_lanes(block):
    out = []
    for d, v in block.cols:
        if isinstance(d, torch.Tensor):
            out.append((d.numpy(), v.numpy()))
        else:
            out.append((np.asarray(d), np.asarray(v)))
    return out


@pytest.fixture(scope="module")
def run():
    """Both stores through load, two warm Q1s, the first batch and the
    patched Q1; then the second batch and its merge. -> a dict of what
    each step left."""
    js = jnew_storage()
    s = Session(js)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    jtpch.load(s, js, jtpch.ScaledTpch(SF, SEED))
    jinfo = s.domain.info_schema().table("tpch", "lineitem")
    ps = pnew_storage(device="cpu")
    d = ptpch.ScaledTpch(SF, SEED)
    ptpch.load_store(ps, d)
    for st in (js, ps):
        st.async_commit_secondaries = False
    seen = []
    orig = jcopr.exec_cop_plan

    def spy(plan, chunk, *a, **k):
        seen.append(plan)
        return orig(plan, chunk, *a, **k)
    jcopr.exec_cop_plan = spy
    try:
        s.query(jtpch.Q1)
    finally:
        jcopr.exec_cop_plan = orig
    jplan = seen[0]
    mirror = ptpch.Q1Mirror(d)
    out = {"mirror": mirror, "rows": []}
    with sysvars(tidb_tpu_device_min_rows=1, tidb_tpu_copr_stream=1,
                 tidb_tpu_delta_merge_rows=900):
        for _ in range(2):                  # host fill, HBM fill
            _jax_q1(js, jplan)
            out["rows"].append((run_q1_store(device="cpu", storage=ps).rows,
                                mirror.truth()))
        n = d.counts["lineitem"]
        lo = 3 * (n // 4)
        b1 = ptpch.write_batch(d, np.arange(lo, n), 1, 400, 100, 100,
                               next_handle=n, new_flag="X")
        _jax_commit(js, jinfo, b1)
        ptpch.commit_batch(ps, b1)
        mirror.apply(b1)
        out["journal"] = (js.delta_store.rows_current(),
                          ps.delta_store.rows_current())
        _jax_q1(js, jplan)
        res = run_q1_store(device="cpu", storage=ps)
        out["rows"].append((res.rows, mirror.truth()))
        out["patches"] = ps.device_cache.patches
        out["blocks"] = (_last_block(js.device_cache),
                         _last_block(ps.device_cache))
        out["merged_chunk"] = ps.delta_store.best_memo(max(
            ps.chunk_cache.snapshot_table(LINEITEM),
            key=lambda e: e[0][6])[3])
        # the second batch crosses the merge threshold in both
        live = np.setdiff1d(np.arange(lo, n), b1.deletes)
        b2 = ptpch.write_batch(d, live, 2, 400)
        _jax_commit(js, jinfo, b2)
        ptpch.commit_batch(ps, b2)
        mirror.apply(b2)
        ps.delta_store.join()
        _wait_merged(js.delta_store, 400)
        out["after_merge"] = [
            (st.delta_store.rows_current(), st.delta_store.staged_bytes(),
             sorted(k for k, *_r in st.chunk_cache.snapshot_table(LINEITEM)),
             sorted(k for k, *_r in st.device_cache.snapshot_table(
                 LINEITEM)))
            for st in (js, ps)]
        out["stale"] = [st.delta_store.pending(LINEITEM, b"", b"", 0, 1 << 62)
                        for st in (js, ps)]
        out["rows"].append((run_q1_store(device="cpu", storage=ps).rows,
                            mirror.truth()))
        out["rows"].append((run_q1_store(device="cpu", storage=ps).rows,
                            mirror.truth()))
    yield out
    s.close()
    js.close()
    ps.close()


def test_port_rows_equal_the_truth_throughout(run):
    assert len(run["rows"]) == 5
    for got, want in run["rows"]:
        assert got == want
    assert run["rows"][2][1][-1][0] == "X"      # the new flag's group
    assert run["journal"] == (600, 600)
    assert run["patches"] == 1


def test_patched_block_equals_the_references(run):
    (jkey, jb), (pkey, pb) = run["blocks"]
    assert pkey == jkey
    assert (pb.nrows, pb.size, pb.nbytes) == (jb.nrows, jb.size, jb.nbytes)
    np.testing.assert_array_equal(pb.pos_handles, jb.pos_handles)
    np.testing.assert_array_equal(pb.handles, jb.handles)
    assert pb.dicts == jb.dicts
    assert "X" in pb.dicts[7]
    for j, ((pd_, pv), (jd, jv)) in enumerate(zip(_np_lanes(pb),
                                                  _np_lanes(jb))):
        np.testing.assert_array_equal(pv, jv, err_msg=str(j))
        np.testing.assert_array_equal(pd_, jd, err_msg=str(j))


def test_patched_block_equals_a_fresh_fill_of_the_merged_chunk(run):
    (_jk, _jb), (_pk, pb) = run["blocks"]
    _w, merged = run["merged_chunk"]
    assert merged.num_rows == pb.nrows
    cols, dicts = pdc.upload_block(merged, pb.size, torch.device("cpu"))
    fresh = pdc.DeviceBlock(cols, dicts, merged.num_rows, pb.size,
                            pb.nbytes)
    order = np.argsort(pb.handles, kind="stable")
    np.testing.assert_array_equal(pb.handles[order], merged._scan_handles)
    for j, ((pd_, pv), (fd, fv)) in enumerate(zip(_np_lanes(pb),
                                                  _np_lanes(fresh))):
        n = pb.nrows
        np.testing.assert_array_equal(pv[:n][order], fv[:n], err_msg=str(j))
        assert not pv[n:].any() and not fv[n:].any()
        if j in pb.dicts:       # codes may differ; the values may not
            pvals = np.array(pb.dicts[j], dtype=object)[pd_[:n][order]]
            fvals = np.array(fresh.dicts[j], dtype=object)[fd[:n]]
            live = fv[:n]
            assert list(pvals[live]) == list(fvals[live]), j
        else:
            np.testing.assert_array_equal(pd_[:n][order], fd[:n],
                                          err_msg=str(j))


def test_merge_and_stale_match_the_reference(run):
    jm, pm = run["after_merge"]
    assert pm[0] == jm[0] == 400                 # batch 2 still journaled
    assert pm[1] == jm[1] > 0
    # the reference keeps the merged region only; the port also keeps
    # the three regions no write touched, re-stamped (ROADMAP §C)
    assert len(jm[2]) == 1 and set(jm[2]) <= set(pm[2]) and len(pm[2]) == 4
    assert len(jm[3]) == 1 and set(jm[3]) <= set(pm[3]) and len(pm[3]) == 4
    jst, pst = run["stale"]
    assert jst is jdelta.STALE and pst is pdelta.STALE


def test_record_handles_and_pending_window():
    """record_handles decodes the same handles, and pending() nets the
    same journal window (last write wins, deletes apart) in both."""
    keys = [jtc.record_key(LINEITEM, h) for h in (5, -3, 1 << 40)]
    np.testing.assert_array_equal(pdelta.record_handles(keys),
                                  jdelta.record_handles(keys))

    class _Storage:             # ingest/pending need no engine
        engine = None

    out = []
    for mod in (jdelta, pdelta):
        ds = mod.DeltaStore(_Storage())
        with sysvars(tidb_tpu_delta_merge_rows=1 << 20):
            ds.ingest([(13, 1, keys[0], b"v1", 10), (13, 1, keys[0], b"v2",
                                                      12),
                       (13, 2, keys[1], None, 11)], [])
        p = ds.pending(13, b"", b"", 9, 12)
        out.append((p.watermark, p.upsert_rows, list(p.upsert_handles),
                    list(p.delete_handles), ds.pending(13, b"", b"", 12, 20),
                    ds.rows_current()))
        ds.close()
    assert out[0] == out[1]
    assert out[1][:4] == (12, [(keys[0], b"v2")], [1], [2])


def _hbm_hits(metrics) -> int:
    return int(metrics.snapshot().get(metrics.HBM_CACHE_HITS, 0))


@pytest.fixture(scope="module")
def merged_one_update():
    """Fresh stores in both packages: Q1 twice (host fill, HBM fill), one
    committed update in lineitem's last region, DeltaStore.merge(), then
    one more Q1. -> {package: (chunk hits, chunk misses, HBM hits)} of
    that last run, and the port's rows beside the truth. (A streamed
    cold range consults the chunk cache by peek, so misses count only
    where a lookup ran; hits are the measure.)"""
    from tidb_tpu import metrics as jmetrics
    from tidb_tpu_torch import metrics as pmetrics
    js = jnew_storage()
    s = Session(js)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    jtpch.load(s, js, jtpch.ScaledTpch(SF, SEED))
    jinfo = s.domain.info_schema().table("tpch", "lineitem")
    ps = pnew_storage(device="cpu")
    d = ptpch.ScaledTpch(SF, SEED)
    ptpch.load_store(ps, d)
    for st in (js, ps):
        st.async_commit_secondaries = False
    seen = []
    orig = jcopr.exec_cop_plan

    def spy(plan, chunk, *a, **k):
        seen.append(plan)
        return orig(plan, chunk, *a, **k)
    jcopr.exec_cop_plan = spy
    try:
        s.query(jtpch.Q1)
    finally:
        jcopr.exec_cop_plan = orig
    jplan = seen[0]
    mirror = ptpch.Q1Mirror(d)
    out = {}
    with sysvars(tidb_tpu_device_min_rows=1, tidb_tpu_copr_stream=1):
        for _ in range(2):
            _jax_q1(js, jplan)
            run_q1_store(device="cpu", storage=ps)
        n = d.counts["lineitem"]
        b = ptpch.write_batch(d, np.arange(3 * (n // 4), n), 5, 1)
        _jax_commit(js, jinfo, b)
        ptpch.commit_batch(ps, b)
        mirror.apply(b)
        assert js.delta_store.merge() == ps.delta_store.merge() == 1
        for name, st, metrics, q1 in (
                ("jax", js, jmetrics, lambda: _jax_q1(js, jplan)),
                ("port", ps, pmetrics,
                 lambda: run_q1_store(device="cpu", storage=ps))):
            cc = st.chunk_cache
            h0, m0, hbm0 = cc.hits, cc.misses, _hbm_hits(metrics)
            res = q1()
            out[name] = (cc.hits - h0, cc.misses - m0,
                         _hbm_hits(metrics) - hbm0)
            if name == "port":
                out["rows"] = (res.rows, mirror.truth())
    yield out
    s.close()
    js.close()
    ps.close()


def test_merge_keeps_untouched_regions_hot(merged_one_update):
    """ROADMAP §C: a merge after one update in the last region leaves the
    three untouched regions hot in both of the port's caches (their
    entries re-stamped at the merge's target), where the reference drops
    them and re-scans all four regions; Q1 stays exact."""
    got, want = merged_one_update["rows"]
    assert got == want
    port, jax = merged_one_update["port"], merged_one_update["jax"]
    assert (port[0], port[2]) == (3, 3)
    assert (jax[0], jax[2]) == (0, 0)
