"""The port's mock TiKV store (mockstore/: cluster, MVCC engine, RPC shim)
against the JAX package's, op sequence by op sequence.

Each scenario runs one sequence of engine and cluster operations in a
package and returns what a caller can observe: scan results at several
snapshots, get/batch_get answers, the locks a scan_lock reports, which
operations raised (by class name), `data_version`, `max_commit_ts`,
cleanup's answers, the regions after splits and merges, and the RPC
shim's region checks. The port must observe exactly what the reference
does.
"""

import types

import pytest

import tidb_tpu.kv as jkv
import tidb_tpu.mockstore as jms
import tidb_tpu_torch.kv as pkv
import tidb_tpu_torch.mockstore as pms
from tidb_tpu import tablecodec as jtc
from tidb_tpu_torch import tablecodec as ptc

PKGS = {"jax": types.SimpleNamespace(kv=jkv, ms=jms, tc=jtc),
        "torch": types.SimpleNamespace(kv=pkv, ms=pms, tc=ptc)}


def _try(fn):
    """fn() or the name of the exception class it raised."""
    try:
        return ("ok", fn())
    except Exception as e:     # noqa: BLE001 - the class is the answer
        return ("raised", type(e).__name__)


def _put(m, store, key, val, ts, commit_ts):
    store.prewrite([m.kv.Mutation(m.kv.MutationOp.PUT, key, val)], key, ts)
    store.commit([key], ts, commit_ts)


def mvcc_sequence(m):
    kv, out = m.kv, []
    s = m.ms.MVCCStore()
    _put(m, s, b"a", b"a1", 10, 11)
    _put(m, s, b"b", b"b1", 12, 13)
    _put(m, s, b"a", b"a2", 20, 21)
    s.prewrite([kv.Mutation(kv.MutationOp.DELETE, b"b")], b"b", 30)
    s.commit([b"b"], 30, 31)
    for ts in (5, 11, 15, 25, 40):
        out.append(("scan", ts, s.scan(b"", b"", 0, ts)))
        out.append(("get", ts, s.get(b"a", ts), s.get(b"b", ts)))
    # a pending lock: SI readers at/after its start_ts block, RC does not
    s.prewrite([kv.Mutation(kv.MutationOp.PUT, b"c", b"c1"),
                kv.Mutation(kv.MutationOp.PUT, b"d", b"d1")], b"c", 50,
               ttl_ms=0)
    out.append(("locked", s.locked_in_range(b"", b"", 60),
                s.locked_in_range(b"", b"", 40),
                s.locked_in_range(b"e", b"", 60)))
    out.append(("si", _try(lambda: s.get(b"c", 60))))
    out.append(("rc", _try(lambda: s.get(b"c", 60,
                                         kv.IsolationLevel.RC))))
    out.append(("scan_lock", [(li.primary, li.start_ts, li.key)
                              for li in s.scan_lock(b"", b"", 100)]))
    out.append(("conflict", _try(lambda: s.prewrite(
        [kv.Mutation(kv.MutationOp.PUT, b"c", b"x")], b"c", 55))))
    # primary committed, secondary resolved forward; a second txn rolled
    # back, its late commit refused
    s.commit([b"c"], 50, 51)
    out.append(("cleanup", s.cleanup(b"c", 50, 0)))
    s.resolve_lock(b"", b"", 50, 51)
    s.prewrite([kv.Mutation(kv.MutationOp.PUT, b"e", b"e1")], b"e", 70,
               ttl_ms=0)
    out.append(("cleanup_dead", s.cleanup(b"e", 70, 1 << 40)))
    out.append(("late_commit", _try(lambda: s.commit([b"e"], 70, 71))))
    out.append(("rollback_committed", _try(lambda: s.rollback([b"c"], 50))))
    s.prewrite([kv.Mutation(kv.MutationOp.PUT, b"f", b"f1")], b"f", 80)
    s.rollback([b"f"], 80)
    out.append(("reprewrite", _try(lambda: s.prewrite(
        [kv.Mutation(kv.MutationOp.PUT, b"f", b"f2")], b"f", 80))))
    out.append(("bulk", s.bulk_import([(b"g", b"g1"), (b"h", b"h1")],
                                      90, 91)))
    out.append(("final", s.scan(b"", b"", 0, 100), s.batch_get(
        [b"a", b"b", b"c", b"d", b"g", b"zz"], 100)))
    out.append(("desc", s.scan(b"b", b"h", 3, 100, desc=True)))
    out.append(("gc", s.gc(95)))
    out.append(("after_gc", s.scan(b"", b"", 0, 100)))
    s.delete_range(b"g", b"h")
    out.append(("versions", s.data_version, s.max_commit_ts,
                s.scan(b"", b"", 0, 100)))
    return out


def record_sequence(m):
    """Record/index keys (the delta-capture classes) and their effect on
    data_version without a delta sink."""
    kv, tc, out = m.kv, m.tc, []
    s = m.ms.MVCCStore()
    rk = [tc.record_key(13, h) for h in (1, 2, 3)]
    ik = tc.index_key(13, 1, [7], handle=1)
    for i, k in enumerate(rk):
        _put(m, s, k, b"v%d" % i, 10 + 2 * i, 11 + 2 * i)
    out.append(("v0", s.data_version, s.max_commit_ts))
    _put(m, s, ik, b"0", 20, 21)
    out.append(("v1", s.data_version, s.max_commit_ts))
    _put(m, s, b"m_owner_x", b"lease", 22, 23)
    out.append(("v2", s.data_version, s.max_commit_ts))
    out.append(("scan", s.scan(tc.record_prefix(13), b"", 0, 100)))
    return out


def cluster_sequence(m):
    out = []
    c = m.ms.Cluster()
    c.bootstrap(1)
    out.append([(r.id, r.start, r.end, r.version)
                for r in c.all_regions()])
    out.append(c.split_table(13, 4, max_handle=1000))
    out.append(c.split_table(13, 4, max_handle=1000))   # no-op re-run
    c.split(b"m")
    sid = c.add_store()
    r = c.region_by_key(m.tc.record_key(13, 600))
    c.change_leader(r.id, sid)
    out.append([(r.id, r.start, r.end, r.version, r.conf_ver,
                 r.leader_store, r.peer_stores) for r in c.all_regions()])
    c.merge(m.tc.record_key(13, 250))
    out.append([(r.id, r.start, r.end, r.version)
                for r in c.all_regions()])
    out.append(c.region_by_key(m.tc.record_key(13, 999)).id)
    out.append(c.leader_counts())
    return out


def shim_sequence(m):
    """RPC shim region checks: a stale epoch and a wrong leader raise the
    reference's region errors; a current context reads."""
    kv, out = m.kv, []
    c = m.ms.Cluster()
    c.bootstrap(1)
    eng = m.ms.MVCCStore()
    shim = m.ms.RPCShim(c, eng)
    _put(m, eng, b"k", b"v", 10, 11)
    r = c.region_by_key(b"k")
    ctx = m.ms.RegionCtx(r.id, r.version, r.conf_ver, r.leader_store)
    out.append(("get", _try(lambda: shim.kv_get(ctx, b"k", 20))))
    c.split(b"j")
    out.append(("stale", _try(lambda: shim.kv_get(ctx, b"k", 20))))
    r2 = c.region_by_key(b"k")
    ctx2 = m.ms.RegionCtx(r2.id, r2.version, r2.conf_ver, r2.leader_store)
    out.append(("fresh", _try(lambda: shim.kv_get(ctx2, b"k", 20))))
    sid = c.add_store()
    c.change_leader(r2.id, sid)
    out.append(("leader", _try(lambda: shim.kv_get(ctx2, b"k", 20))))
    return out


@pytest.mark.parametrize("scenario", [mvcc_sequence, record_sequence,
                                      cluster_sequence, shim_sequence],
                         ids=lambda f: f.__name__)
def test_same_sequence_same_observations(scenario):
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    assert got == want


def test_the_sequences_observe_something():
    """Guard against a vacuous comparison: locks block SI, the late
    commit and the conflict raise, and splits made regions."""
    obs = dict((o[0], o[1:]) for o in mvcc_sequence(PKGS["torch"]))
    assert obs["si"] == (("raised", "KeyLockedError"),)
    assert obs["rc"][0][0] == "ok"
    assert obs["late_commit"][0][0] == "raised"
    assert obs["conflict"][0][0] == "raised"
    assert len(cluster_sequence(PKGS["torch"])[3]) == 5
    shim = dict(shim_sequence(PKGS["torch"]))
    assert shim["stale"][0] == "raised" and shim["leader"][0] == "raised"
