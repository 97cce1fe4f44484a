"""The port's transactional store (store/: oracle, region cache,
snapshot, Percolator 2PC, lock resolver, MockStorage) against the JAX
package's, scenario by scenario.

Each scenario drives one package's `new_mock_storage` through a 2PC
commit across regions, a stale region cache after splits, a leader
change, an abandoned lock a reader must roll back, a committed primary
whose secondary a reader must roll forward, server-busy backoff and a
write conflict, and returns what a client observes (values read, scans,
raised error classes, the regions and locks left). The port must observe
exactly what the reference does. Secondaries commit synchronously
(`async_commit_secondaries = False`) so the sequences are deterministic.
"""

import types

import pytest

import tidb_tpu.kv as jkv
import tidb_tpu_torch.kv as pkv
from tidb_tpu.store import new_mock_storage as jnew_storage
from tidb_tpu.util import failpoint as jfailpoint
from tidb_tpu_torch.store import new_mock_storage as pnew_storage
from tidb_tpu_torch.util import failpoint as pfailpoint

PKGS = {"jax": types.SimpleNamespace(kv=jkv, new=jnew_storage,
                                     fp=jfailpoint),
        "torch": types.SimpleNamespace(
            kv=pkv, new=lambda: pnew_storage(device="cpu"),
            fp=pfailpoint)}


def _try(fn):
    try:
        return ("ok", fn())
    except Exception as e:     # noqa: BLE001 - the class is the answer
        return ("raised", type(e).__name__)


def _storage(m):
    s = m.new()
    s.async_commit_secondaries = False
    return s


def _regions(s):
    return [(r.start, r.end, r.version) for r in s.cluster.all_regions()]


def two_pc_across_regions(m):
    s, out = _storage(m), []
    s.cluster.split(b"m")
    t = s.begin()
    for k in (b"a", b"k", b"n", b"z"):
        t.set(k, b"v" + k)
    t.commit()
    snap = s.snapshot(s.current_ts())
    out.append(list(snap.iter_range(b"", None)))
    reader = s.begin()
    t2 = s.begin()
    t2.set(b"k", b"new")
    t2.delete(b"z")
    t2.commit()
    out.append((reader.get(b"k"), reader.get(b"z")))       # SI view
    out.append((s.begin().get(b"k"), s.begin().get(b"z")))
    t3, t4 = s.begin(), s.begin()
    t3.set(b"a", b"3")
    t4.set(b"a", b"4")
    t4.commit()
    out.append(_try(t3.commit))
    out.append(s.begin().get(b"a"))
    out.append((_regions(s), s.engine.scan_lock(b"", b"", 1 << 62)))
    s.close()
    return out


def stale_region_cache(m):
    s, out = _storage(m), []
    t = s.begin()
    for k in (b"a", b"p", b"z"):
        t.set(k, b"1")
    t.commit()
    s.region_cache.locate(b"p")        # warm the cache, split behind it
    s.cluster.split(b"m")
    s.cluster.split(b"t")
    snap = s.snapshot(s.current_ts())
    out.append(sorted(snap.batch_get([b"a", b"p", b"z"]).items()))
    t2 = s.begin()
    t2.set(b"a", b"2")
    t2.set(b"z", b"2")
    t2.commit()
    out.append((s.begin().get(b"a"), s.begin().get(b"z"), _regions(s)))
    sid2 = s.cluster.add_store()
    region = s.cluster.region_by_key(b"p")
    s.region_cache.locate(b"p")
    s.cluster.change_leader(region.id, sid2)
    out.append(s.begin().get(b"p"))    # NotLeader -> follow the leader
    s.close()
    return out


def lock_resolution(m):
    kv, s, out = m.kv, _storage(m), []
    t0 = s.begin()
    t0.set(b"k", b"committed")
    t0.set(b"p", b"0")
    t0.set(b"s", b"0")
    t0.commit()
    # a writer that prewrote and died: the reader rolls it back
    start_ts = s.current_ts()
    s.engine.prewrite([kv.Mutation(kv.MutationOp.PUT, b"k", b"orphan")],
                      b"k", start_ts, ttl_ms=0)
    out.append(s.begin().get(b"k"))
    out.append(_try(lambda: s.engine.commit([b"k"], start_ts,
                                            start_ts + 1)))
    # primary committed, the secondary's lock left: the reader rolls it
    # forward
    start_ts = s.current_ts()
    s.engine.prewrite([kv.Mutation(kv.MutationOp.PUT, b"p", b"1"),
                       kv.Mutation(kv.MutationOp.PUT, b"s", b"1")], b"p",
                      start_ts, ttl_ms=0)
    s.engine.commit([b"p"], start_ts, s.current_ts())
    out.append(s.begin().get(b"s"))
    out.append(s.engine.scan_lock(b"", b"", 1 << 62))
    s.close()
    return out


def server_busy_backoff(m):
    kv, s, out = m.kv, _storage(m), []
    t = s.begin()
    t.set(b"k", b"v")
    t.commit()
    calls = {"n": 0}

    def inject(cmd, ctx):
        if cmd == "Get" and calls["n"] < 2:
            calls["n"] += 1
            raise kv.ServerBusyError("busy")

    m.fp.enable("rpc/request", inject)
    try:
        out.append(s.begin().get(b"k"))
    finally:
        m.fp.disable("rpc/request")
    out.append(calls["n"])
    s.close()
    return out


@pytest.mark.parametrize("scenario", [two_pc_across_regions,
                                      stale_region_cache, lock_resolution,
                                      server_busy_backoff],
                         ids=lambda f: f.__name__)
def test_same_scenario_same_observations(scenario):
    want = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    assert repr(got) == repr(want)


def test_the_scenarios_observe_something():
    out = two_pc_across_regions(PKGS["torch"])
    assert out[0] == [(b"a", b"va"), (b"k", b"vk"), (b"n", b"vn"),
                      (b"z", b"vz")]
    assert out[1] == (b"vk", b"vz") and out[2] == (b"new", None)
    assert out[3][0] == "raised"
    assert lock_resolution(PKGS["torch"])[:3] == [
        b"committed", ("raised", "TxnAbortedError"), b"1"]
    assert server_busy_backoff(PKGS["torch"]) == [b"v", 2]
