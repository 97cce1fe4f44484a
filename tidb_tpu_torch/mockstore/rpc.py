"""RPC shim: the "network" between client and storage nodes.

Reference: TiDB's store/tikv/mocktikv/rpc.go:112-464 — every request
carries a region context (id, epoch); the handler re-checks it against the
cluster so the client's region-error retry paths (NotLeader, EpochNotMatch,
ServerBusy) actually execute in tests. Failpoints (ref: rpc.go:465-521
gofail sites rpcServerBusy/rpcCommitResult/rpcCommitTimeout) are the
central registry's `rpc/request` point (util/failpoint.py, the successor
of the ad-hoc `inject` attribute this shim used to carry): tests arm
`failpoint.enable("rpc/request", fn)` with a callable receiving
(cmd, ctx) — or a declarative spec — to raise errors or simulate
timeouts for specific commands; every command, including the per-frame
CopStream re-check, evaluates it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from tidb_tpu_torch.kv import (EpochNotMatchError, IsolationLevel, KVError,
                               Mutation, NotLeaderError, RegionError,
                               ServerBusyError, StoreUnavailableError)
from tidb_tpu_torch.mockstore.cluster import Cluster, Region
from tidb_tpu_torch.mockstore.mvcc import MVCCStore
from tidb_tpu_torch.util import failpoint

__all__ = ["RegionCtx", "RPCShim", "TimeoutError_"]


class TimeoutError_(KVError):
    """Simulated network timeout: the request may or may not have executed
    (drives undetermined-commit handling, ref: 2pc.go:421-431)."""


@dataclass
class RegionCtx:
    region_id: int
    version: int
    conf_ver: int
    store_id: int  # the store the client believes is leader


class RPCShim:
    """Routes commands to the MVCC engine after simulating region checks."""

    def __init__(self, cluster: Cluster, store: MVCCStore):
        self.cluster = cluster
        self.store = store
        self._mu = threading.Lock()
        # storage facade back-ref (set by MockStorage.__init__): the
        # journal-window command needs the node-local DeltaStore, which
        # lives on the facade, not the MVCC engine
        self._storage = None

    def bind_storage(self, storage) -> None:
        self._storage = storage

    # -- region checks -------------------------------------------------------

    def _check(self, cmd: str, ctx: RegionCtx) -> Region:
        failpoint.eval("rpc/request", cmd, ctx)
        if not self.cluster.store_is_up(ctx.store_id):
            # the address the client dialed is dead: connection-level
            # failure (ref: region_request.go onSendFail -> retry other
            # peers after a region reload)
            raise StoreUnavailableError(ctx.region_id, ctx.store_id)
        region = self.cluster.region_by_id(ctx.region_id)
        if region is None:
            raise EpochNotMatchError(ctx.region_id)
        if region.leader_store != ctx.store_id:
            raise NotLeaderError(ctx.region_id, region.leader_store)
        if region.version != ctx.version or region.conf_ver != ctx.conf_ver:
            raise EpochNotMatchError(ctx.region_id)
        return region

    def _check_keys_in(self, region: Region, keys) -> None:
        for k in keys:
            if not region.contains(k):
                raise EpochNotMatchError(region.id)

    # -- commands (mirror tikvrpc CmdType set, tikvrpc.go:31-53) ------------

    def kv_get(self, ctx: RegionCtx, key: bytes, ts: int,
               isolation=IsolationLevel.SI):
        r = self._check("Get", ctx)
        self._check_keys_in(r, [key])
        return self.store.get(key, ts, isolation)

    def kv_batch_get(self, ctx: RegionCtx, keys: list[bytes], ts: int,
                     isolation=IsolationLevel.SI):
        r = self._check("BatchGet", ctx)
        self._check_keys_in(r, keys)
        return self.store.batch_get(keys, ts, isolation)

    def kv_scan(self, ctx: RegionCtx, start: bytes, end: bytes, limit: int,
                ts: int, isolation=IsolationLevel.SI, desc: bool = False):
        r = self._check("Scan", ctx)
        # clamp scan to region bounds
        s = max(start, r.start)
        e = r.end if not end else (min(end, r.end) if r.end else end)
        return self.store.scan(s, e, limit, ts, isolation, desc)

    def kv_prewrite(self, ctx: RegionCtx, mutations: list[Mutation],
                    primary: bytes, start_ts: int, ttl_ms: int = 3000):
        r = self._check("Prewrite", ctx)
        self._check_keys_in(r, [m.key for m in mutations])
        self.store.prewrite(mutations, primary, start_ts, ttl_ms)

    def kv_commit(self, ctx: RegionCtx, keys: list[bytes], start_ts: int,
                  commit_ts: int):
        r = self._check("Commit", ctx)
        self._check_keys_in(r, keys)
        self.store.commit(keys, start_ts, commit_ts)

    def kv_batch_rollback(self, ctx: RegionCtx, keys: list[bytes],
                          start_ts: int):
        r = self._check("BatchRollback", ctx)
        self._check_keys_in(r, keys)
        self.store.rollback(keys, start_ts)

    def kv_cleanup(self, ctx: RegionCtx, key: bytes, start_ts: int,
                   current_ts: int = 0):
        r = self._check("Cleanup", ctx)
        self._check_keys_in(r, [key])
        return self.store.cleanup(key, start_ts, current_ts)

    def kv_scan_lock(self, ctx: RegionCtx, max_ts: int):
        r = self._check("ScanLock", ctx)
        return self.store.scan_lock(r.start, r.end, max_ts)

    def kv_resolve_lock(self, ctx: RegionCtx, start_ts: int, commit_ts: int):
        r = self._check("ResolveLock", ctx)
        self.store.resolve_lock(r.start, r.end, start_ts, commit_ts)

    def kv_delete_range(self, ctx: RegionCtx, start: bytes, end: bytes):
        r = self._check("DeleteRange", ctx)
        self.store.delete_range(max(start, r.start),
                                min(end, r.end) if r.end else end)

    def kv_gc(self, ctx: RegionCtx, safepoint: int):
        r = self._check("GC", ctx)
        return self.store.gc(safepoint, r.start, r.end)

    def split_region(self, ctx: RegionCtx, key: bytes):
        self._check("SplitRegion", ctx)
        return self.cluster.split(key)

    # -- raw KV (ref: tikvrpc.go Raw* commands; rawkv.go client) -------------

    def raw_get(self, ctx: RegionCtx, key: bytes):
        self._check("RawGet", ctx)
        return self.store.raw_get(key)

    def raw_batch_get(self, ctx: RegionCtx, keys: list[bytes]):
        r = self._check("RawBatchGet", ctx)
        self._check_keys_in(r, keys)
        return self.store.raw_batch_get(keys)

    def raw_put(self, ctx: RegionCtx, key: bytes, value: bytes):
        self._check("RawPut", ctx)
        self.store.raw_put(key, value)

    def raw_batch_put(self, ctx: RegionCtx, pairs: list[tuple]):
        r = self._check("RawBatchPut", ctx)
        self._check_keys_in(r, [k for k, _v in pairs])
        self.store.raw_batch_put(pairs)

    def raw_delete(self, ctx: RegionCtx, key: bytes):
        self._check("RawDelete", ctx)
        self.store.raw_delete(key)

    def raw_scan(self, ctx: RegionCtx, start: bytes, end: bytes,
                 limit: int):
        r = self._check("RawScan", ctx)
        end = min(end, r.end) if (end and r.end) else (end or r.end)
        return self.store.raw_scan(max(start, r.start), end, limit)

    def raw_delete_range(self, ctx: RegionCtx, start: bytes, end: bytes):
        r = self._check("RawDeleteRange", ctx)
        end = min(end, r.end) if (end and r.end) else (end or r.end)
        self.store.raw_delete_range(max(start, r.start), end)

    # -- MVCC forensics (debug API, no region ctx: ref
    # server/region_handler.go MvccGetByKey/MvccGetByStartTs) ----------------

    def mvcc_by_key(self, key: bytes):
        return self.store.mvcc_by_key(key)

    def mvcc_by_start_ts(self, start_ts: int, **kw):
        return self.store.mvcc_by_start_ts(start_ts, **kw)

    def journal_window(self, ctx: RegionCtx, table_id: int, start: bytes,
                       end: bytes, fill_ts, read_ts: int, index_id=None):
        """Fleet cache coherence: one round trip returning the engine's
        freshness meta plus the delta-journal window (fill_ts, read_ts]
        for one region range, so a remote SQL server can decide whether
        its resident chunk/HBM block is patchable in place (store/delta.py
        semantics) without re-colding. Region epoch is checked like any
        data command, so truncation races on split/merge surface as
        RegionError and the client re-resolves. The reply is wire-native
        (dicts/tuples/ndarrays only — the STALE sentinel travels as the
        string "stale")."""
        r = self._check("JournalWindow", ctx)
        s = max(start, r.start)
        e = r.end if not end else (min(end, r.end) if r.end else end)
        storage = self._storage
        dstore = getattr(storage, "delta_store", None)
        enabled = dstore is not None and dstore.enabled()
        eng = self.store
        meta = {
            "data_version": eng.data_version,
            "max_commit_ts": eng.max_commit_ts,
            "any_locks": bool(eng._locked_keys),
            "delta_enabled": enabled,
            "locked": enabled and eng.locked_in_range(s, e, read_ts),
            "index_stale": False,
            "delta": None,
        }
        if not enabled or fill_ts is None:
            return meta
        if index_id is not None:
            meta["index_stale"] = dstore.index_stale(table_id, fill_ts,
                                                     read_ts)
            return meta
        pend = dstore.pending(table_id, s, e, fill_ts, read_ts)
        from tidb_tpu_torch.store.delta import STALE
        if pend is STALE:
            meta["delta"] = "stale"
        elif pend is not None:
            meta["delta"] = ("win", pend.watermark, pend.upsert_rows,
                             pend.upsert_handles, pend.delete_handles)
        return meta

    def coprocessor(self, ctx: RegionCtx, req):
        """Executes a pushed-down subplan against this region's data.
        Handler installed by tidb_tpu_torch.store.copr (set at storage build time
        to avoid a module cycle)."""
        r = self._check("Cop", ctx)
        if self._cop_handler is None:
            raise KVError("no coprocessor handler installed")
        return self._cop_handler(r, req)

    def coprocessor_stream(self, ctx: RegionCtx, req, credit=None,
                           frame_bytes=None):
        """Streaming coprocessor (ref: CmdCopStream): lazy generator of
        StreamFrames. The region epoch (and the `rpc/request`
        failpoint, cmd "CopStream") is re-checked before EVERY frame
        delivery, so a
        region split/leader change mid-stream surfaces as a mid-stream
        RegionError — the client resumes from its last acked range
        boundary (store/copr.py). `credit` is unused in-process: the
        consumer pulls the generator, which is perfect backpressure.
        `frame_bytes` is the CLIENT's response-size cap (validated here
        — it also arrives off the wire)."""
        r = self._check("CopStream", ctx)
        if self._cop_stream_handler is None:
            raise KVError("no streaming coprocessor handler installed")
        if frame_bytes is not None:
            if not isinstance(frame_bytes, int) or \
                    isinstance(frame_bytes, bool) or \
                    not 1 <= frame_bytes <= (1 << 31):
                raise KVError(f"bad frame_bytes {frame_bytes!r}")
        gen = self._cop_stream_handler(r, req, frame_bytes=frame_bytes)

        def checked():
            for frame in gen:
                # per-frame failpoint + epoch re-check: an un-delivered
                # frame is never acked, so dropping it here cannot lose
                # rows on resume
                self._check("CopStream", ctx)
                yield frame

        return checked()

    _cop_handler = None
    _cop_stream_handler = None

    def install_cop_handler(self, fn) -> None:
        self._cop_handler = fn

    def install_cop_stream_handler(self, fn) -> None:
        self._cop_stream_handler = fn
