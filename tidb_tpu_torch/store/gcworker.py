"""MVCC garbage collection worker: the port's copy of the JAX package's
store/gcworker.py.

Reference: TiDB's store/tikv/gcworker/gc_worker.go — a single
elected leader ticks (gc_worker.go:117-214), computes the safepoint
(now - gc_life_time), resolves all locks below it (:325), drains the
delete-range queue left by DDL (ddl/delete_range.go), then runs
region-parallel GC RPCs (doGC :482). safepoint.go: stores reject reads
below the safepoint.

Here the leader lease lives in a plain KV key (the reference uses rows in
mysql.tidb, gc_worker.go:550) so multiple in-process "servers" sharing a
store elect exactly one worker; the tick is driven explicitly by
run_once() rather than a background goroutine — callers (tests, the
session's housekeeping, a real server's timer thread) own the cadence.
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

from tidb_tpu_torch import kv
from tidb_tpu_torch.kv import GCTooEarlyError
from tidb_tpu_torch.meta import Meta
from tidb_tpu_torch.store.backoff import BO_REGION_MISS, Backoffer
from tidb_tpu_torch.store.oracle import compose_ts, physical_ms

__all__ = ["GCWorker", "GCTooEarlyError", "DEFAULT_GC_LIFE_TIME_MS"]

DEFAULT_GC_LIFE_TIME_MS = 10 * 60 * 1000    # ref: gcDefaultLifeTime 10m
GC_SAFEPOINT_KEY = b"m_gcSafePoint"
GC_LEADER_KEY = b"m_gcLeader"
GC_LEADER_LEASE_MS = 2 * 60 * 1000          # ref: gcWorkerLease 2m
GC_CONCURRENCY = 4
RESOLVE_MAX_BACKOFF = 20000


class GCWorker:
    def __init__(self, storage, gc_life_time_ms: int =
                 DEFAULT_GC_LIFE_TIME_MS):
        self.storage = storage
        self.gc_life_time_ms = gc_life_time_ms
        self.uuid = uuid.uuid4().hex[:12]
        self._mu = threading.Lock()

    # -- leader lease --------------------------------------------------------

    def _try_lead(self, now_ms: int) -> bool:
        """Acquire/renew the leader lease (ref: gc_worker.go:550
        checkLeader over mysql.tidb lease rows)."""
        txn = self.storage.begin()
        try:
            raw = txn.get(GC_LEADER_KEY)
            if raw is not None:
                try:
                    owner, expiry = raw.decode().split(":")
                    expiry = int(expiry)
                except ValueError:
                    owner, expiry = "", 0   # corrupt lease: take over
                if owner != self.uuid and expiry > now_ms:
                    return False
            txn.set(GC_LEADER_KEY,
                    f"{self.uuid}:{now_ms + GC_LEADER_LEASE_MS}".encode())
            txn.commit()
            return True
        except kv.RetryableError:
            return False
        finally:
            if txn.valid:
                txn.rollback()

    # -- safepoint -----------------------------------------------------------

    def saved_safepoint(self) -> int:
        txn = self.storage.begin()
        try:
            raw = txn.get(GC_SAFEPOINT_KEY)
            return int(raw) if raw else 0
        finally:
            txn.rollback()

    def _save_safepoint(self, sp: int) -> None:
        txn = self.storage.begin()
        try:
            txn.set(GC_SAFEPOINT_KEY, b"%d" % sp)
            txn.commit()
        except Exception:
            txn.rollback()
            raise
        # push to the store for read-visibility checks (safepoint.go watch)
        self.storage.update_safepoint(sp)

    # -- the tick ------------------------------------------------------------

    def run_once(self, now_ts: int | None = None) -> dict:
        """One GC cycle; returns stats. No-op unless leader and the new
        safepoint advances past the saved one."""
        if now_ts is None:
            now_ts = self.storage.current_ts()
        now_ms = physical_ms(now_ts)
        if not self._try_lead(now_ms):
            return {"leader": False}
        safepoint = compose_ts(max(0, now_ms - self.gc_life_time_ms), 0)
        # never advance past an in-flight reorg's read snapshot (the
        # reference keeps the safepoint below active DDL reorg snapshots)
        reorg = self._min_reorg_snapshot()
        if reorg is not None:
            safepoint = min(safepoint, reorg)
        prev = self.saved_safepoint()
        if safepoint <= prev:
            return {"leader": True, "safepoint": prev, "advanced": False}

        locks = self._resolve_locks(safepoint)
        # publish BEFORE destroying anything: readers in
        # (prev, safepoint) must start failing check_visibility before
        # their versions can disappear
        self._save_safepoint(safepoint)
        ranges = self._drain_delete_ranges(safepoint)
        pruned = self._gc_regions(safepoint)
        return {"leader": True, "safepoint": safepoint, "advanced": True,
                "resolved_locks": locks, "delete_ranges": ranges,
                "pruned": pruned}

    def _min_reorg_snapshot(self) -> int | None:
        txn = self.storage.begin()
        try:
            job = Meta(txn).first_job()
        finally:
            txn.rollback()
        if job is not None and job.snapshot_ver:
            return job.snapshot_ver
        return None

    # -- phases --------------------------------------------------------------

    def _region_rpc(self, key: bytes, fn):
        """fn(loc) with the standard region-error retry discipline
        (ref: region_request.go): invalidate + re-locate on stale epoch."""
        bo = Backoffer(RESOLVE_MAX_BACKOFF)
        while True:
            loc = self.storage.region_cache.locate(key)
            try:
                return loc, fn(loc)
            except kv.NotLeaderError as e:
                self.storage.region_cache.on_not_leader(e)
                bo.backoff(BO_REGION_MISS, e)
            except kv.RegionError as e:
                self.storage.region_cache.invalidate(loc.region.id)
                bo.backoff(BO_REGION_MISS, e)

    def _each_region_rpc(self, fn):
        """Run fn over every region left to right; yields results."""
        key = b""
        while True:
            loc, out = self._region_rpc(key, fn)
            yield loc, out
            if not loc.region.end:
                return
            key = loc.region.end

    def _resolve_locks(self, safepoint: int) -> int:
        """Any lock below the safepoint belongs to a dead or paused txn:
        roll it forward/back before its intent becomes unreachable
        (ref: gc_worker.go:325 resolveLocks)."""
        n = 0
        for _loc, locks in self._each_region_rpc(
                lambda loc: self.storage.shim.kv_scan_lock(loc.ctx,
                                                           safepoint)):
            if locks:
                # every lock below the safepoint is gc_life_time old: its
                # TTL has long expired, so resolve rolls it forward/back
                bo = Backoffer(RESOLVE_MAX_BACKOFF)
                self.storage.resolver.resolve(bo, locks)
                n += len(locks)
        return n

    def _drain_delete_ranges(self, safepoint: int) -> int:
        """Physically delete ranges queued by DDL drops, but only once the
        safepoint has passed the drop itself — older snapshots may still
        legitimately read the data (ref: gc_worker.go:325 deleteRanges
        over mysql.gc_delete_range, filtered by its ts column)."""
        self._reseal_orphans()
        txn = self.storage.begin()
        try:
            pending = [r for r in Meta(txn).pending_delete_ranges()
                       if 0 < r[4] <= safepoint]   # sealed + safepoint past
        finally:
            txn.rollback()
        for qkey, _job, start, end, _ts in pending:
            cur = start
            while True:
                loc, _ = self._region_rpc(
                    cur, lambda loc, cur=cur: self.storage.shim.
                    kv_delete_range(
                        loc.ctx, max(cur, loc.region.start or cur),
                        min(end, loc.region.end) if loc.region.end
                        else end))
                if not loc.region.end or loc.region.end >= end:
                    break
                cur = loc.region.end
            txn = self.storage.begin()
            try:
                Meta(txn).remove_delete_range(qkey)
                txn.commit()
            except Exception:
                txn.rollback()
                raise
        return len(pending)

    def _reseal_orphans(self) -> None:
        """Seal unsealed ranges whose DDL job already finished — covers a
        worker that crashed between its final job txn and the seal, so no
        dropped data leaks forever."""
        txn = self.storage.begin()
        try:
            m = Meta(txn)
            orphan_jobs = {job_id for _k, job_id, _s, _e, ts
                           in m.pending_delete_ranges()
                           if ts == 0 and m.history_job(job_id) is not None}
            for job_id in orphan_jobs:
                m.seal_delete_ranges(job_id, txn.start_ts)
            if orphan_jobs:
                txn.commit()
            else:
                txn.rollback()
        except Exception:
            if txn.valid:
                txn.rollback()

    def _gc_regions(self, safepoint: int) -> int:
        """Region-parallel GC RPCs (ref: doGC gc_worker.go:482)."""
        starts = [loc.region.start
                  for loc, _ in self._each_region_rpc(lambda loc: None)]
        total = 0
        with ThreadPoolExecutor(max_workers=GC_CONCURRENCY,
                                thread_name_prefix="gc") as pool:
            for _loc, pruned in pool.map(
                    lambda k: self._region_rpc(
                        k, lambda loc: self.storage.shim.kv_gc(loc.ctx,
                                                               safepoint)),
                    starts):
                total += int(pruned or 0)
        return total
