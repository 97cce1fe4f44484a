"""MVCC delta store: the columnar/HBM cache planes stay hot under
concurrent OLTP writes.

The port's copy of the JAX package's store/delta.py (numpy, no device
work of its own): a triggered merge runs as a supervised one-shot with
counted restarts (util/supervisor.run_once) on a background thread that
`join()` waits for, and re-fills HBM blocks under a scheduler dispatch
slot (sched.device_slot). One deviation: a merge re-stamps a cached
region block that took no write since its fill (the journal window
holds nothing for its range) at the merge's target in both caches,
where the reference drops it and the next read re-scans the region
cold.

Before this module, HTAP was read-only in practice: ANY committed write
bumped the engine's data_version and wholesale-invalidated both the
columnar chunk cache (store/chunk_cache.py) and the HBM device cache
(store/device_cache.py) — a trickle of new-order/payment updates
re-colded gigabytes of device-resident columns. This removes that
true-write cliff:

* **Capture.** The MVCC engine journals committed ROW mutations here
  per table — (handle, key, value|None, commit_ts), sorted by commit
  ts — under the engine lock, atomically with the commit becoming
  readable (mockstore/mvcc.py commit/resolve_lock). Index-key commits
  advance a per-table index watermark instead (index layouts cannot be
  patched by row values). data_version now bumps only for structural
  changes (meta/DDL, GC, delete-range, bulk import).

* **Serve.** A cached block filled at fill_ts serves a reader at
  read_ts as `base ⋈ delta`: the journal window (fill_ts, read_ts] is
  folded over the base — upserts/deletes merged on row handles, the
  result memoized on the base chunk per watermark — instead of
  discarding the block (store/copr.py `_cached_range_chunk`). The HBM
  cache patches its resident device arrays in place the same way
  (store/device_cache.py `apply_pending`: validity/value scatters plus
  tail appends into the padding, dict columns extended incrementally).

* **Merge.** Accumulated deltas fold into new base blocks at snapshot
  boundaries: the background merge promotes the read path's memoized
  base⋈delta results to cache entries, re-fills lagging HBM blocks
  under the device scheduler's dispatch slots (merges never starve
  serving), then truncates the journal below the new floor. Triggers:
  staged rows (`tidb_tpu_delta_merge_rows`), delta/base row ratio
  (`tidb_tpu_delta_merge_ratio_pct`), and the SERVER shed chain —
  staged bytes are billed to a server-scope `delta-store` memtrack
  node, and the registered spill action forces an early merge so
  `GET /shed` and admission-driven shedding reclaim them.

MVCC correctness: the journal is an ACCELERATOR — the engine remains
the source of truth. A reader at ts T applies only deltas with
commit_ts <= T, so it can never see a later commit; truncation below a
live entry's fill_ts is answered with STALE, which drops the entry back
to a real scan. Pending Percolator locks are handled by the engine's
serve-time `locked_in_range` veto, not by this module.
"""

from __future__ import annotations

import bisect
import threading
import weakref
from collections import OrderedDict

import numpy as np

from tidb_tpu_torch import config, memtrack, metrics
from tidb_tpu_torch.store import oracle
from tidb_tpu_torch.util import failpoint

__all__ = ["DeltaStore", "PendingDelta", "STALE", "tracker",
           "record_handles"]


# pending() answer when the journal was truncated below the asked
# window: the entry can no longer be patched forward — drop it and
# re-scan (the engine still has every version)
STALE = object()

# ~fixed per-record journal overhead (tuple + list slot + ts entry)
_REC_OVERHEAD = 96

_tracker_lock = threading.Lock()
_tracker: memtrack.MemTracker | None = None   # guarded-by: _tracker_lock

# every live store, for the single server-wide shed action; weak so
# short-lived test storages don't accumulate forever
_stores: "weakref.WeakSet[DeltaStore]" = \
    weakref.WeakSet()               # guarded-by: _tracker_lock
_shed_registered = False            # guarded-by: _tracker_lock
# staged rows across every live store (the DELTA_ROWS gauge is
# process-wide, stores are per-storage)
_rows_total = [0]                   # guarded-by: _tracker_lock

# serializes base⋈delta memo access on cached base chunks (patch_chunk
# and the merge's promotion walk share it)
_patch_mu = threading.Lock()


def tracker() -> memtrack.MemTracker:
    """The shared server-scope tracker node delta staging bills
    (label `delta-store`, host ledger)."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = memtrack.server_node("delta-store")
        return _tracker


def _shed_all() -> None:
    """The registered memtrack spill action: force an early merge in
    every live store, folding + truncating staged deltas (frees the
    staged journal bytes on the delta-store ledger). Snapshot under the
    lock — iterating the WeakSet bare races a concurrent store
    construction's add() (same discipline as device_cache._shed_all)."""
    with _tracker_lock:
        stores = list(_stores)
    for store in stores:
        store.merge(trigger="shed")


def _note_rows(delta: int) -> int:
    with _tracker_lock:
        _rows_total[0] += delta
        return _rows_total[0]


def _release_staged(staged: list) -> None:
    """GC finalizer: credit back whatever a dead store still held."""
    freed, staged[0] = staged[0], 0
    rows, staged[1] = staged[1], 0
    if freed:
        tracker().release(host=freed)
    if rows:
        metrics.gauge(metrics.DELTA_ROWS, _note_rows(-rows))


def _register(store: "DeltaStore") -> None:
    global _shed_registered
    with _tracker_lock:
        _stores.add(store)
        if not _shed_registered:
            memtrack.SERVER.add_spill_action(_shed_all)
            _shed_registered = True


def record_handles(keys) -> np.ndarray:
    """Row handles of raw record keys, vectorized: a record key is the
    fixed 19-byte t{tid:8}_r{handle:8} layout (tablecodec), so the
    handle is the sign-flipped big-endian tail. Falls back to the codec
    on anything unexpected."""
    n = len(keys)
    buf = b"".join(keys)
    if len(buf) == 19 * n:
        tail = np.frombuffer(buf, dtype=np.uint8).reshape(n, 19)[:, 11:]
        u = np.ascontiguousarray(tail).view(">u8").reshape(n)
        return (u.astype(np.uint64) ^ np.uint64(1 << 63)).view(np.int64)
    from tidb_tpu_torch import tablecodec
    return np.fromiter(
        (tablecodec.decode_record_key(k)[1] for k in keys),
        dtype=np.int64, count=n)


class PendingDelta:
    """The net effect of one journal window over one key range:
    last-wins upserts (raw rows for plan-layout decode, handles
    aligned) and deletes, plus the watermark the consumer advances its
    fill_ts to after applying."""

    __slots__ = ("watermark", "upsert_rows", "upsert_handles",
                 "delete_handles", "decoded")

    def __init__(self, watermark: int, upsert_rows: list,
                 upsert_handles: np.ndarray,
                 delete_handles: np.ndarray):
        self.watermark = watermark
        self.upsert_rows = upsert_rows          # [(key, value)] order-
        self.upsert_handles = upsert_handles    # aligned with handles
        self.delete_handles = delete_handles
        self.decoded = None     # plan-layout chunk, set by the caller


class _TableDeltas:
    __slots__ = ("records", "ts", "index_commits", "floor", "rows",
                 "bytes", "base_rows")

    def __init__(self):
        self.records: list = []        # (cts, handle, key, value|None)
        self.ts: list = []             # commit_ts of records, sorted
        self.index_commits: list = []  # sorted commit_ts of index keys
        self.floor = 0                 # journal truncated at/below this
        self.rows = 0
        self.bytes = 0
        self.base_rows = 0             # largest cached base seen


class DeltaStore:
    """Per-storage staged delta journal + fold/merge engine. Thread
    safety: `_mu` guards the table map and counters; every cache /
    memtrack / metrics call happens with it dropped (ingest runs under
    the ENGINE lock — see mockstore/mvcc.py — so this lock must stay a
    near-leaf)."""

    def __init__(self, storage):
        self._storage = storage
        self._mu = threading.Lock()
        self._tables: dict[int, _TableDeltas] = {}   # guarded-by: _mu
        # [bytes, rows] shared with a GC finalizer: a store dropped
        # without close() still returns its ledger share
        self._staged = [0, 0]                        # guarded-by: _mu
        self._merging = False                        # guarded-by: _mu
        self._bg: list[threading.Thread] = []        # guarded-by: _mu
        weakref.finalize(self, _release_staged, self._staged)
        _register(self)

    def enabled(self) -> bool:
        """Capture on? Flipping `tidb_tpu_delta_store` OFF while the
        journal holds staged rows must not strand them: those commits
        never bumped data_version, and with the store disabled nothing
        would fold them in — cached entries would serve PRE-update data
        indefinitely. The first consult after the flip flushes: drop
        the journal and bump the engine's structural version once, so
        every cached entry re-fills from the legacy contract."""
        if config.delta_store_enabled():
            return True
        if self._staged[1]:
            self._flush_on_disable()
        return False

    def _flush_on_disable(self) -> None:
        with self._mu:
            freed, self._staged[0] = self._staged[0], 0
            rows, self._staged[1] = self._staged[1], 0
            self._tables.clear()
        if not rows:
            return      # another thread flushed first
        # bump AFTER the journal is gone, with _mu dropped (the engine
        # lock is re-entrant here when the consult came from the
        # engine's own capture check)
        engine = self._storage.engine
        with engine._mu:
            engine.data_version += 1
        if freed:
            tracker().release(host=freed)
        metrics.gauge(metrics.DELTA_ROWS, _note_rows(-rows))

    # -- capture (called by the MVCC engine, under the engine lock) ---------

    def ingest(self, records: list, idx_notes: list) -> bool:
        """Journal one commit's record mutations + index notes.
        records: [(table_id, handle, key, value|None, commit_ts)].
        -> False when capture is off (the engine then falls back to the
        legacy data_version bump)."""
        if not self.enabled():
            return False
        add_bytes = 0
        add_rows = 0
        with self._mu:
            for tid, handle, key, value, cts in records:
                td = self._tables.get(tid)
                if td is None:
                    td = self._tables[tid] = _TableDeltas()
                rec = (cts, handle, key, value)
                if not td.ts or cts >= td.ts[-1]:
                    td.records.append(rec)
                    td.ts.append(cts)
                else:   # out-of-order commit: keep the journal sorted
                    i = bisect.bisect_right(td.ts, cts)
                    td.records.insert(i, rec)
                    td.ts.insert(i, cts)
                nb = len(key) + (len(value) if value else 0) + \
                    _REC_OVERHEAD
                td.rows += 1
                td.bytes += nb
                add_bytes += nb
                add_rows += 1
            for tid, cts in idx_notes:
                td = self._tables.get(tid)
                if td is None:
                    td = self._tables[tid] = _TableDeltas()
                ic = td.index_commits
                if not ic or cts >= ic[-1]:
                    ic.append(cts)
                else:
                    bisect.insort(ic, cts)
            self._staged[0] += add_bytes
            self._staged[1] += add_rows
        if add_bytes:
            # staged journal bytes: released when the merge truncates (or
            # close/shed); a GC finalizer backstops dead stores
            tracker().consume(host=add_bytes)
        if add_rows:
            metrics.gauge(metrics.DELTA_ROWS, _note_rows(add_rows))
        self._maybe_trigger()
        return True

    # -- read-side queries ---------------------------------------------------

    def pending(self, table_id: int, s: bytes, e: bytes, lo_ts: int,
                hi_ts: int):
        """Net delta for record keys in [s, e) committed in
        (lo_ts, hi_ts]: a PendingDelta, None when the window holds
        nothing for the range, or STALE when the journal was truncated
        above lo_ts (the entry can't be patched — drop and re-scan)."""
        with self._mu:
            td = self._tables.get(table_id)
            if td is None:
                return None
            if td.floor > lo_ts:
                return STALE
            if not td.ts or td.ts[-1] <= lo_ts:
                return None
            lo_i = bisect.bisect_right(td.ts, lo_ts)
            hi_i = bisect.bisect_right(td.ts, hi_ts)
            if hi_i <= lo_i:
                return None
            window = td.records[lo_i:hi_i]
            watermark = td.ts[hi_i - 1]
        net: "OrderedDict[int, tuple]" = OrderedDict()
        for _cts, handle, key, value in window:
            if key < s or (e and key >= e):
                continue
            net.pop(handle, None)       # last-wins, append order kept
            net[handle] = (key, value)
        if not net:
            return None
        upsert_rows = []
        upsert_handles = []
        deletes = []
        for handle, (key, value) in net.items():
            if value is None:
                deletes.append(handle)
            else:
                upsert_rows.append((key, value))
                upsert_handles.append(handle)
        return PendingDelta(
            watermark, upsert_rows,
            np.asarray(upsert_handles, dtype=np.int64),
            np.asarray(deletes, dtype=np.int64))

    def index_stale(self, table_id: int, fill_ts: int,
                    read_ts: int) -> bool:
        """Did any index-key commit land in (fill_ts, read_ts]? Index
        layouts can't be patched from row values, so a stale index
        entry is dropped and re-filled at a newer snapshot."""
        with self._mu:
            td = self._tables.get(table_id)
            if td is None:
                return False
            if td.floor > fill_ts:
                return True
            ic = td.index_commits
            i = bisect.bisect_right(ic, fill_ts)
            return i < len(ic) and ic[i] <= read_ts

    def note_base_rows(self, table_id: int, nrows: int) -> None:
        """Feed the delta/base ratio trigger the size of a base block
        the read path just served."""
        with self._mu:
            td = self._tables.get(table_id)
            if td is not None and nrows > td.base_rows:
                td.base_rows = nrows

    # -- host-side base ⋈ delta ---------------------------------------------

    def patch_chunk(self, cache, key, plan, chunk, pend: PendingDelta):
        """The cached base chunk with `pend` folded in — upserts/deletes
        merged on row handles, result sorted by handle (scan order) and
        memoized on the base per watermark so repeated hot reads at one
        delta state pay the merge once. -> merged chunk (its
        _scan_handles attached, its decoded upserts left on
        pend.decoded for the device layer), or None when the base
        carries no handles (unpatchable: caller drops the entry)."""
        base_handles = getattr(chunk, "_scan_handles", None)
        if base_handles is None:
            return None
        with _patch_mu:
            memo = getattr(chunk, "_delta_memo", None)
            hit = memo.get(pend.watermark) if memo else None
            if hit is not None:
                return hit
        from tidb_tpu_torch.store.copr import decode_cop_batch
        dchunk = decode_cop_batch(plan, pend.upsert_rows)
        pend.decoded = dchunk
        affected = np.concatenate([pend.upsert_handles,
                                   pend.delete_handles])
        keep = ~np.isin(base_handles, affected)
        kept_idx = np.flatnonzero(keep)
        kept = chunk.take(kept_idx)
        if dchunk.num_rows:
            merged = kept.concat(dchunk)
            mh = np.concatenate([base_handles[kept_idx],
                                 pend.upsert_handles])
            order = np.argsort(mh, kind="stable")
            merged = merged.take(order)
            mh = mh[order]
        else:
            merged, mh = kept, base_handles[kept_idx]
        merged._scan_handles = mh
        self.note_base_rows(plan.table.id, len(base_handles))
        from tidb_tpu_torch.store.chunk_cache import _chunk_bytes
        cost = _chunk_bytes(merged)
        evicted = 0
        with _patch_mu:
            memo = getattr(chunk, "_delta_memo", None)
            if memo is None:
                memo = chunk._delta_memo = OrderedDict()
            if pend.watermark not in memo:
                memo[pend.watermark] = merged
                while len(memo) > 2:
                    _w, old = memo.popitem(last=False)
                    evicted += _chunk_bytes(old)
            else:
                merged = memo[pend.watermark]
                cost = 0
        # memoized merges ride the base entry's budget share, exactly
        # like the filter memos (evicting the base drops them all)
        if cost or evicted:
            cache.add_cost(key, cost - evicted)
        return merged

    def best_memo(self, chunk):
        """Newest memoized base⋈delta of a cached base, as
        (watermark, merged_chunk) — the merge's promotion source."""
        with _patch_mu:
            memo = getattr(chunk, "_delta_memo", None)
            if not memo:
                return None
            w = max(memo)
            return w, memo[w]

    # -- merge ---------------------------------------------------------------

    def _maybe_trigger(self) -> None:
        """Spawn a background merge when a table's staged rows cross
        the row threshold or the delta/base ratio. Cheap enough for the
        ingest path: two int compares per table touched."""
        rows_cap = config.delta_merge_rows()
        ratio = config.delta_merge_ratio_pct()
        trigger = None
        with self._mu:
            if self._merging:
                return
            for td in self._tables.values():
                if td.rows >= rows_cap:
                    trigger = "rows"
                    break
                if ratio and td.base_rows and \
                        td.rows * 100 >= td.base_rows * ratio:
                    trigger = "ratio"
                    break
        if trigger is not None:
            # supervised one-shot (util/supervisor.py): a merge that
            # crashes (device fault mid-refill, injected delta/merge
            # failpoint) retries with counted backoff instead of leaving
            # the journal to grow unmerged; one that gives up leaves the
            # journal as it was, and the next ingest triggers another
            from tidb_tpu_torch.util import supervisor
            t = threading.Thread(
                target=supervisor.run_once, name="delta-merge",
                args=("delta-merge", lambda: self.merge(trigger)),
                daemon=True)
            with self._mu:
                self._bg = [b for b in self._bg if b.is_alive()] + [t]
            t.start()

    def join(self, timeout: float | None = None) -> None:
        """Wait for the background merges this store started."""
        with self._mu:
            threads = list(self._bg)
        for t in threads:
            t.join(timeout)

    def merge(self, trigger: str = "rows") -> int:
        """Fold staged deltas into new base blocks and truncate the
        journal. -> journal rows released. Serving stays correct (and
        mostly warm) throughout: promotion reuses the read path's
        memoized base⋈delta results, HBM blocks re-fill from them,
        and readers racing the truncation get
        STALE -> re-scan."""
        from tidb_tpu_torch import trace
        with self._mu:
            if self._merging:
                return 0
            self._merging = True
            tids = list(self._tables)
        freed_rows = 0
        try:
            # background merges run untraced; a SHED-forced merge fires
            # on the admitting statement's thread, where this span puts
            # the fold cost on that statement's timeline
            with trace.span("delta.merge", trigger=trigger):
                for tid in tids:
                    freed_rows += self._merge_table(tid)
        finally:
            with self._mu:
                self._merging = False
        if freed_rows:
            metrics.counter(metrics.DELTA_MERGES, {"trigger": trigger})
            metrics.gauge(metrics.DELTA_ROWS, _note_rows(-freed_rows))
        return freed_rows

    def _merge_table(self, tid: int) -> int:
        # injectable merge-worker crash: fires before any cache is
        # touched, so a raise leaves serving state intact and a later
        # merge starts from scratch
        failpoint.eval("delta/merge", tid)
        storage = self._storage
        with self._mu:
            td = self._tables.get(tid)
            if td is None or (not td.ts and not td.index_commits):
                return 0
            target = max(td.ts[-1] if td.ts else 0,
                         td.index_commits[-1] if td.index_commits else 0)
        engine = storage.engine
        cc = storage.chunk_cache
        dc = getattr(storage, "device_cache", None)
        dv_now = engine.data_version
        promoted: dict = {}     # chunk key -> (watermark, merged chunk)
        floors = []
        for key, dv, fill_ts, chunk in cc.snapshot_table(tid):
            if dv != dv_now:
                cc.drop(key)            # structurally dead anyway
                continue
            if fill_ts >= target:
                floors.append(fill_ts)
                continue
            if key[3] is not None:      # index entry: unpatchable
                if self.index_stale(tid, fill_ts, target):
                    cc.drop(key)
                else:
                    floors.append(fill_ts)
                continue
            memo = self.best_memo(chunk)
            if memo is None or memo[0] <= fill_ts:
                if self.pending(tid, key[6], key[7], fill_ts,
                                target) is None:
                    # no write landed in the region since its fill: the
                    # entry is the region at `target` too (the JAX
                    # package drops it, re-colding the region)
                    if cc.restamp(key, fill_ts, target):
                        floors.append(target)
                    continue
                # cold since the writes landed: re-colding it is honest
                cc.drop(key)
                continue
            w, merged = memo
            cc.put(key, dv, w, merged)
            promoted[key] = (w, merged)
            floors.append(w)
        if dc is not None:
            from tidb_tpu_torch import sched
            for dkey, dv, fill_ts in dc.snapshot_table(tid):
                if dv != dv_now:
                    dc.drop(dkey)
                    continue
                if fill_ts >= target:
                    floors.append(fill_ts)
                    continue
                pro = promoted.get(dkey[0])
                if pro is None:
                    ck = dkey[0]
                    if self.pending(tid, ck[6], ck[7], fill_ts,
                                    target) is None and \
                            dc.restamp(dkey, fill_ts, target):
                        # untouched region: the resident block stays
                        floors.append(target)
                    else:
                        dc.drop(dkey)
                    continue
                w, merged = pro
                # re-fill under a dispatch slot: merge uploads compete
                # with serving through the same global window instead
                # of starving it
                dc.drop(dkey)
                with sched.device_slot():
                    dc.fill(dkey, dv, w, merged)
                floors.append(w)
        floor = min(floors, default=target)
        retain = config.delta_retain_ms()
        if retain > 0:
            # store-plane mode: this node's own caches say nothing about
            # remote fleet caches, whose fill snapshots only reach us as
            # journal-window pulls. Keep a wall-clock window of journal
            # so a remote fill at most `retain` ms old still patches
            # instead of going STALE -> full re-fill
            floor = min(floor, oracle.retention_ts(retain))
        freed_bytes = 0
        freed_rows = 0
        with self._mu:
            td = self._tables.get(tid)
            if td is None:
                return 0
            cut = bisect.bisect_right(td.ts, floor)
            for _cts, _h, key, value in td.records[:cut]:
                freed_bytes += len(key) + \
                    (len(value) if value else 0) + _REC_OVERHEAD
            del td.records[:cut], td.ts[:cut]
            freed_rows = cut
            td.rows -= cut
            td.bytes -= freed_bytes
            icut = bisect.bisect_right(td.index_commits, floor)
            del td.index_commits[:icut]
            td.floor = max(td.floor, floor)
            self._staged[0] -= freed_bytes
            self._staged[1] -= freed_rows
        if freed_bytes:
            tracker().release(host=freed_bytes)
        return freed_rows

    # -- introspection / lifecycle ------------------------------------------

    def rows_current(self) -> int:
        with self._mu:
            return self._staged[1]

    def staged_bytes(self) -> int:
        with self._mu:
            return self._staged[0]

    def snapshot(self) -> dict:
        with self._mu:
            return {"tables": len(self._tables),
                    "rows": self._staged[1],
                    "bytes": self._staged[0]}

    def close(self) -> None:
        """Drop the journal, credit the ledger back (the caches are
        going away with the storage; nothing left to fold into)."""
        with self._mu:
            freed, self._staged[0] = self._staged[0], 0
            rows, self._staged[1] = self._staged[1], 0
            self._tables.clear()
        if freed:
            tracker().release(host=freed)
        if rows:
            metrics.counter(metrics.DELTA_MERGES, {"trigger": "close"})
            metrics.gauge(metrics.DELTA_ROWS, _note_rows(-rows))
