"""Columnar region-chunk cache: decode KV rows into columns once.

The reference decodes row bytes into Datums on every coprocessor request
(TiDB's store/tikv/mocktikv/executor.go row loop; TiKV does the
same server-side). Repeated analytical scans — the HTAP read pattern this
framework is built for — re-pay that decode on every query. Here the
storage side keeps the DECODED columnar chunk per (region, column-layout,
range) and serves subsequent scans straight from it: the TPU-first
analogue of TiFlash's columnar replica, collapsed into the storage node.

MVCC correctness — the (fill_version, fill_ts, delta_watermark)
freshness contract. An entry records the engine's STRUCTURAL state
version and the fill snapshot ts, and is served only when
  * the engine's data_version is unchanged. The version now bumps only
    on structural changes (meta/DDL writes, GC, delete-range, bulk
    import, anything outside the record/index key namespaces): with the
    delta store active (store/delta.py), committed ROW mutations are
    journaled per table instead, and the serve path (store/copr.py)
    applies the journal window (fill_ts, read_ts] on top of the cached
    base — base + delta — rather than discarding the entry. Pending
    Percolator locks are handled by a serve-time range veto
    (MVCCStore.locked_in_range): a lock a reader must observe forces
    the real scan path, which raises KeyLockedError for resolution
    exactly as an uncached read would; and
  * read_ts >= fill_ts (the base reflects every commit up to fill_ts;
    an OLDER snapshot must not see them).
The filler must additionally guarantee fill_ts covers every commit in the
store (store/copr.py checks MVCCStore.max_commit_ts): a long-running old
snapshot's scan is correct for ITS ts but would poison newer readers if
cached — and every commit AFTER fill_ts is then either in the journal
(record keys) or bumps the version (everything else), so 'base at
fill_ts plus journal window' is exact. Transaction-local dirty reads
never reach the coprocessor path at all (executor TableReaderExec falls
back to the union store).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from tidb_tpu_torch import memtrack

__all__ = ["ChunkCache"]


def _chunk_bytes(chunk) -> int:
    """Estimated host footprint: numpy buffers at their real size, object
    (string) columns at pointer + payload length."""
    return memtrack.chunk_bytes(chunk)


class ChunkCache:
    """LRU over decoded region chunks, bounded by estimated BYTES (rows
    alone under-count wide/string layouts by orders of magnitude).

    The budget must hold every layout a hot analytical mix scans —
    entries are keyed per column layout, so one table queried three ways
    costs three entries. Undersizing is silent but expensive: each
    evicted layout re-decodes AND re-uploads to HBM every execution
    (device chunks are memoized on the cached chunk objects)."""

    def __init__(self, max_bytes: int = 4 << 30):
        self.max_bytes = max_bytes
        self._mu = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(region, plan, s: bytes, e: bytes):
        return (region.id, region.version, plan.table.id,
                plan.index.id if plan.index is not None else None,
                tuple(c.id for c in plan.cols), plan.handle_col, s, e)

    @staticmethod
    def _fresh(ent, data_version: int, read_ts: int) -> bool:
        """THE freshness predicate, shared by peek() and lookup() (and
        mirrored by the delta-aware serve path in store/copr.py): an
        entry serves a reader iff its fill version matches the engine's
        structural data_version AND the reader's snapshot is at/after
        the fill snapshot. Committed row writes no longer bump the
        version (store/delta.py journals them instead), so 'fresh' here
        means 'fresh up to fill_ts' — the serve path then applies the
        journal window (fill_ts, read_ts] on top."""
        return ent[0] == data_version and read_ts >= ent[1]

    def get(self, key, data_version: int, read_ts: int):
        hit = self.lookup(key, data_version, read_ts)
        return None if hit is None else hit[1]

    def peek(self, key, data_version: int, read_ts: int) -> int | None:
        """Would lookup() hit? -> the entry's budgeted size in bytes, or
        None on a miss. No stats bump, no LRU reorder, no stale drop —
        for route decisions (e.g. the streaming producer picking the
        served-from-residency shape, sized against its frame cap) whose
        real lookup follows and does the counting."""
        with self._mu:
            ent = self._entries.get(key)
            if ent is None or not self._fresh(ent, data_version, read_ts):
                return None
            return ent[3]

    def entry_state(self, key):
        """(fill_version, fill_ts) of the resident entry, or None —
        freshness is NOT checked and no stats/LRU effects apply. The
        fleet read path (store/fleetcop.py) uses this to prime one
        journal-window RPC with the entry's own fill snapshot before
        deciding whether the block is patchable in place."""
        with self._mu:
            ent = self._entries.get(key)
            return None if ent is None else (ent[0], ent[1])

    def lookup(self, key, data_version: int, read_ts: int):
        """Like get() but returns (fill_ts, chunk): the entry's fill
        snapshot rides along so derived caches (the HBM device cache)
        can record the SAME validity window as the host entry."""
        with self._mu:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            if not self._fresh(ent, data_version, read_ts):
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ent[1], ent[2]

    def put(self, key, data_version: int, fill_ts: int, chunk) -> None:
        size = _chunk_bytes(chunk)
        if size > self.max_bytes:
            return
        with self._mu:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[3]
            self._entries[key] = (data_version, fill_ts, chunk, size)
            self._bytes += size
            while self._bytes > self.max_bytes and self._entries:
                _k, (_v, _t, _ch, sz) = self._entries.popitem(last=False)
                self._bytes -= sz

    def add_cost(self, key, extra: int) -> None:
        """Charge derived data (e.g. memoized filter results riding the
        cached chunk) to the entry's budget share."""
        with self._mu:
            ent = self._entries.get(key)
            if ent is None:
                return
            self._entries[key] = (ent[0], ent[1], ent[2], ent[3] + extra)
            self._bytes += extra
            while self._bytes > self.max_bytes and self._entries:
                _k, (_v, _t, _ch, sz) = self._entries.popitem(last=False)
                self._bytes -= sz

    def restamp(self, key, fill_ts: int, new_ts: int) -> bool:
        """Advance an entry's fill snapshot from `fill_ts` to `new_ts`
        (the delta merge, for a region no write touched in between);
        False when the entry is gone or was re-filled meanwhile."""
        with self._mu:
            ent = self._entries.get(key)
            if ent is None or ent[1] != fill_ts:
                return False
            self._entries[key] = (ent[0], new_ts, ent[2], ent[3])
            return True

    def drop(self, key, if_chunk=None) -> None:
        """Remove one entry (delta-staleness invalidation: an index
        scan whose table took index-key commits, or a base whose
        journal window was truncated under it). With `if_chunk`, drop
        only while the entry still holds that exact chunk — a reader
        invalidating a lagging base must not discard the fresher merged
        base a concurrent merge just promoted into the slot."""
        with self._mu:
            ent = self._entries.get(key)
            if ent is None or (if_chunk is not None and
                               ent[2] is not if_chunk):
                return
            self._entries.pop(key)
            self._bytes -= ent[3]

    def snapshot_table(self, table_id: int) -> list:
        """[(key, fill_version, fill_ts, chunk)] for every entry of one
        table — the delta store's merge walks this to fold staged
        deltas into new base blocks. Cache keys embed the table id at
        position 2 (see key())."""
        with self._mu:
            return [(k, ent[0], ent[1], ent[2])
                    for k, ent in self._entries.items()
                    if k[2] == table_id]

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._bytes = 0
