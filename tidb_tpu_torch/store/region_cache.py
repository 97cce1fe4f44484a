"""Client-side region cache: key -> region routing with invalidation.

Reference: TiDB's store/tikv/region_cache.go:49,137,200,326 —
sorted-key lookup, miss -> PD load, invalidation on region errors, leader
switch on NotLeader, GroupKeysByRegion for 2PC batching.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from tidb_tpu_torch.util.sorteddict import SortedDict

from tidb_tpu_torch.kv import KVRange, NotLeaderError
from tidb_tpu_torch.mockstore.cluster import Cluster, Region
from tidb_tpu_torch.mockstore.rpc import RegionCtx

__all__ = ["RegionCache", "KeyLocation"]


@dataclass
class KeyLocation:
    region: Region
    ctx: RegionCtx


class RegionCache:
    """Caches Region objects; the Cluster plays PD for cache misses.

    Insertion evicts STALE OVERLAPS (after a split, the old wide region
    overlaps both halves; ref: region_cache.go:326 insertRegionToCache
    dropping intersecting items) and is epoch-aware: an older
    (version, conf_ver) never replaces a newer cached epoch. An
    id -> start index keeps invalidation O(log n) under churn with
    thousands of regions."""

    def __init__(self, pd: Cluster):
        self.pd = pd
        self._mu = threading.RLock()
        self._by_start: SortedDict[bytes, Region] = \
            SortedDict()                     # guarded-by: _mu
        self._start_by_id: dict[int, bytes] = {}   # guarded-by: _mu
        # region_id -> learned leader store
        self._leaders: dict[int, int] = {}         # guarded-by: _mu

    def _ctx(self, r: Region) -> RegionCtx:
        leader = self._leaders.get(r.id, r.leader_store)
        return RegionCtx(r.id, r.version, r.conf_ver, leader)

    def _insert(self, r: Region) -> None:
        """Called under _mu. Evict every cached region intersecting
        [r.start, r.end) unless it carries a NEWER epoch (in which case
        the incoming region is the stale one and is dropped)."""
        # walk left to the first region that could overlap, then right
        idx = max(self._by_start.bisect_right(r.start) - 1, 0)
        keys = self._by_start.keys()
        stale = []
        i = idx
        while i < len(keys):
            cur = self._by_start[keys[i]]
            if r.end and cur.start >= r.end:
                break
            overlaps = (not cur.end or cur.end > r.start) and \
                (not r.end or cur.start < r.end)
            if overlaps:
                if (cur.version, cur.conf_ver) > (r.version, r.conf_ver):
                    return          # incoming region is older news
                if cur.id != r.id or cur.start != r.start:
                    stale.append(cur)
            i += 1
        for cur in stale:
            del self._by_start[cur.start]
            self._start_by_id.pop(cur.id, None)
            self._leaders.pop(cur.id, None)
        old_start = self._start_by_id.get(r.id)
        if old_start is not None and old_start != r.start and \
                old_start in self._by_start and \
                self._by_start[old_start].id == r.id:
            del self._by_start[old_start]
        self._by_start[r.start] = r
        self._start_by_id[r.id] = r.start

    def locate(self, key: bytes) -> KeyLocation:
        with self._mu:
            idx = self._by_start.bisect_right(key) - 1
            if idx >= 0:
                r = self._by_start.values()[idx]
                if r.contains(key):
                    return KeyLocation(r, self._ctx(r))
            r = self.pd.region_by_key(key)  # "PD RPC"
            self._insert(r)
            return KeyLocation(r, self._ctx(r))

    def invalidate(self, region_id: int) -> None:
        with self._mu:
            start = self._start_by_id.pop(region_id, None)
            if start is not None and start in self._by_start and \
                    self._by_start[start].id == region_id:
                del self._by_start[start]
            self._leaders.pop(region_id, None)

    def invalidate_range(self, start: bytes, end: bytes) -> None:
        """Drop every cached region intersecting [start, end): a split
        inside the range (SPLIT TABLE) made their epochs stale, so the
        next request re-resolves the range's regions (ref: TiDB's split
        updates the region cache; the JAX package's keeps the old region
        until a request's epoch error)."""
        with self._mu:
            stale = [r for r in self._by_start.values()
                     if (not r.end or r.end > start) and
                     (not end or r.start < end)]
        for r in stale:
            self.invalidate(r.id)

    def invalidate_all(self) -> None:
        """Drop every cached epoch and learned leader. Fired when a
        store-plane connection is lost (store/remote.py disconnect
        listener): the plane we reconnect to may have split/moved
        regions while we were gone, and resuming with stale epochs
        loops on ER_REGION_STREAM_INTERRUPTED instead of re-resolving."""
        with self._mu:
            self._by_start.clear()
            self._start_by_id.clear()
            self._leaders.clear()

    def on_not_leader(self, err: NotLeaderError) -> None:
        """Switch leader in place when the error names one, else invalidate.
        Ref: region_cache.go UpdateLeader."""
        with self._mu:
            if err.leader_store is not None:
                self._leaders[err.region_id] = err.leader_store
            else:
                self.invalidate(err.region_id)

    def group_keys_by_region(self, keys: list[bytes]) -> dict[int, tuple[KeyLocation, list[bytes]]]:
        """Ref: region_cache.go:200 GroupKeysByRegion."""
        groups: dict[int, tuple[KeyLocation, list[bytes]]] = {}
        for k in sorted(keys):
            loc = self.locate(k)
            if loc.region.id not in groups:
                groups[loc.region.id] = (loc, [])
            groups[loc.region.id][1].append(k)
        return groups

    def split_ranges_by_region(self, ranges: list[KVRange]
                               ) -> list[tuple[KeyLocation, KVRange]]:
        """Split [start, end) ranges along region boundaries, in key order.
        Ref: store/tikv/coprocessor.go:263 buildCopTasks."""
        out = []
        for rg in ranges:
            cur = rg.start
            while True:
                loc = self.locate(cur)
                r_end = loc.region.end
                if r_end and (not rg.end or r_end < rg.end):
                    out.append((loc, KVRange(cur, r_end)))
                    cur = r_end
                else:
                    out.append((loc, KVRange(cur, rg.end)))
                    break
        return out
