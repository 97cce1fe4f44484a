"""Mock cluster topology: stores, regions, split/merge, leader moves.

Reference: TiDB's store/tikv/mocktikv/cluster.go:38,231-308 —
`Cluster` simulates region topology with Bootstrap/AddStore/Split so
distributed client behavior (routing, epoch retries, fan-out) is testable
on one host. Also plays the PD role: region lookup by key + TSO allocation
(ref: mocktikv/pd.go).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace

from tidb_tpu_torch.util.sorteddict import SortedDict

from tidb_tpu_torch import tablecodec

__all__ = ["Region", "Store", "Cluster"]


@dataclass(frozen=True)
class Region:
    id: int
    start: bytes          # inclusive; b"" = -inf
    end: bytes            # exclusive; b"" = +inf
    version: int          # bumped on split/merge (region epoch)
    conf_ver: int         # bumped on peer changes
    leader_store: int
    peer_stores: tuple[int, ...]

    def contains(self, key: bytes) -> bool:
        return self.start <= key and (not self.end or key < self.end)


@dataclass
class Store:
    id: int
    addr: str
    labels: dict = field(default_factory=dict)
    dropped: bool = False


class Cluster:
    """Topology + TSO. Thread-safe."""

    def __init__(self):
        self._mu = threading.RLock()
        self._id = 0
        self.stores: dict[int, Store] = {}
        # regions keyed by start key for binary search routing
        self._regions: SortedDict[bytes, Region] = SortedDict()
        self._tso_physical = 0
        self._tso_logical = 0

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("_mu", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._mu = threading.RLock()

    # -- ids / tso -----------------------------------------------------------

    def alloc_id(self) -> int:
        with self._mu:
            self._id += 1
            return self._id

    def tso(self) -> int:
        """Hybrid timestamp: physical ms << 18 | logical.
        Ref: oracle/oracles/pd.go; mocktikv/pd.go GetTS."""
        with self._mu:
            ms = int(time.time() * 1000)
            if ms > self._tso_physical:
                self._tso_physical = ms
                self._tso_logical = 0
            self._tso_logical += 1
            return (self._tso_physical << 18) | self._tso_logical

    # -- bootstrap / topology ------------------------------------------------

    def bootstrap(self, num_stores: int = 1) -> None:
        with self._mu:
            for _ in range(num_stores):
                sid = self.alloc_id()
                self.stores[sid] = Store(sid, f"store{sid}")
            store_ids = tuple(self.stores)
            rid = self.alloc_id()
            self._regions[b""] = Region(rid, b"", b"", 1, 1,
                                        store_ids[0], store_ids)

    def add_store(self) -> int:
        with self._mu:
            sid = self.alloc_id()
            self.stores[sid] = Store(sid, f"store{sid}")
            return sid

    # -- routing (the PD role) ----------------------------------------------

    def region_by_key(self, key: bytes) -> Region:
        with self._mu:
            idx = self._regions.bisect_right(key) - 1
            start = self._regions.keys()[idx]
            return self._regions[start]

    def region_by_id(self, rid: int) -> Region | None:
        with self._mu:
            for r in self._regions.values():
                if r.id == rid:
                    return r
            return None

    def all_regions(self) -> list[Region]:
        with self._mu:
            return list(self._regions.values())

    # -- mutation ------------------------------------------------------------

    def split(self, key: bytes) -> tuple[Region, Region]:
        """Split the region containing `key` at `key`; bumps epoch of both
        halves. Ref: cluster.go Split."""
        with self._mu:
            old = self.region_by_key(key)
            if old.start == key:
                raise ValueError("split at region start")
            left = replace(old, end=key, version=old.version + 1)
            right = Region(self.alloc_id(), key, old.end, old.version + 1,
                           old.conf_ver, old.leader_store, old.peer_stores)
            self._regions[old.start] = left
            self._regions[key] = right
            return left, right

    def split_table(self, table_id: int, count: int,
                    max_handle: int = 1 << 20) -> int:
        """Split a table's record range into `count` regions at evenly spaced
        handles in [0, max_handle); boundaries that already exist are
        skipped, so a re-run is a no-op. -> number of new splits.
        Ref: cluster.go SplitTable."""
        if count <= 1:
            return 0
        span = max(max_handle // count, 1)
        done = 0
        for i in range(1, count):
            try:
                self.split(tablecodec.record_key(table_id, span * i))
                done += 1
            except ValueError:       # already a region boundary
                pass
        return done

    def split_keys(self, keys: list[bytes]) -> None:
        for k in keys:
            self.split(k)

    def merge(self, left_start: bytes) -> None:
        """Merge the region starting at left_start with its right neighbor."""
        with self._mu:
            left = self._regions[left_start]
            if not left.end:
                raise ValueError("no right neighbor")
            right = self._regions[left.end]
            merged = replace(left, end=right.end,
                             version=max(left.version, right.version) + 1)
            del self._regions[left.end]
            self._regions[left_start] = merged

    def change_leader(self, region_id: int, store_id: int) -> None:
        """Leadership is NOT part of the region epoch (TiKV semantics):
        a transfer changes no version, clients just follow NotLeader."""
        with self._mu:
            for start, r in self._regions.items():
                if r.id == region_id:
                    peers, bump = r.peer_stores, r.conf_ver
                    if store_id not in peers:
                        peers = peers + (store_id,)
                        bump += 1    # peer membership change IS epoch
                    self._regions[start] = replace(
                        r, leader_store=store_id, peer_stores=peers,
                        conf_ver=bump)
                    return
            raise ValueError(f"no region {region_id}")

    # -- replica/partition management (the PD role; ref: region_request.go
    # store failover client-side, PD balance schedulers server-side) ---------

    def live_stores(self) -> list[int]:
        with self._mu:
            return [sid for sid, s in self.stores.items() if not s.dropped]

    def store_is_up(self, store_id: int) -> bool:
        with self._mu:
            s = self.stores.get(store_id)
            return s is not None and not s.dropped

    def drop_store(self, store_id: int) -> None:
        """Take a store down: every region it led elects a surviving
        peer, and under-replicated regions get a replacement replica on
        a live store (conf change -> conf_ver bump, exactly what a peer
        membership change means)."""
        with self._mu:
            st = self.stores.get(store_id)
            if st is None:
                raise ValueError(f"no store {store_id}")
            st.dropped = True
            live = [sid for sid, s in self.stores.items() if not s.dropped]
            if not live:
                return               # total outage: nothing to elect
            for start, r in list(self._regions.items()):
                if store_id not in r.peer_stores and \
                        r.leader_store != store_id:
                    continue
                peers = tuple(p for p in r.peer_stores if p != store_id)
                spare = [sid for sid in live if sid not in peers]
                if len(peers) < len(r.peer_stores) and spare:
                    peers = peers + (spare[0],)   # repair replication
                leader = r.leader_store
                if leader == store_id or leader not in peers:
                    leader = peers[0]
                self._regions[start] = replace(
                    r, leader_store=leader, peer_stores=peers,
                    conf_ver=r.conf_ver + 1)

    def leader_counts(self) -> dict[int, int]:
        with self._mu:
            out = {sid: 0 for sid, s in self.stores.items()
                   if not s.dropped}
            for r in self._regions.values():
                if r.leader_store in out:
                    out[r.leader_store] += 1
            return out

    def balance_leaders(self) -> int:
        """One PD balance-leader pass: move leaders from overloaded to
        underloaded live stores, leadership-only (transfers stay within
        each region's existing peer set — membership changes are
        drop_store's job, as in PD's balance-leader scheduler). Best
        effort: converges to a spread of <=1 wherever peer sets allow,
        and stops when no permitted transfer improves the balance.
        -> number of transfers."""
        moved = 0
        while True:
            with self._mu:
                counts = self.leader_counts()
                if len(counts) < 2 or \
                        max(counts.values()) - min(counts.values()) <= 1:
                    return moved
                by_load = sorted(counts, key=counts.get)
                done = False
                for hi in reversed(by_load):
                    for lo in by_load:
                        if counts[hi] - counts[lo] <= 1:
                            break
                        for start, r in self._regions.items():
                            if r.leader_store == hi and \
                                    lo in r.peer_stores:
                                self._regions[start] = replace(
                                    r, leader_store=lo)
                                done = True
                                break
                        if done:
                            break
                    if done:
                        break
                if not done:
                    return moved     # no permitted transfer remains
            moved += 1
