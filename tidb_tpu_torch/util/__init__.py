"""Small shared utilities: the sorted map, the failpoint registry, the
worker supervisor and the plan cache's LRU (ref: TiDB's util/)."""

from __future__ import annotations

import threading
from collections import OrderedDict

__all__ = ["LRUCache"]


class LRUCache:
    """Thread-safe LRU (ref: util/kvcache sharded LRU — one shard is
    plenty in-process; the lock is uncontended off the hot path)."""

    def __init__(self, capacity: int = 100):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self._mu = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._mu:
            v = self._d.get(key)
            if v is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key, value) -> None:
        with self._mu:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._mu:
            self._d.clear()

    def __len__(self):
        return len(self._d)
