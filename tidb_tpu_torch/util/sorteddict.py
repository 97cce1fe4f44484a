"""SortedDict: prefer the real `sortedcontainers`, else a bisect shim.

The storage stack (MVCC engine, cluster topology, region cache, memdb)
keys everything on sorted byte strings. The container image does not
always ship `sortedcontainers` (and nothing may be pip-installed), so
this module provides the subset the repo uses as a pure-stdlib fallback:
a dict paired with a bisect-maintained key list. Insert/delete are
O(n) memmove (fine at mock-store scale — the hot analytical path reads
through `irange`, which is O(log n) + slice); iteration orders are
identical to the real library for every operation used here.

`irange` snapshots the key range before yielding (the real library
iterates the live tree): every repo call site holds the owning lock for
the full iteration, so the semantics difference is unobservable, and a
snapshot can never corrupt mid-iteration.
"""

from __future__ import annotations

import bisect

__all__ = ["SortedDict"]

try:                                        # pragma: no cover
    from sortedcontainers import SortedDict  # type: ignore  # noqa: F401
except ImportError:

    class _KeysView:
        """Live, indexable, ordered key view (sortedcontainers shape)."""

        __slots__ = ("_keys",)

        def __init__(self, keys: list):
            self._keys = keys

        def __len__(self) -> int:
            return len(self._keys)

        def __getitem__(self, i):
            return self._keys[i]

        def __iter__(self):
            return iter(self._keys)

        def __contains__(self, k) -> bool:
            i = bisect.bisect_left(self._keys, k)
            return i < len(self._keys) and self._keys[i] == k

    class _ValuesView:
        __slots__ = ("_sd",)

        def __init__(self, sd: "SortedDict"):
            self._sd = sd

        def __len__(self) -> int:
            return len(self._sd._keys)

        def __getitem__(self, i):
            return self._sd._map[self._sd._keys[i]]

        def __iter__(self):
            m = self._sd._map
            return (m[k] for k in self._sd._keys)

    class _ItemsView:
        __slots__ = ("_sd",)

        def __init__(self, sd: "SortedDict"):
            self._sd = sd

        def __len__(self) -> int:
            return len(self._sd._keys)

        def __getitem__(self, i):
            k = self._sd._keys[i]
            return (k, self._sd._map[k])

        def __iter__(self):
            m = self._sd._map
            return ((k, m[k]) for k in self._sd._keys)

    class SortedDict:                        # type: ignore[no-redef]
        __slots__ = ("_map", "_keys")

        def __init__(self, *args, **kwargs):
            self._map: dict = {}
            self._keys: list = []
            if args or kwargs:
                self.update(*args, **kwargs)

        # -- core mapping protocol ----------------------------------------

        def __setitem__(self, key, value) -> None:
            if key not in self._map:
                bisect.insort(self._keys, key)
            self._map[key] = value

        def __getitem__(self, key):
            return self._map[key]

        def __delitem__(self, key) -> None:
            del self._map[key]          # raises KeyError before key-list edit
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]

        def __contains__(self, key) -> bool:
            return key in self._map

        def __len__(self) -> int:
            return len(self._map)

        def __iter__(self):
            return iter(self._keys)

        def __repr__(self) -> str:
            return f"SortedDict({dict(self.items())!r})"

        def __eq__(self, other) -> bool:
            if isinstance(other, SortedDict):
                return self._map == other._map
            return self._map == other

        # -- dict surface -------------------------------------------------

        def get(self, key, default=None):
            return self._map.get(key, default)

        def pop(self, key, *default):
            if key in self._map or not default:
                v = self._map.pop(key)
                i = bisect.bisect_left(self._keys, key)
                del self._keys[i]
                return v
            return default[0]

        def setdefault(self, key, default=None):
            if key not in self._map:
                self[key] = default
            return self._map[key]

        def update(self, *args, **kwargs) -> None:
            # bulk path: merge then re-sort wholesale (cheaper than n
            # insorts for large ingests — the mvcc bulk_import shape)
            staged = dict(*args, **kwargs) if args or kwargs else {}
            fresh = [k for k in staged if k not in self._map]
            self._map.update(staged)
            if fresh:
                self._keys.extend(fresh)
                self._keys.sort()

        def clear(self) -> None:
            self._map.clear()
            self._keys.clear()

        def copy(self) -> "SortedDict":
            out = SortedDict()
            out._map = dict(self._map)
            out._keys = list(self._keys)
            return out

        def keys(self) -> "_KeysView":
            return _KeysView(self._keys)

        def values(self) -> "_ValuesView":
            return _ValuesView(self)

        def items(self) -> "_ItemsView":
            return _ItemsView(self)

        # -- sorted surface -----------------------------------------------

        def bisect_left(self, key) -> int:
            return bisect.bisect_left(self._keys, key)

        def bisect_right(self, key) -> int:
            return bisect.bisect_right(self._keys, key)

        def peekitem(self, index: int = -1):
            k = self._keys[index]
            return (k, self._map[k])

        def irange(self, minimum=None, maximum=None,
                   inclusive=(True, True), reverse=False):
            """Iterate keys in [minimum, maximum] honoring `inclusive`
            bounds, optionally reversed. None bounds are open."""
            if minimum is None:
                lo = 0
            elif inclusive[0]:
                lo = bisect.bisect_left(self._keys, minimum)
            else:
                lo = bisect.bisect_right(self._keys, minimum)
            if maximum is None:
                hi = len(self._keys)
            elif inclusive[1]:
                hi = bisect.bisect_right(self._keys, maximum)
            else:
                hi = bisect.bisect_left(self._keys, maximum)
            span = self._keys[lo:hi]
            if reverse:
                span.reverse()
            return iter(span)

        # -- pickling (on-disk snapshots, store/snapshot.py) ---------------

        def __reduce__(self):
            return (SortedDict, (self._map,))
