"""TxStructure: Redis-like typed structures on one KV transaction.

Reference: TiDB's structure/structure.go:49 (TxStructure),
string.go:24 (string ops), hash.go:46 (hash ops), list.go (list ops) —
the substrate the reference's meta/ package stores all schema metadata
on. Same shape here: every op reads/writes through the caller's
transaction, so structure mutations commit atomically with whatever
else the txn does (schema version bumps, DDL job state).

Key encoding under a namespace prefix (type tag keeps the three kinds
disjoint; `\\x00` separates key from field/index, so structure KEYS must
not contain NUL — metadata keys are ASCII):

    {prefix}s{key}                 string value
    {prefix}h{key}\\x00{field}      hash field value
    {prefix}l{key}                 list bounds json [left, right)
    {prefix}i{key}\\x00{index:020d} list item
"""

from __future__ import annotations

import json

from tidb_tpu_torch import kv

__all__ = ["TxStructure"]


class TxStructure:
    def __init__(self, txn: kv.Transaction, prefix: bytes = b"m"):
        self.txn = txn
        self.prefix = prefix

    # -- key codecs ----------------------------------------------------------

    def _skey(self, key: bytes) -> bytes:
        return self.prefix + b"s" + key

    def _hkey(self, key: bytes, field: bytes) -> bytes:
        return self.prefix + b"h" + key + b"\x00" + field

    def _hrange(self, key: bytes) -> tuple[bytes, bytes]:
        base = self.prefix + b"h" + key + b"\x00"
        return base, base[:-1] + b"\x01"

    def _lmeta_key(self, key: bytes) -> bytes:
        return self.prefix + b"l" + key

    def _ikey(self, key: bytes, index: int) -> bytes:
        return self.prefix + b"i" + key + b"\x00" + b"%020d" % index

    # -- strings (ref: structure/string.go) ----------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        self.txn.set(self._skey(key), value)

    def get(self, key: bytes) -> bytes | None:
        return self.txn.get(self._skey(key))

    def inc(self, key: bytes, step: int = 1) -> int:
        """Atomic within the txn (ref: string.go Inc)."""
        raw = self.get(key)
        cur = int(raw) if raw else 0
        cur += step
        self.set(key, b"%d" % cur)
        return cur

    def get_int(self, key: bytes) -> int:
        raw = self.get(key)
        return int(raw) if raw else 0

    def clear(self, key: bytes) -> None:
        self.txn.delete(self._skey(key))

    # -- hashes (ref: structure/hash.go) -------------------------------------

    def hset(self, key: bytes, field: bytes, value: bytes) -> None:
        self.txn.set(self._hkey(key, field), value)

    def hget(self, key: bytes, field: bytes) -> bytes | None:
        return self.txn.get(self._hkey(key, field))

    def hdel(self, key: bytes, field: bytes) -> None:
        self.txn.delete(self._hkey(key, field))

    def hlen(self, key: bytes) -> int:
        return len(self.hgetall(key))

    def hgetall(self, key: bytes) -> list[tuple[bytes, bytes]]:
        """[(field, value)] in field byte order (ref: hash.go HGetAll)."""
        lo, hi = self._hrange(key)
        out = []
        for k, v in self.txn.iter_range(lo, hi):
            out.append((k[len(lo):], v))
        return out

    def hscan_prefix(self, key: bytes,
                     field_prefix: bytes) -> list[tuple[bytes, bytes]]:
        """Fields starting with field_prefix, in order."""
        return [(f, v) for f, v in self.hgetall(key)
                if f.startswith(field_prefix)]

    def hclear(self, key: bytes) -> None:
        lo, hi = self._hrange(key)
        for k, _v in list(self.txn.iter_range(lo, hi)):
            self.txn.delete(k)

    # -- lists (ref: structure/list.go) --------------------------------------

    def _bounds(self, key: bytes) -> tuple[int, int]:
        raw = self.txn.get(self._lmeta_key(key))
        if not raw:
            return 0, 0
        left, right = json.loads(raw)
        return int(left), int(right)

    def _set_bounds(self, key: bytes, left: int, right: int) -> None:
        if left == right:
            self.txn.delete(self._lmeta_key(key))
        else:
            self.txn.set(self._lmeta_key(key),
                         json.dumps([left, right]).encode())

    def rpush(self, key: bytes, *values: bytes) -> None:
        left, right = self._bounds(key)
        for v in values:
            self.txn.set(self._ikey(key, right), v)
            right += 1
        self._set_bounds(key, left, right)

    def lpush(self, key: bytes, *values: bytes) -> None:
        left, right = self._bounds(key)
        for v in values:
            left -= 1
            self.txn.set(self._ikey(key, left), v)
        self._set_bounds(key, left, right)

    def llen(self, key: bytes) -> int:
        left, right = self._bounds(key)
        return right - left

    def lindex(self, key: bytes, index: int) -> bytes | None:
        left, right = self._bounds(key)
        pos = (left + index) if index >= 0 else (right + index)
        if not (left <= pos < right):
            return None
        return self.txn.get(self._ikey(key, pos))

    def lset(self, key: bytes, index: int, value: bytes) -> None:
        left, right = self._bounds(key)
        pos = (left + index) if index >= 0 else (right + index)
        if not (left <= pos < right):
            raise IndexError("list index out of range")
        self.txn.set(self._ikey(key, pos), value)

    def lpop(self, key: bytes) -> bytes | None:
        left, right = self._bounds(key)
        if left == right:
            return None
        v = self.txn.get(self._ikey(key, left))
        self.txn.delete(self._ikey(key, left))
        self._set_bounds(key, left + 1, right)
        return v

    def rpop(self, key: bytes) -> bytes | None:
        left, right = self._bounds(key)
        if left == right:
            return None
        v = self.txn.get(self._ikey(key, right - 1))
        self.txn.delete(self._ikey(key, right - 1))
        self._set_bounds(key, left, right - 1)
        return v

    def lrem_at(self, key: bytes, index: int) -> None:
        """Remove one item by position, shifting later items left (queues
        here are short — the DDL job list; ref keeps the same O(n))."""
        left, right = self._bounds(key)
        pos = (left + index) if index >= 0 else (right + index)
        if not (left <= pos < right):
            raise IndexError("list index out of range")
        for p in range(pos, right - 1):
            nxt = self.txn.get(self._ikey(key, p + 1))
            self.txn.set(self._ikey(key, p), nxt)
        self.txn.delete(self._ikey(key, right - 1))
        self._set_bounds(key, left, right - 1)

    def litems(self, key: bytes) -> list[bytes]:
        left, right = self._bounds(key)
        return [self.txn.get(self._ikey(key, p))
                for p in range(left, right)]

    def lclear(self, key: bytes) -> None:
        left, right = self._bounds(key)
        for p in range(left, right):
            self.txn.delete(self._ikey(key, p))
        self.txn.delete(self._lmeta_key(key))
