"""In-process MVCC store with Percolator transaction primitives.

Reference: TiDB's store/tikv/mocktikv/mvcc.go:418-429 (MVCCStore
iface: Get/Scan/BatchGet/Prewrite/Commit/Rollback/Cleanup/ScanLock/
ResolveLock) and mvcc_leveldb.go (the engine). This is the spec for what a
real storage node must do; here it is one python object guarded by a lock,
so a mock cluster can host many "regions" over one engine hermetically
(SURVEY.md §4: the single highest-leverage test artifact).

Per key, state is:
    lock:   at most one {primary, start_ts, ttl, op, value}
    writes: newest-first list of (commit_ts, start_ts, WriteType)
    data:   {start_ts: value} for committed Puts
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from tidb_tpu_torch.util.sorteddict import SortedDict

from tidb_tpu_torch.kv import (IsolationLevel, KeyLockedError, KVError, LockInfo,
                               Mutation, MutationOp, TxnAbortedError,
                               WriteConflictError)

__all__ = ["MVCCStore", "WriteType", "physical_ms",
           "EPHEMERAL_PREFIXES"]

# Ephemeral cluster-bookkeeping namespaces: DDL owner leases
# (owner.py DDL_OWNER_KEY), schema-sync heartbeats (session Domain
# SCHEMA_SYNC_PREFIX), fleet membership heartbeats (member.py
# MEMBER_PREFIX), and auto-increment batch allocations (meta
# AutoID counters — id handout changes no committed row and no schema,
# but every 4000th INSERT refills a batch through a meta txn). A live
# server's background workers commit the leases every half-lease
# (~1/s); none of these carry table data or schema semantics, so they
# must NOT bump data_version — one heartbeat (or id-batch refill)
# would otherwise invalidate every columnar chunk-cache and HBM-cache
# entry, keeping both caches permanently cold exactly when the server
# is serving. max_commit_ts and the lock set still advance/track for
# these keys, so the MVCC fill contract is untouched.
EPHEMERAL_PREFIXES = (b"m_owner_", b"m_schema_sync_", b"m_member_",
                      b"msAutoID:")


# key classes for the delta-capture path (store/delta.py): committed
# table RECORD mutations are journaled per table instead of bumping
# data_version; index-key commits advance a per-table index watermark
# (cached index scans re-validate against it); anything else — meta /
# DDL / structure keys — keeps the wholesale version bump, because a
# schema change really does invalidate every decoded chunk.
_KIND_RECORD, _KIND_INDEX, _KIND_EPHEMERAL, _KIND_OTHER = range(4)


def _classify_key(key: bytes) -> tuple[int, int, int]:
    """-> (kind, table_id, handle). table_id/handle are 0 unless
    meaningful for the kind."""
    if key.startswith(EPHEMERAL_PREFIXES):
        return _KIND_EPHEMERAL, 0, 0
    from tidb_tpu_torch import tablecodec
    try:
        tid, handle = tablecodec.decode_record_key(key)
        return _KIND_RECORD, tid, handle
    except ValueError:
        pass
    try:
        tid, _iid, _suffix = tablecodec.decode_index_key(key)
        return _KIND_INDEX, tid, 0
    except ValueError:
        return _KIND_OTHER, 0, 0


class WriteType(Enum):
    PUT = "put"
    DELETE = "delete"
    ROLLBACK = "rollback"
    LOCK = "lock"


@dataclass
class _Lock:
    primary: bytes
    start_ts: int
    ttl_ms: int
    op: MutationOp
    value: bytes

    def info(self, key: bytes) -> LockInfo:
        return LockInfo(self.primary, self.start_ts, key, self.ttl_ms)


@dataclass
class _Entry:
    lock: Optional[_Lock] = None
    writes: list = field(default_factory=list)   # [(commit_ts, start_ts, WriteType)] newest first
    data: dict = field(default_factory=dict)     # start_ts -> value


def physical_ms(ts: int) -> int:
    """Hybrid timestamp physical part. Ref: oracle/oracle.go:35
    (ts = physical_ms << 18 | logical)."""
    return ts >> 18


class MVCCStore:
    """Thread-safe Percolator MVCC engine over sorted keys."""

    def __init__(self):
        self._entries: SortedDict[bytes, _Entry] = SortedDict()
        self._mu = threading.RLock()
        # bumped on EVERY state change (locks included): the columnar
        # chunk cache (store/chunk_cache.py) keys its validity on it
        self.data_version = 0
        # newest commit_ts ever written: a scan snapshot at ts >= this sees
        # the full current state, so its decoded chunk is safe to cache
        # (an OLDER snapshot's scan must never populate the cache — newer
        # readers would inherit its stale view)
        self.max_commit_ts = 0
        # keys currently holding a Percolator lock: lock VISIBILITY is
        # per-reader-ts (a lock from a NEWER txn doesn't block an older
        # snapshot's scan), so a fill made while any lock is pending could
        # be served to a reader that must instead see KeyLockedError —
        # the chunk-cache filler refuses to cache while this is nonempty
        self._locked_keys: set = set()
        # delta capture (store/delta.py DeltaStore.ingest): installed by
        # the storage facade. While active, committed RECORD mutations
        # are journaled (under _mu, atomically with the commit becoming
        # readable) instead of bumping data_version — the caches then
        # serve base + delta instead of re-colding on every write.
        self._delta_sink = None

    # engines snapshot to disk for the out-of-process storage node's
    # restart path (store/remote.py); locks are recreated on load
    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("_mu", None)
        d.pop("_delta_sink", None)   # process-local, re-wired on load
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._mu = threading.RLock()
        self._delta_sink = None

    def set_delta_sink(self, sink) -> None:
        """Install the commit-journal sink (DeltaStore). `sink.ingest`
        is invoked under the engine lock so a commit and its journal
        entry become visible atomically; `sink.enabled()` is consulted
        per operation, so flipping tidb_tpu_delta_store reverts to the
        legacy whole-version invalidation instantly."""
        with self._mu:
            self._delta_sink = sink

    def _capture_active(self) -> bool:
        sink = self._delta_sink
        return sink is not None and sink.enabled()

    def _needs_bump(self, keys, capture: bool) -> bool:
        """Would a state change over `keys` invalidate cached chunks?
        Without delta capture: any non-ephemeral key (legacy). With it:
        only keys outside the record/index namespaces."""
        for k in keys:
            kind = _classify_key(k)[0]
            if kind == _KIND_EPHEMERAL:
                continue
            if capture and kind in (_KIND_RECORD, _KIND_INDEX):
                continue
            return True
        return False

    # -- internal ------------------------------------------------------------

    def _entry(self, key: bytes) -> _Entry:
        e = self._entries.get(key)
        if e is None:
            e = _Entry()
            self._entries[key] = e
        return e

    def _check_lock(self, key: bytes, e: _Entry, ts: int,
                    isolation: IsolationLevel) -> None:
        """A read at `ts` is blocked by a lock from an older txn (SI).
        RC reads skip locks. Ref: mvcc_leveldb.go getValue lock check."""
        if e.lock is not None and isolation == IsolationLevel.SI:
            if e.lock.start_ts <= ts and e.lock.op != MutationOp.LOCK:
                raise KeyLockedError(e.lock.info(key))

    def _read(self, key: bytes, e: _Entry, ts: int) -> Optional[bytes]:
        for commit_ts, start_ts, wt in e.writes:
            if commit_ts > ts:
                continue
            if wt == WriteType.PUT:
                return e.data[start_ts]
            if wt == WriteType.DELETE:
                return None
            # ROLLBACK/LOCK records: keep looking at older versions
        return None

    # -- reads ---------------------------------------------------------------

    def get(self, key: bytes, ts: int,
            isolation: IsolationLevel = IsolationLevel.SI) -> Optional[bytes]:
        with self._mu:
            e = self._entries.get(key)
            if e is None:
                return None
            self._check_lock(key, e, ts, isolation)
            return self._read(key, e, ts)

    def batch_get(self, keys: list[bytes], ts: int,
                  isolation: IsolationLevel = IsolationLevel.SI) -> dict[bytes, bytes]:
        out = {}
        with self._mu:
            for k in keys:
                e = self._entries.get(k)
                if e is None:
                    continue
                self._check_lock(k, e, ts, isolation)
                v = self._read(k, e, ts)
                if v is not None:
                    out[k] = v
        return out

    def locked_in_range(self, start: bytes, end: bytes, ts: int) -> bool:
        """Is any pending Percolator lock on a key in [start, end) one a
        reader at `ts` must observe (SI: lock.start_ts <= ts; LOCK-op
        locks never block reads)? The cached read path consults this
        instead of relying on prewrite bumping data_version: while such
        a lock is pending, the range falls to the real scan path (which
        raises KeyLockedError for resolution exactly as an uncached
        read would) and the cached entries SURVIVE the write instead of
        being wholesale-invalidated.

        Lock-free fast path: with no pending locks at all (the common
        serving state) this is one attribute read — no engine-lock
        serialization on the hot analytic path. A lock being ADDED
        concurrently is safe to miss: its prewrite has not returned, so
        its txn's eventual commit_ts is strictly newer than any read_ts
        issued before this check — invisible to this reader either
        way."""
        if not self._locked_keys:
            return False
        with self._mu:
            for k in self._locked_keys:
                if k < start or (end and k >= end):
                    continue
                e = self._entries.get(k)
                if e is not None and e.lock is not None and \
                        e.lock.start_ts <= ts and \
                        e.lock.op != MutationOp.LOCK:
                    return True
        return False

    def scan(self, start: bytes, end: bytes, limit: int, ts: int,
             isolation: IsolationLevel = IsolationLevel.SI,
             desc: bool = False) -> list[tuple[bytes, bytes]]:
        """First `limit` live (key, value) pairs in [start, end).
        end=b"" means unbounded."""
        out = []
        with self._mu:
            keys = self._entries.irange(start, end or None,
                                        inclusive=(True, False), reverse=desc)
            for k in keys:
                e = self._entries[k]
                self._check_lock(k, e, ts, isolation)
                v = self._read(k, e, ts)
                if v is not None:
                    out.append((k, v))
                    if limit and len(out) >= limit:
                        break
        return out

    # -- offline ingest ------------------------------------------------------

    def bulk_import(self, pairs, start_ts: int, commit_ts: int) -> int:
        """Offline ingest of pre-encoded (key, value) pairs as committed
        PUTs at `commit_ts`, bypassing the Percolator lock protocol — the
        importer owns the target range (ref: util/kvencoder's standalone
        KV-pair encoder for offline import, and TiKV's ingest-SST flow).
        Keys already present get a new newest version; readers at a ts
        below `commit_ts` keep seeing the old state. -> pairs ingested."""
        pairs = list(pairs)
        n = 0
        with self._mu:
            # validate-then-apply so the import is all-or-nothing: a lock
            # discovered midway must not leave earlier pairs committed
            for k, _v in pairs:
                e = self._entries.get(k)
                if e is not None and e.lock is not None:
                    raise KeyLockedError(e.lock.info(k))
            self.data_version += 1
            if commit_ts > self.max_commit_ts:
                self.max_commit_ts = commit_ts
            fresh = {}
            for k, v in pairs:
                e = self._entries.get(k)
                if e is None:
                    # fresh key: construct the whole entry in one go
                    # (the common bulk-load case; avoids _entry dict probe)
                    fresh[k] = _Entry(
                        lock=None,
                        writes=[(commit_ts, start_ts, WriteType.PUT)],
                        data={start_ts: v})
                else:
                    e.data[start_ts] = v
                    e.writes.insert(0, (commit_ts, start_ts, WriteType.PUT))
                n += 1
            if fresh:
                # one bulk update: SortedDict sorts the new keys wholesale
                # instead of per-item tree inserts
                self._entries.update(fresh)
        return n

    # -- percolator write protocol ------------------------------------------

    def prewrite(self, mutations: list[Mutation], primary: bytes,
                 start_ts: int, ttl_ms: int = 3000) -> None:
        """All-or-nothing lock acquisition. Ref: mvcc_leveldb.go Prewrite."""
        with self._mu:
            # with delta capture, record/index prewrites leave
            # data_version alone: pending-lock correctness moves to the
            # serve-time locked_in_range veto, so a write in flight no
            # longer re-colds every cache
            if self._needs_bump([m.key for m in mutations],
                                self._capture_active()):
                self.data_version += 1
            for m in mutations:
                e = self._entry(m.key)
                if e.lock is not None:
                    if e.lock.start_ts != start_ts:
                        raise KeyLockedError(e.lock.info(m.key))
                    continue  # idempotent re-prewrite by the same txn
                if self._find_txn_write(e, start_ts) == WriteType.ROLLBACK:
                    raise TxnAbortedError(f"txn {start_ts} already rolled back")
                # conflict: newest real write committed at/after our start_ts
                for commit_ts, _wts, wt in e.writes:
                    if wt == WriteType.ROLLBACK:
                        continue
                    if commit_ts >= start_ts:
                        raise WriteConflictError(m.key, start_ts, commit_ts)
                    break
            for m in mutations:
                e = self._entry(m.key)
                e.lock = _Lock(primary, start_ts, ttl_ms, m.op, m.value)
                self._locked_keys.add(m.key)

    def commit(self, keys: list[bytes], start_ts: int, commit_ts: int) -> None:
        """Ref: mvcc_leveldb.go Commit — idempotent for already-committed.

        With delta capture active, committed RECORD mutations are
        journaled to the sink (under the engine lock, so the journal
        entry and the readable commit appear atomically — a reader can
        never observe the commit but miss its delta) and index-key
        commits advance the per-table index watermark; data_version
        bumps only for keys outside both namespaces."""
        with self._mu:
            capture = self._capture_active()
            if self._needs_bump(keys, capture):
                self.data_version += 1
            records: list = []
            idx_notes: list = []
            try:
                for k in keys:
                    e = self._entries.get(k)
                    if e is None or e.lock is None or \
                            e.lock.start_ts != start_ts:
                        # lock gone: committed already, or rolled back?
                        st = self._find_txn_write(e, start_ts) if e else None
                        if st == WriteType.ROLLBACK or st is None:
                            raise TxnAbortedError(
                                f"commit of {start_ts} on {k!r}: lock missing")
                        continue  # already committed: idempotent
                    if capture:
                        self._journal(k, e.lock, commit_ts, records,
                                      idx_notes)
                    self._commit_locked(k, e, start_ts, commit_ts)
            finally:
                # even a TxnAbortedError mid-loop leaves the earlier
                # keys COMMITTED — their deltas must land regardless
                if (records or idx_notes) and \
                        not self._delta_sink.ingest(records, idx_notes):
                    # sink refused (disabled mid-flight): fall back to
                    # the legacy wholesale invalidation
                    self.data_version += 1

    @staticmethod
    def _journal(key: bytes, lock: _Lock, commit_ts: int,
                 records: list, idx_notes: list) -> None:
        """Classify one about-to-commit key into the delta journal:
        record PUT/DELETE -> (table, handle, key, value|None, ts);
        index PUT/DELETE -> per-table index watermark note."""
        if lock.op == MutationOp.LOCK:
            return
        kind, tid, handle = _classify_key(key)
        if kind == _KIND_RECORD:
            records.append((tid, handle, key,
                            lock.value if lock.op == MutationOp.PUT
                            else None, commit_ts))
        elif kind == _KIND_INDEX:
            idx_notes.append((tid, commit_ts))

    def _commit_locked(self, key: bytes, e: _Entry, start_ts: int,
                       commit_ts: int) -> None:
        if commit_ts > self.max_commit_ts:
            self.max_commit_ts = commit_ts
        lock = e.lock
        if lock.op == MutationOp.PUT:
            e.data[start_ts] = lock.value
            e.writes.insert(0, (commit_ts, start_ts, WriteType.PUT))
        elif lock.op == MutationOp.DELETE:
            e.writes.insert(0, (commit_ts, start_ts, WriteType.DELETE))
        else:
            e.writes.insert(0, (commit_ts, start_ts, WriteType.LOCK))
        e.lock = None
        self._locked_keys.discard(key)

    def _find_txn_write(self, e: Optional[_Entry], start_ts: int):
        if e is None:
            return None
        for commit_ts, wts, wt in e.writes:
            if wts == start_ts:
                return wt
        return None

    def rollback(self, keys: list[bytes], start_ts: int) -> None:
        """Ref: mvcc_leveldb.go Rollback; errors if already committed."""
        with self._mu:
            # a rollback changes no committed-visible data: with delta
            # capture, record/index rollbacks leave data_version alone
            # (the lock-set veto already lifted when the lock clears)
            if self._needs_bump(keys, self._capture_active()):
                self.data_version += 1
            for k in keys:
                e = self._entry(k)
                wt = self._find_txn_write(e, start_ts)
                if wt is not None and wt != WriteType.ROLLBACK:
                    raise KVError(f"txn {start_ts} already committed on {k!r}")
                if e.lock is not None and e.lock.start_ts == start_ts:
                    e.lock = None
                    self._locked_keys.discard(k)
                if wt is None:
                    # rollback record blocks a late prewrite from this txn
                    e.writes.insert(0, (start_ts, start_ts, WriteType.ROLLBACK))

    def cleanup(self, key: bytes, start_ts: int, current_ts: int = 0) -> int:
        """Resolve a single (possibly dead) txn's lock on `key`.
        Returns commit_ts if the txn turned out committed, else 0 after
        rolling back. Raises KeyLockedError if the lock is still alive.
        Ref: mvcc_leveldb.go Cleanup + lock_resolver.go getTxnStatus."""
        with self._mu:
            if self._needs_bump([key], self._capture_active()):
                self.data_version += 1
            e = self._entry(key)
            if e.lock is not None and e.lock.start_ts == start_ts:
                if current_ts and physical_ms(current_ts) < \
                        physical_ms(start_ts) + e.lock.ttl_ms:
                    raise KeyLockedError(e.lock.info(key))
                e.lock = None
                self._locked_keys.discard(key)
                e.writes.insert(0, (start_ts, start_ts, WriteType.ROLLBACK))
                return 0
            wt = self._find_txn_write(e, start_ts)
            if wt == WriteType.ROLLBACK or wt is None:
                if wt is None:
                    e.writes.insert(0, (start_ts, start_ts, WriteType.ROLLBACK))
                return 0
            for commit_ts, wts, w in e.writes:
                if wts == start_ts and w != WriteType.ROLLBACK:
                    return commit_ts
            return 0

    def scan_lock(self, start: bytes, end: bytes, max_ts: int) -> list[LockInfo]:
        out = []
        with self._mu:
            for k in self._entries.irange(start, end or None,
                                          inclusive=(True, False)):
                e = self._entries[k]
                if e.lock is not None and e.lock.start_ts <= max_ts:
                    out.append(e.lock.info(k))
        return out

    def resolve_lock(self, start: bytes, end: bytes, start_ts: int,
                     commit_ts: int) -> None:
        """Commit (commit_ts > 0) or roll back every lock of txn start_ts in
        range. Ref: mvcc_leveldb.go ResolveLock."""
        with self._mu:
            capture = self._capture_active()
            hit = []
            for k in list(self._entries.irange(start, end or None,
                                               inclusive=(True, False))):
                e = self._entries[k]
                if e.lock is not None and e.lock.start_ts == start_ts:
                    hit.append((k, e))
            if self._needs_bump([k for k, _e in hit], capture):
                self.data_version += 1
            records: list = []
            idx_notes: list = []
            for k, e in hit:
                if commit_ts > 0:
                    if capture:
                        self._journal(k, e.lock, commit_ts, records,
                                      idx_notes)
                    self._commit_locked(k, e, start_ts, commit_ts)
                else:
                    e.lock = None
                    self._locked_keys.discard(k)
                    e.writes.insert(0, (start_ts, start_ts, WriteType.ROLLBACK))
            if (records or idx_notes) and \
                    not self._delta_sink.ingest(records, idx_notes):
                self.data_version += 1

    # -- maintenance ---------------------------------------------------------

    def delete_range(self, start: bytes, end: bytes) -> None:
        with self._mu:
            self.data_version += 1
            for k in list(self._entries.irange(start, end or None,
                                               inclusive=(True, False))):
                self._locked_keys.discard(k)
                del self._entries[k]

    def gc(self, safepoint_ts: int, start: bytes = b"",
           end: bytes = b"") -> int:
        """Drop versions no snapshot >= safepoint can see, within
        [start, end) (b"" = unbounded). Returns #pruned.
        Ref: gcworker/gc_worker.go doGC."""
        pruned = 0
        with self._mu:
            self.data_version += 1
            for k in list(self._entries.irange(start, end or None,
                                               inclusive=(True, False))):
                e = self._entries[k]
                keep = []
                seen_visible = False
                for w in e.writes:
                    commit_ts, start_ts, wt = w
                    if commit_ts > safepoint_ts or not seen_visible:
                        keep.append(w)
                        if commit_ts <= safepoint_ts and wt in (
                                WriteType.PUT, WriteType.DELETE):
                            seen_visible = True
                    else:
                        if wt == WriteType.PUT:
                            e.data.pop(start_ts, None)
                        pruned += 1
                e.writes = keep
                if not e.writes and e.lock is None:
                    del self._entries[k]
        return pruned

    def num_keys(self) -> int:
        with self._mu:
            return len(self._entries)

    # -- raw (non-transactional) namespace -----------------------------------
    # Ref: store/tikv/rawkv.go — TiKV keeps raw keys in a separate column
    # family; here a separate sorted map, invisible to MVCC readers.

    @property
    def _rawmap(self):
        raw = self.__dict__.get("_raw")
        if raw is None:          # engines unpickled from older snapshots
            raw = self.__dict__["_raw"] = SortedDict()
        return raw

    def raw_get(self, key: bytes) -> Optional[bytes]:
        with self._mu:
            return self._rawmap.get(key)

    def raw_batch_get(self, keys: list[bytes]) -> dict:
        with self._mu:
            raw = self._rawmap
            return {k: raw[k] for k in keys if k in raw}

    def raw_put(self, key: bytes, value: bytes) -> None:
        with self._mu:
            self._rawmap[key] = value

    def raw_batch_put(self, pairs: list[tuple]) -> None:
        with self._mu:
            self._rawmap.update(dict(pairs))

    def raw_delete(self, key: bytes) -> None:
        with self._mu:
            self._rawmap.pop(key, None)

    def raw_scan(self, start: bytes, end: bytes,
                 limit: int) -> list[tuple]:
        with self._mu:
            raw = self._rawmap
            out = []
            for k in raw.irange(start, end or None,
                                inclusive=(True, False)):
                out.append((k, raw[k]))
                if len(out) >= limit:
                    break
            return out

    def raw_delete_range(self, start: bytes, end: bytes) -> None:
        with self._mu:
            raw = self._rawmap
            for k in list(raw.irange(start, end or None,
                                     inclusive=(True, False))):
                del raw[k]

    # -- MVCC forensics (ref: server/region_handler.go:73-91 MvccGetByKey /
    # MvccGetByStartTs; mocktikv rpc.go MvccGetByKey) -------------------------

    def mvcc_by_key(self, key: bytes) -> dict:
        """Every version of one key: pending lock + write column entries
        with their values."""
        with self._mu:
            e = self._entries.get(key)
            if e is None:
                return {"key": key, "lock": None, "writes": []}
            lock = None
            if e.lock is not None:
                lock = {"start_ts": e.lock.start_ts,
                        "primary": e.lock.primary,
                        "op": e.lock.op.name,
                        "ttl_ms": e.lock.ttl_ms}
            writes = [{"commit_ts": cts, "start_ts": sts, "type": wt.name,
                       "value": e.data.get(sts)}
                      for cts, sts, wt in e.writes]
            return {"key": key, "lock": lock, "writes": writes}

    def mvcc_by_start_ts(self, start_ts: int, start: bytes = b"",
                         end: bytes = b"", limit: int = 256) -> list:
        """Keys a transaction touched (committed writes, pending locks)."""
        with self._mu:
            out = []
            for k in self._entries.irange(start, end or None,
                                          inclusive=(True, False)):
                e = self._entries[k]
                hit = (e.lock is not None and
                       e.lock.start_ts == start_ts) or \
                    any(sts == start_ts for _cts, sts, _wt in e.writes)
                if hit:
                    out.append((k, self.mvcc_by_key(k)))
                    if len(out) >= limit:
                        break
            return out
