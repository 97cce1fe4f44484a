"""Engine-neutral transactional KV contract.

Reference: TiDB's kv/kv.go:75-254 — Retriever/Mutator/MemBuffer/
Transaction/Snapshot/Storage/Iterator interfaces, isolation levels, request
types, and the membuffer/unionstore overlay (kv/memdb_buffer.go,
kv/union_store.go). Error taxonomy mirrors store/tikv errors so retry
machinery upstack is engine-independent.
"""

from __future__ import annotations

import abc
import threading
from dataclasses import dataclass, field
from enum import Enum, IntEnum
from typing import Iterable, Iterator, Optional

from tidb_tpu_torch.util.sorteddict import SortedDict

__all__ = [
    "IsolationLevel", "Priority", "ReqType",
    "KVError", "KeyLockedError", "WriteConflictError", "TxnAbortedError",
    "RegionError", "NotFoundError", "RetryableError", "ServerBusyError",
    "EpochNotMatchError", "NotLeaderError", "StoreUnavailableError",
    "UndeterminedError", "StreamInterruptedError",
    "LockInfo", "Mutation", "MutationOp",
    "MemBuffer", "UnionStore", "Snapshot", "Transaction", "Storage",
    "KVRange", "CopRequest", "CopResponse", "Client",
    "TXN_ENTRY_SIZE_LIMIT", "TXN_TOTAL_SIZE_LIMIT",
]

# ref: kv/kv.go:65-72 size limits
TXN_ENTRY_SIZE_LIMIT = 6 * 1024 * 1024
TXN_TOTAL_SIZE_LIMIT = 100 * 1024 * 1024


class IsolationLevel(Enum):
    SI = "SI"   # snapshot isolation (default)
    RC = "RC"   # read committed: readers skip others' locks


class Priority(IntEnum):
    LOW = 0
    NORMAL = 1
    HIGH = 2


class ReqType(IntEnum):
    """Coprocessor request types. Ref: kv/kv.go:143-204 (Select/Index/DAG/
    Analyze)."""

    DAG = 103
    ANALYZE = 104


# ---------------------------------------------------------------------------
# Errors

class KVError(Exception):
    pass


class NotFoundError(KVError):
    pass


class RetryableError(KVError):
    """Base for errors the client may retry after backoff."""


class GCTooEarlyError(KVError):
    """Read snapshot is older than the GC safepoint (ref: safepoint.go;
    ErrGCTooEarly) — its MVCC versions may already be pruned."""


class SchemaChangedError(RetryableError):
    """The schema a txn planned against changed before its commit ts
    (ref: domain/schema_validator.go:35 + 2pc.go:653 checkSchemaValid).
    Retryable: the session replays the statement history against the
    fresh schema."""


@dataclass
class LockInfo:
    primary: bytes
    start_ts: int
    key: bytes
    ttl_ms: int = 3000


class KeyLockedError(RetryableError):
    def __init__(self, lock: LockInfo):
        super().__init__(f"key locked by txn {lock.start_ts}")
        self.lock = lock

    def __reduce__(self):
        # errors with non-message ctor args must rebuild from them (they
        # cross the storage-process RPC boundary, store/remote.py)
        return (KeyLockedError, (self.lock,))


class WriteConflictError(RetryableError):
    def __init__(self, key: bytes, start_ts: int, conflict_ts: int):
        super().__init__(f"write conflict on {key!r}: txn {start_ts} vs commit {conflict_ts}")
        self.key = key
        self.start_ts = start_ts
        self.conflict_ts = conflict_ts

    def __reduce__(self):
        return (WriteConflictError,
                (self.key, self.start_ts, self.conflict_ts))


class TxnAbortedError(KVError):
    """Txn was rolled back (e.g. by a lock resolver); commit must fail."""


class UndeterminedError(KVError):
    """Commit outcome unknown (network error on primary commit).
    Ref: store/tikv/2pc.go:421-431."""


class RegionError(RetryableError):
    """Base for region routing errors; client refreshes its region cache."""


class NotLeaderError(RegionError):
    def __init__(self, region_id: int, leader_store: int | None = None):
        super().__init__(f"region {region_id}: not leader")
        self.region_id = region_id
        self.leader_store = leader_store

    def __reduce__(self):
        return (NotLeaderError, (self.region_id, self.leader_store))


class EpochNotMatchError(RegionError):
    def __init__(self, region_id: int):
        super().__init__(f"region {region_id}: epoch not match")
        self.region_id = region_id

    def __reduce__(self):
        return (EpochNotMatchError, (self.region_id,))


class StoreUnavailableError(RegionError):
    """The targeted store is down (connection refused / dropped peer).
    A RegionError so clients invalidate + re-route exactly like the
    reference's store failover (region_request.go onSendFail)."""

    def __init__(self, region_id: int, store_id: int):
        super().__init__(f"region {region_id}: store {store_id} down")
        self.region_id = region_id
        self.store_id = store_id

    def __reduce__(self):
        return (StoreUnavailableError, (self.region_id, self.store_id))


class ServerBusyError(RetryableError):
    pass


class StreamInterruptedError(RetryableError):
    """A streamed coprocessor reply died mid-region (network drop,
    server restart, failpoint). Retryable: the client re-issues the
    stream from the last acked range boundary (store/copr.py), so no
    row is duplicated or lost. Ref: the stream-recreate path of
    copIteratorWorker.handleCopStreamResult, store/tikv/coprocessor.go."""


# ---------------------------------------------------------------------------
# Mutations

class MutationOp(Enum):
    PUT = "put"
    DELETE = "delete"
    LOCK = "lock"  # prewrite-only existence lock (PresumeKeyNotExists checks)


@dataclass
class Mutation:
    op: MutationOp
    key: bytes
    value: bytes = b""


# ---------------------------------------------------------------------------
# MemBuffer / UnionStore (txn-local write overlay)

_TOMBSTONE = object()


class MemBuffer:
    """Sorted txn-local write buffer. Ref: kv/memdb_buffer.go (red-black
    tree); here a SortedDict. Deletions are tombstones so they shadow the
    snapshot through the union overlay."""

    def __init__(self):
        self._d = SortedDict()
        self.size = 0

    def set(self, key: bytes, value: bytes) -> None:
        if len(value) > TXN_ENTRY_SIZE_LIMIT:
            raise KVError("entry too large")
        old = self._d.get(key)
        self._d[key] = value
        self.size += len(key) + len(value) - (len(old) if isinstance(old, bytes) else 0)
        if self.size > TXN_TOTAL_SIZE_LIMIT:
            raise KVError("transaction too large")

    def delete(self, key: bytes) -> None:
        self._d[key] = _TOMBSTONE

    def get(self, key: bytes):
        """-> value bytes, _TOMBSTONE, or None if absent."""
        return self._d.get(key)

    def __len__(self):
        return len(self._d)

    def iter_range(self, start: bytes | None, end: bytes | None):
        """Yields (key, value_or_tombstone) in [start, end) order, over
        the keys the range held when the iteration began: a DML statement
        writes into this buffer while its union scan is still iterating
        it (the JAX package's copy iterates the live tree, which
        `sortedcontainers` may split under the iterator)."""
        keys = list(self._d.irange(start, end, inclusive=(True, False)))
        for k in keys:
            yield k, self._d[k]

    def any_in_range(self, start: bytes, end: bytes) -> bool:
        """Does the buffer hold a key in [start, end)? (A bisect: the
        union scan asks this of every statement of a transaction.)"""
        i = self._d.bisect_left(start)
        keys = self._d.keys()
        return i < len(keys) and keys[i] < end

    def items(self):
        return self.iter_range(None, None)


class Snapshot(abc.ABC):
    """Point-in-time read view. Ref: kv/kv.go Snapshot."""

    @abc.abstractmethod
    def get(self, key: bytes) -> Optional[bytes]: ...

    @abc.abstractmethod
    def batch_get(self, keys: list[bytes]) -> dict[bytes, bytes]: ...

    @abc.abstractmethod
    def iter_range(self, start: bytes | None, end: bytes | None,
                   ) -> Iterator[tuple[bytes, bytes]]: ...


class UnionStore:
    """MemBuffer overlaid on a Snapshot (ref: kv/union_store.go +
    kv/union_iter.go merge iterator)."""

    def __init__(self, snapshot: Snapshot):
        self.membuf = MemBuffer()
        self.snapshot = snapshot
        # keys registered with presume-not-exists for lazy dup-key checks
        # (ref: kv/kv.go PresumeKeyNotExists option)
        self.presumed_not_exists: set[bytes] = set()

    def get(self, key: bytes) -> Optional[bytes]:
        v = self.membuf.get(key)
        if v is _TOMBSTONE:
            return None
        if v is not None:
            return v
        if key in self.presumed_not_exists:
            return None
        return self.snapshot.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        self.membuf.set(key, value)

    def delete(self, key: bytes) -> None:
        self.membuf.delete(key)

    def iter_range(self, start: bytes | None, end: bytes | None):
        """Merge iterator: buffer entries shadow snapshot entries."""
        buf = self.membuf.iter_range(start, end)
        snap = self.snapshot.iter_range(start, end)
        bk, bv = next(buf, (None, None))
        sk, sv = next(snap, (None, None))
        while bk is not None or sk is not None:
            if sk is None or (bk is not None and bk <= sk):
                if bk == sk:
                    sk, sv = next(snap, (None, None))
                if bv is not _TOMBSTONE:
                    yield bk, bv
                bk, bv = next(buf, (None, None))
            else:
                yield sk, sv
                sk, sv = next(snap, (None, None))


# ---------------------------------------------------------------------------
# Transaction / Storage / coprocessor client

class Transaction(abc.ABC):
    """Ref: kv/kv.go Transaction."""

    start_ts: int

    @abc.abstractmethod
    def get(self, key: bytes) -> Optional[bytes]: ...

    @abc.abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abc.abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abc.abstractmethod
    def iter_range(self, start, end) -> Iterator[tuple[bytes, bytes]]: ...

    @abc.abstractmethod
    def commit(self) -> None: ...

    @abc.abstractmethod
    def rollback(self) -> None: ...


@dataclass
class KVRange:
    start: bytes
    end: bytes  # exclusive


@dataclass
class CopRequest:
    """Pushed-down subplan request. Ref: kv/kv.go Request (Tp=DAG) +
    tipb.DAGRequest; `plan` is our serialized physical subplan."""

    tp: ReqType
    ranges: list[KVRange]
    plan: object
    start_ts: int
    concurrency: int = 0   # 0 = the tidb_tpu_cop_concurrency sysvar
    keep_order: bool = False
    desc: bool = False
    priority: Priority = Priority.NORMAL
    isolation: IsolationLevel = IsolationLevel.SI


@dataclass
class CopResponse:
    """One partial result (per region task)."""

    chunk: object  # tidb_tpu_torch.chunk.Chunk
    range: KVRange | None = None


class Client(abc.ABC):
    """Coprocessor client: fans a CopRequest out per region.
    Ref: kv/kv.go Client, store/tikv/coprocessor.go CopClient."""

    @abc.abstractmethod
    def send(self, req: CopRequest) -> Iterable[CopResponse]: ...


class Storage(abc.ABC):
    """Ref: kv/kv.go Storage."""

    @abc.abstractmethod
    def begin(self) -> Transaction: ...

    @abc.abstractmethod
    def snapshot(self, ts: int) -> Snapshot: ...

    @abc.abstractmethod
    def current_ts(self) -> int: ...

    @abc.abstractmethod
    def client(self) -> Client: ...

    def close(self) -> None:
        pass
