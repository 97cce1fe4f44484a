"""Snapshot reads, lock resolution, and Percolator 2PC commit.

Reference: TiDB's store/tikv/ —
  snapshot.go:63-276   per-region batched reads, lock encounters -> resolve
  lock_resolver.go:158 check primary txn status, roll forward/back
  2pc.go:65-697        twoPhaseCommitter: group mutations by region, batch,
                       primary batch first, parallel workers with forked
                       backoffers, async secondary commit, undetermined error
  txn.go               tikvTxn = unionstore + committer
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Optional

from tidb_tpu_torch import kv
from tidb_tpu_torch.kv import (IsolationLevel, KeyLockedError, KVError, LockInfo,
                               Mutation, MutationOp, RegionError, NotLeaderError,
                               ServerBusyError, TxnAbortedError, UndeterminedError)
from tidb_tpu_torch.mockstore.rpc import RPCShim, TimeoutError_
from tidb_tpu_torch.store.backoff import (BO_REGION_MISS, BO_SERVER_BUSY,
                                          BO_TXN_LOCK, Backoffer,
                                          COMMIT_MAX_BACKOFF, GET_MAX_BACKOFF,
                                          PREWRITE_MAX_BACKOFF, SCAN_MAX_BACKOFF)
from tidb_tpu_torch.store.region_cache import RegionCache

log = logging.getLogger("tidb_tpu_torch.store")

# ref: 2pc.go txnCommitBatchSize = 16 * 1024 bytes; we batch by key count
COMMIT_BATCH_SIZE = 256
SCAN_BATCH_SIZE = 1024
DEFAULT_LOCK_TTL_MS = 3000
MAX_TXN_TTL_MS = 120_000


def txn_lock_ttl(num_keys: int) -> int:
    """TTL scales with txn size (ref: 2pc.go:185-186)."""
    return min(DEFAULT_LOCK_TTL_MS + num_keys * 2, MAX_TXN_TTL_MS)


class LockResolver:
    """Ref: lock_resolver.go — any reader can resolve a dead writer's locks:
    check the primary's status; expired -> roll the whole txn forward (if the
    primary committed) or back (otherwise)."""

    def __init__(self, shim: RPCShim, cache: RegionCache, oracle):
        self.shim = shim
        self.cache = cache
        self.oracle = oracle
        self._resolved: dict[int, int] = {}  # start_ts -> commit_ts (0=rolled back)
        self._mu = threading.Lock()

    def resolve(self, bo: Backoffer, locks: list[LockInfo]) -> bool:
        """Try to resolve; returns True if all were cleaned (caller may
        retry immediately), False if some lock is still alive (caller backs
        off)."""
        all_cleaned = True
        for lock in locks:
            with self._mu:
                known = self._resolved.get(lock.start_ts)
            if known is None:
                try:
                    status = self._get_txn_status(bo, lock)
                except KeyLockedError:
                    all_cleaned = False  # primary lock still alive
                    continue
                with self._mu:
                    self._resolved[lock.start_ts] = status
                    if len(self._resolved) > 2048:
                        self._resolved.pop(next(iter(self._resolved)))
                known = status
            self._resolve_region_lock(bo, lock, known)
        return all_cleaned

    def _get_txn_status(self, bo: Backoffer, lock: LockInfo) -> int:
        """Cleanup RPC on the primary: returns commit_ts (>0 committed,
        0 rolled back); raises KeyLockedError if still alive."""
        current = self.oracle.get_timestamp()
        while True:
            loc = self.cache.locate(lock.primary)
            try:
                return self.shim.kv_cleanup(loc.ctx, lock.primary,
                                            lock.start_ts, current)
            except RegionError as e:
                self._on_region_err(bo, e, loc.region.id)

    def _resolve_region_lock(self, bo: Backoffer, lock: LockInfo,
                             commit_ts: int) -> None:
        while True:
            loc = self.cache.locate(lock.key)
            try:
                self.shim.kv_resolve_lock(loc.ctx, lock.start_ts, commit_ts)
                return
            except RegionError as e:
                self._on_region_err(bo, e, loc.region.id)

    def _on_region_err(self, bo: Backoffer, e: RegionError, region_id: int):
        if isinstance(e, NotLeaderError):
            self.cache.on_not_leader(e)
        else:
            self.cache.invalidate(region_id)
        bo.backoff(BO_REGION_MISS, e)


class TxnSnapshot(kv.Snapshot):
    """MVCC snapshot at start_ts with region retry + lock resolution.
    Ref: snapshot.go tikvSnapshot."""

    def __init__(self, shim: RPCShim, cache: RegionCache, resolver: LockResolver,
                 ts: int, isolation: IsolationLevel = IsolationLevel.SI,
                 storage=None):
        self.shim = shim
        self.cache = cache
        self.resolver = resolver
        self.ts = ts
        self.isolation = isolation
        self.storage = storage

    # -- retry wrapper -------------------------------------------------------

    def _with_retry(self, bo: Backoffer, key_for_route: bytes, fn):
        """fn(loc) with region-error and lock handling."""
        if self.storage is not None:
            self.storage.check_visibility(self.ts)
        while True:
            loc = self.cache.locate(key_for_route)
            try:
                return fn(loc)
            except NotLeaderError as e:
                self.cache.on_not_leader(e)
                bo.backoff(BO_REGION_MISS, e)
            except RegionError as e:
                self.cache.invalidate(loc.region.id)
                bo.backoff(BO_REGION_MISS, e)
            except ServerBusyError as e:
                bo.backoff(BO_SERVER_BUSY, e)
            except KeyLockedError as e:
                cleaned = self.resolver.resolve(bo, [e.lock])
                if not cleaned:
                    bo.backoff(BO_TXN_LOCK, e)

    # -- reads ---------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        bo = Backoffer(GET_MAX_BACKOFF)
        return self._with_retry(
            bo, key,
            lambda loc: self.shim.kv_get(loc.ctx, key, self.ts, self.isolation))

    def batch_get(self, keys: list[bytes]) -> dict[bytes, bytes]:
        """Per-region parallel batches (ref: snapshot.go:95)."""
        out: dict[bytes, bytes] = {}
        pending = list(dict.fromkeys(keys))
        bo = Backoffer(GET_MAX_BACKOFF)
        while pending:
            groups = self.cache.group_keys_by_region(pending)
            pending = []
            for _rid, (loc, ks) in groups.items():
                try:
                    out.update(self.shim.kv_batch_get(
                        loc.ctx, ks, self.ts, self.isolation))
                except NotLeaderError as e:
                    self.cache.on_not_leader(e)
                    bo.backoff(BO_REGION_MISS, e)
                    pending.extend(ks)
                except RegionError as e:
                    self.cache.invalidate(loc.region.id)
                    bo.backoff(BO_REGION_MISS, e)
                    pending.extend(ks)
                except ServerBusyError as e:
                    bo.backoff(BO_SERVER_BUSY, e)
                    pending.extend(ks)
                except KeyLockedError as e:
                    if not self.resolver.resolve(bo, [e.lock]):
                        bo.backoff(BO_TXN_LOCK, e)
                    pending.extend(ks)
        return out

    def iter_range(self, start: bytes | None, end: bytes | None
                   ) -> Iterator[tuple[bytes, bytes]]:
        """Chunked scanner across regions (ref: scan.go Scanner)."""
        cur = start or b""
        end = end or b""
        bo = Backoffer(SCAN_MAX_BACKOFF)
        while True:
            # own retry loop: the region actually answering must supply the
            # continuation point (a stale cached end would skip keys if the
            # region split mid-scan)
            while True:
                loc = self.cache.locate(cur)
                try:
                    batch = self.shim.kv_scan(
                        loc.ctx, cur, end, SCAN_BATCH_SIZE, self.ts,
                        self.isolation)
                    break
                except NotLeaderError as e:
                    self.cache.on_not_leader(e)
                    bo.backoff(BO_REGION_MISS, e)
                except RegionError as e:
                    self.cache.invalidate(loc.region.id)
                    bo.backoff(BO_REGION_MISS, e)
                except ServerBusyError as e:
                    bo.backoff(BO_SERVER_BUSY, e)
                except KeyLockedError as e:
                    if not self.resolver.resolve(bo, [e.lock]):
                        bo.backoff(BO_TXN_LOCK, e)
            yield from batch
            region_end = loc.region.end
            if len(batch) == SCAN_BATCH_SIZE:
                cur = batch[-1][0] + b"\x00"
            elif region_end and (not end or region_end < end):
                cur = region_end  # region exhausted: continue into the next
            else:
                return


# ---------------------------------------------------------------------------
# 2PC

@dataclass
class _Batch:
    loc: object          # KeyLocation
    keys: list


# Set by every committer pool worker at thread start. _on_batches keys
# its no-nested-submit guard on this flag, NOT on the thread's display
# name: a worker that submits sub-batches to its own bounded pool and
# blocks on the results deadlocks once every worker is a blocked parent
# (and the stuck workers then hang interpreter shutdown).
_2PC_WORKER = threading.local()


def _mark_2pc_worker() -> None:
    _2PC_WORKER.flag = True


class TwoPhaseCommitter:
    """Percolator optimistic commit. Ref: 2pc.go twoPhaseCommitter."""

    def __init__(self, shim: RPCShim, cache: RegionCache, oracle,
                 resolver: LockResolver, mutations: dict[bytes, Mutation],
                 start_ts: int, concurrency: int = 8,
                 async_secondaries: bool = True, schema_checker=None):
        self.schema_checker = schema_checker
        self.shim = shim
        self.cache = cache
        self.oracle = oracle
        self.resolver = resolver
        self.mutations = mutations
        self.keys = list(mutations.keys())
        self.start_ts = start_ts
        self.commit_ts = 0
        self.primary = self.keys[0] if self.keys else b""
        self.ttl_ms = txn_lock_ttl(len(self.keys))
        self.concurrency = concurrency
        self.async_secondaries = async_secondaries
        self.undetermined = False
        self._pool = ThreadPoolExecutor(max_workers=concurrency,
                                        thread_name_prefix="2pc",
                                        initializer=_mark_2pc_worker)

    # -- batching ------------------------------------------------------------

    def _group(self, keys: list[bytes]) -> list[_Batch]:
        """Group by region then split into size-capped batches; the batch
        containing the primary key goes first (ref: doActionOnKeys
        2pc.go:192-236)."""
        groups = self.cache.group_keys_by_region(keys)
        batches: list[_Batch] = []
        for _rid, (loc, ks) in groups.items():
            for i in range(0, len(ks), COMMIT_BATCH_SIZE):
                batches.append(_Batch(loc, ks[i:i + COMMIT_BATCH_SIZE]))
        batches.sort(key=lambda b: 0 if self.primary in b.keys else 1)
        return batches

    def _on_batches(self, bo: Backoffer, keys: list[bytes], action,
                    primary_first: bool) -> None:
        """Run `action(bo, batch)` over batches; primary batch runs alone
        first, the rest in parallel with forked backoffers and first-error
        cancel (ref: doActionOnBatches 2pc.go:239-305)."""
        if not keys:
            return
        batches = self._group(keys)
        if primary_first and batches and self.primary in batches[0].keys:
            action(bo, batches[0])
            batches = batches[1:]
        if not batches:
            return
        if len(batches) == 1:
            action(bo, batches[0])
            return
        first_err = None
        if getattr(_2PC_WORKER, "flag", False):
            # Already on a pool worker (async secondaries, or a
            # RegionError re-split inside a batch action): fan out
            # inline. Submitting to the same bounded pool and blocking
            # on the results deadlocks once every worker is a blocked
            # parent — the queued children then never run, and the
            # stuck workers hang interpreter shutdown.
            for b in batches:
                try:
                    action(bo.fork(), b)
                except Exception as e:  # noqa: BLE001 - propagate first error
                    if first_err is None:
                        first_err = e
            if first_err is not None:
                raise first_err
            return
        futures = [self._pool.submit(action, bo.fork(), b) for b in batches]
        for f in futures:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 - propagate first error
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    # -- actions -------------------------------------------------------------

    def _prewrite_batch(self, bo: Backoffer, batch: _Batch) -> None:
        muts = [self.mutations[k] for k in batch.keys]
        while True:
            loc = self.cache.locate(batch.keys[0])
            try:
                self.shim.kv_prewrite(loc.ctx, muts, self.primary,
                                      self.start_ts, self.ttl_ms)
                return
            except NotLeaderError as e:
                self.cache.on_not_leader(e)
                bo.backoff(BO_REGION_MISS, e)
            except RegionError as e:
                # region changed: re-split this batch (ref: 2pc.go:319-355)
                self.cache.invalidate(loc.region.id)
                bo.backoff(BO_REGION_MISS, e)
                self._on_batches(bo, batch.keys, self._prewrite_batch, False)
                return
            except ServerBusyError as e:
                bo.backoff(BO_SERVER_BUSY, e)
            except KeyLockedError as e:
                if not self.resolver.resolve(bo, [e.lock]):
                    bo.backoff(BO_TXN_LOCK, e)

    def _commit_batch(self, bo: Backoffer, batch: _Batch) -> None:
        is_primary = self.primary in batch.keys
        while True:
            loc = self.cache.locate(batch.keys[0])
            try:
                self.shim.kv_commit(loc.ctx, batch.keys, self.start_ts,
                                    self.commit_ts)
                return
            except TimeoutError_ as e:
                if is_primary:
                    # outcome unknown: surface undetermined (2pc.go:421-431)
                    self.undetermined = True
                    raise UndeterminedError(str(e)) from e
                raise
            except NotLeaderError as e:
                self.cache.on_not_leader(e)
                bo.backoff(BO_REGION_MISS, e)
            except RegionError as e:
                self.cache.invalidate(loc.region.id)
                bo.backoff(BO_REGION_MISS, e)
                self._on_batches(bo, batch.keys, self._commit_batch, False)
                return
            except ServerBusyError as e:
                bo.backoff(BO_SERVER_BUSY, e)

    def _cleanup_batch(self, bo: Backoffer, batch: _Batch) -> None:
        while True:
            loc = self.cache.locate(batch.keys[0])
            try:
                self.shim.kv_batch_rollback(loc.ctx, batch.keys,
                                            self.start_ts)
                return
            except NotLeaderError as e:
                self.cache.on_not_leader(e)
                bo.backoff(BO_REGION_MISS, e)
            except RegionError as e:
                self.cache.invalidate(loc.region.id)
                bo.backoff(BO_REGION_MISS, e)
                self._on_batches(bo, batch.keys, self._cleanup_batch, False)
                return

    # -- protocol ------------------------------------------------------------

    def execute(self) -> int:
        """Prewrite all -> get commit ts -> commit primary -> commit
        secondaries (async by default). Returns commit_ts.
        Ref: 2pc.go execute()."""
        if not self.keys:
            return self.start_ts
        try:
            bo = Backoffer(PREWRITE_MAX_BACKOFF)
            self._on_batches(bo, self.keys, self._prewrite_batch,
                             primary_first=False)
        except Exception:
            self._cleanup_async()
            raise
        self.commit_ts = self.oracle.get_timestamp()
        if self.schema_checker is not None:
            # revalidate the schema lease between prewrite and the point of
            # no return (ref: 2pc.go:653 checkSchemaValid)
            try:
                self.schema_checker()
            except Exception:
                self._cleanup_async()
                raise
        cbo = Backoffer(COMMIT_MAX_BACKOFF)
        try:
            self._on_batches(cbo, [self.primary], self._commit_batch,
                             primary_first=True)
        except UndeterminedError:
            raise
        except Exception:
            self._cleanup_async()
            raise
        secondaries = [k for k in self.keys if k != self.primary]
        if secondaries:
            if self.async_secondaries:
                # ref: 2pc.go:224-231 commit secondaries in background
                self._pool.submit(self._commit_secondaries, secondaries)
            else:
                self._commit_secondaries(secondaries)
        return self.commit_ts

    def _commit_secondaries(self, keys: list[bytes]) -> None:
        try:
            bo = Backoffer(COMMIT_MAX_BACKOFF)
            self._on_batches(bo, keys, self._commit_batch, primary_first=False)
        except Exception as e:  # noqa: BLE001
            # safe to leave: readers will resolve via the committed primary
            log.warning("async secondary commit failed (resolvable): %s", e)

    def _cleanup_async(self) -> None:
        keys = list(self.keys)

        def run():
            try:
                bo = Backoffer(COMMIT_MAX_BACKOFF)
                self._on_batches(bo, keys, self._cleanup_batch,
                                 primary_first=False)
            except Exception as e:  # noqa: BLE001
                log.warning("2pc cleanup failed (left to resolver): %s", e)

        self._pool.submit(run)

    def close(self):
        self._pool.shutdown(wait=True)


class KVTxn(kv.Transaction):
    """Transaction = UnionStore over a snapshot + 2PC on commit.
    Ref: store/tikv/txn.go tikvTxn."""

    def __init__(self, storage, start_ts: int):
        self.storage = storage
        self.start_ts = start_ts
        self.snapshot = storage.snapshot(start_ts)
        self.us = kv.UnionStore(self.snapshot)
        self.valid = True
        self.committed = False
        # schema-lease check hook, set by the session (ref: kv.Options
        # SchemaLeaseChecker, kv/kv.go:38; checked at 2pc.go:653)
        self.schema_checker = None
        self.related_tables: set[int] = set()
        self.lock_keys: set[bytes] = set()   # SELECT ... FOR UPDATE
        self.for_update = False              # disables optimistic replay

    def get(self, key: bytes) -> Optional[bytes]:
        return self.us.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        self.us.set(key, value)

    def delete(self, key: bytes) -> None:
        self.us.delete(key)

    def iter_range(self, start, end):
        return self.us.iter_range(start, end)

    def presume_not_exists(self, key: bytes) -> None:
        self.us.presumed_not_exists.add(key)

    def lock_key(self, key: bytes) -> None:
        """SELECT ... FOR UPDATE: buffer a prewrite-only LOCK on the row
        key (ref: Txn.LockKeys, executor/executor.go:389 SelectLockExec).
        Commit conflicts if another txn wrote the key after start_ts."""
        self.lock_keys.add(key)
        self.for_update = True

    def mutations(self) -> dict[bytes, Mutation]:
        """Walk the membuffer into 2PC mutations (ref: 2pc.go:118-158)."""
        muts: dict[bytes, Mutation] = {}
        for k, v in self.us.membuf.items():
            if v is kv._TOMBSTONE:
                muts[k] = Mutation(MutationOp.DELETE, k)
            else:
                muts[k] = Mutation(MutationOp.PUT, k, v)
        for k in self.lock_keys:
            if k not in muts:     # a real write supersedes the lock
                muts[k] = Mutation(MutationOp.LOCK, k)
        return muts

    def commit(self) -> None:
        if not self.valid:
            raise KVError("txn invalid")
        self.valid = False
        muts = self.mutations()
        if not muts:
            self.committed = True
            return
        committer = TwoPhaseCommitter(
            self.storage.shim, self.storage.region_cache, self.storage.oracle,
            self.storage.resolver, muts, self.start_ts,
            async_secondaries=self.storage.async_commit_secondaries,
            schema_checker=self.schema_checker)
        try:
            committer.execute()
            self.committed = True
            pump = getattr(self.storage, "binlog_pump", None)
            if pump is not None:
                # change capture on commit success (ref: binloginfo pump
                # hook, 2pc.go:664: the prewrite payload and the commit
                # record as one event). A sink never fails a commit
                from tidb_tpu_torch.binlog import make_event
                try:
                    ev = make_event(self.start_ts, committer.commit_ts,
                                    muts)
                    if ev is not None:
                        pump.write(ev)
                except Exception:   # noqa: BLE001
                    pass
        finally:
            if not self.storage.async_commit_secondaries:
                committer.close()

    def rollback(self) -> None:
        self.valid = False
