"""Lease-based owner election over the KV store.

Reference: TiDB's owner/manager.go:40-53 — etcd-session
campaigns electing the DDL owner (and stats owner). There is no etcd
here; the shared MVCC store itself is the coordination substrate, the
same move the reference's GC worker makes with its mysql.tidb lease rows
(gc_worker.go:550 checkLeader). A lease record holds (owner_id,
expiry_ts); campaign() atomically takes over expired/absent leases via
an ordinary 2PC write, so exactly one campaigner per key wins — a
conflicting writer hits WriteConflictError and loses.
"""

from __future__ import annotations

import json
import time
import uuid

from tidb_tpu_torch import kv
from tidb_tpu_torch.mockstore.rpc import TimeoutError_

__all__ = ["OwnerManager", "DDL_OWNER_KEY"]

DDL_OWNER_KEY = b"m_owner_ddl"


class OwnerManager:
    """One election participant (ref: owner.Manager)."""

    def __init__(self, storage, key: bytes = DDL_OWNER_KEY,
                 lease_ms: int = 2000, owner_id: str | None = None):
        self.storage = storage
        self.key = key
        self.lease_ms = lease_ms
        self.id = owner_id or uuid.uuid4().hex[:12]

    def _read(self, txn):
        raw = txn.get(self.key)
        if not raw:
            return "", 0
        try:
            o = json.loads(raw)
            return o["id"], int(o["expiry"])
        except (ValueError, KeyError):
            return "", 0     # corrupt lease: treated as expired

    def campaign(self) -> bool:
        """Take or renew the lease; True iff this manager is now owner."""
        now = int(time.time() * 1000)
        txn = self.storage.begin()
        try:
            owner, expiry = self._read(txn)
            if owner == self.id or not owner or expiry <= now:
                txn.set(self.key, json.dumps(
                    {"id": self.id,
                     "expiry": now + self.lease_ms}).encode())
                txn.commit()
                return True
            txn.rollback()
            return False
        except (kv.RetryableError, TimeoutError_):
            # lost the race to another campaigner, or the commit RPC
            # timed out (fleet mode: store plane over the wire) —
            # either way this round is lost; the next campaign retries
            return False
        except Exception:
            if getattr(txn, "valid", False):
                txn.rollback()
            raise

    def is_owner(self) -> bool:
        """Currently holding an unexpired lease (no renewal)."""
        now = int(time.time() * 1000)
        txn = self.storage.begin()
        try:
            owner, expiry = self._read(txn)
            return owner == self.id and expiry > now
        finally:
            txn.rollback()

    def owner_id(self) -> str | None:
        """The current (unexpired) owner, or None."""
        now = int(time.time() * 1000)
        txn = self.storage.begin()
        try:
            owner, expiry = self._read(txn)
            return owner if owner and expiry > now else None
        finally:
            txn.rollback()

    def resign(self) -> None:
        txn = self.storage.begin()
        try:
            owner, _ = self._read(txn)
            if owner == self.id:
                txn.delete(self.key)
                txn.commit()
            else:
                txn.rollback()
        except (kv.RetryableError, TimeoutError_):
            pass
        except Exception:
            if getattr(txn, "valid", False):
                txn.rollback()
            raise
