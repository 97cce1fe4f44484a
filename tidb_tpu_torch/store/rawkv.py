"""Non-transactional raw KV client.

Reference: TiDB's store/tikv/rawkv.go — RawGet/Put/Delete/
BatchGet/BatchPut/Scan/DeleteRange routed per region with the same
region-cache + backoff machinery as the transactional client, but no
timestamps, no locks, no MVCC. The raw namespace lives beside the
transactional one in the storage engine (mockstore/mvcc.py raw_*),
mirroring TiKV's separate raw column family."""

from __future__ import annotations

from tidb_tpu_torch.kv import NotLeaderError, RegionError, ServerBusyError
from tidb_tpu_torch.store.backoff import (BO_REGION_MISS, BO_SERVER_BUSY,
                                          Backoffer, GET_MAX_BACKOFF,
                                          SCAN_MAX_BACKOFF)

__all__ = ["RawKVClient"]

_SCAN_BATCH = 256


class RawKVClient:
    """Raw ops over a storage's region topology (works against both the
    in-process MockStorage and the out-of-process RemoteStorage — the
    shim methods ride the same RPC surface)."""

    def __init__(self, storage):
        self.cache = storage.region_cache
        self.shim = storage.shim

    # -- single key ----------------------------------------------------------

    def _one_key(self, key: bytes, fn_name: str, *args):
        bo = Backoffer(GET_MAX_BACKOFF)
        while True:
            loc = self.cache.locate(key)
            try:
                return getattr(self.shim, fn_name)(loc.ctx, key, *args)
            except NotLeaderError as e:
                self.cache.on_not_leader(e)
                bo.backoff(BO_REGION_MISS, e)
            except RegionError as e:
                self.cache.invalidate(loc.region.id)
                bo.backoff(BO_REGION_MISS, e)
            except ServerBusyError as e:
                bo.backoff(BO_SERVER_BUSY, e)

    def get(self, key: bytes):
        return self._one_key(key, "raw_get")

    def put(self, key: bytes, value: bytes) -> None:
        self._one_key(key, "raw_put", value)

    def delete(self, key: bytes) -> None:
        self._one_key(key, "raw_delete")

    # -- batches (group by region, retry the failed groups) ------------------

    def _grouped(self, keys, run):
        bo = Backoffer(GET_MAX_BACKOFF)
        pending = list(keys)
        while pending:
            groups = self.cache.group_keys_by_region(
                [k if isinstance(k, bytes) else k[0] for k in pending])
            by_key = {(k if isinstance(k, bytes) else k[0]): k
                      for k in pending}
            pending = []
            for _rid, (loc, ks) in groups.items():
                items = [by_key[k] for k in ks]
                try:
                    run(loc, items)
                except NotLeaderError as e:
                    self.cache.on_not_leader(e)
                    bo.backoff(BO_REGION_MISS, e)
                    pending.extend(items)
                except RegionError as e:
                    self.cache.invalidate(loc.region.id)
                    bo.backoff(BO_REGION_MISS, e)
                    pending.extend(items)
                except ServerBusyError as e:
                    bo.backoff(BO_SERVER_BUSY, e)
                    pending.extend(items)

    def batch_get(self, keys: list[bytes]) -> dict:
        out: dict = {}
        self._grouped(keys, lambda loc, ks: out.update(
            self.shim.raw_batch_get(loc.ctx, ks)))
        return out

    def batch_put(self, pairs: list[tuple]) -> None:
        self._grouped(pairs, lambda loc, items: self.shim.raw_batch_put(
            loc.ctx, items))

    # -- ranges --------------------------------------------------------------

    def scan(self, start: bytes, end: bytes = b"",
             limit: int = _SCAN_BATCH) -> list[tuple]:
        """Up to `limit` pairs in [start, end), crossing region
        boundaries (ref: rawkv.go Scan)."""
        out: list[tuple] = []
        cur = start
        bo = Backoffer(SCAN_MAX_BACKOFF)
        while len(out) < limit:
            loc = self.cache.locate(cur)
            try:
                part = self.shim.raw_scan(loc.ctx, cur, end,
                                          limit - len(out))
            except NotLeaderError as e:
                self.cache.on_not_leader(e)
                bo.backoff(BO_REGION_MISS, e)
                continue
            except RegionError as e:
                self.cache.invalidate(loc.region.id)
                bo.backoff(BO_REGION_MISS, e)
                continue
            except ServerBusyError as e:
                bo.backoff(BO_SERVER_BUSY, e)
                continue
            out.extend(part)
            rend = loc.region.end
            if not rend or (end and rend >= end):
                break
            cur = rend
        return out

    def delete_range(self, start: bytes, end: bytes) -> None:
        bo = Backoffer(SCAN_MAX_BACKOFF)
        cur = start
        while True:
            loc = self.cache.locate(cur)
            try:
                self.shim.raw_delete_range(loc.ctx, cur, end)
            except NotLeaderError as e:
                self.cache.on_not_leader(e)
                bo.backoff(BO_REGION_MISS, e)
                continue
            except RegionError as e:
                self.cache.invalidate(loc.region.id)
                bo.backoff(BO_REGION_MISS, e)
                continue
            except ServerBusyError as e:
                bo.backoff(BO_SERVER_BUSY, e)
                continue
            rend = loc.region.end
            if not rend or (end and rend >= end):
                return
            cur = rend