"""Storage facade: composes cluster, engine, rpc shim, caches, oracle.

The port's copy of the JAX package's store/storage.py. One addition:
the storage carries the device its coprocessor's kernels and its HBM
block cache run on (CUDA unless the caller asks for another), where the
reference's device plane is process-wide.
"""

from __future__ import annotations

from tidb_tpu_torch import kv
from tidb_tpu_torch.mockstore.cluster import Cluster
from tidb_tpu_torch.mockstore.mvcc import MVCCStore
from tidb_tpu_torch.mockstore.rpc import RPCShim
from tidb_tpu_torch.store.oracle import PDOracle
from tidb_tpu_torch.store.region_cache import RegionCache
from tidb_tpu_torch.store.txn import KVTxn, LockResolver, TxnSnapshot

__all__ = ["MockStorage", "new_mock_storage"]


class MockStorage(kv.Storage):
    """In-process distributed-store simulation behind the kv.Storage API."""

    def __init__(self, cluster: Cluster, engine: MVCCStore, device=None):
        from tidb_tpu_torch.ops.runtime import resolve_device
        self.device = resolve_device(device)
        self.cluster = cluster
        self.engine = engine
        self.shim = RPCShim(cluster, engine)
        self.region_cache = RegionCache(cluster)
        self.oracle = PDOracle(cluster)
        self.resolver = LockResolver(self.shim, self.region_cache, self.oracle)
        self.async_commit_secondaries = True
        self._client = None
        self.safepoint = 0   # GC safepoint (ref: safepoint.go watcher)
        # storage-node columnar cache for the coprocessor read path
        from tidb_tpu_torch.store.chunk_cache import ChunkCache
        self.chunk_cache = ChunkCache()
        # HBM-resident region-block cache: the device-side tier of the
        # same hierarchy (store/device_cache.py) — fused agg dispatches
        # read cached blocks straight from device memory
        from tidb_tpu_torch.store.device_cache import DeviceCache
        self.device_cache = DeviceCache(self.device)
        # MVCC delta store (store/delta.py): committed row mutations
        # journal here (the engine calls ingest under its lock) and
        # both cache tiers serve base ⋈ delta instead of re-colding on
        # every OLTP write
        from tidb_tpu_torch.store.delta import DeltaStore
        self.delta_store = DeltaStore(self)
        engine.set_delta_sink(self.delta_store)
        # the shim's journal-window command reads this node's delta
        # store; the shim only holds cluster+engine
        self.shim.bind_storage(self)

    def begin(self, start_ts: int | None = None) -> KVTxn:
        return KVTxn(self, start_ts if start_ts is not None
                     else self.oracle.get_timestamp())

    def snapshot(self, ts: int) -> TxnSnapshot:
        return TxnSnapshot(self.shim, self.region_cache, self.resolver, ts,
                           storage=self)

    def update_safepoint(self, sp: int) -> None:
        self.safepoint = max(self.safepoint, sp)

    def check_visibility(self, ts: int) -> None:
        """Reject snapshots the GC may already have pruned under
        (ref: tikvStore.CheckVisibility)."""
        if ts < self.safepoint:
            raise kv.GCTooEarlyError(
                f"snapshot ts {ts} is below GC safepoint {self.safepoint}")

    def current_ts(self) -> int:
        return self.oracle.get_timestamp()

    def client(self):
        """Coprocessor client; installed by tidb_tpu_torch.store.copr."""
        if self._client is None:
            from tidb_tpu_torch.store.copr import CopClient
            self._client = CopClient(self)
        return self._client

    def close(self) -> None:
        self.oracle.close()
        # return the HBM cache's and delta journal's ledger shares
        # eagerly (GC would, later)
        self.device_cache.shed()
        self.delta_store.close()


def new_mock_storage(num_stores: int = 1, device=None) -> MockStorage:
    """Hermetic store (ref: NewMockTikvStore) whose kernels run on
    `device`: CUDA unless the caller asks for another."""
    cluster = Cluster()
    cluster.bootstrap(num_stores)
    return MockStorage(cluster, MVCCStore(), device=device)
