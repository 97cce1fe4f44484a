from tidb_tpu_torch.mockstore.cluster import Cluster, Region, Store
from tidb_tpu_torch.mockstore.mvcc import MVCCStore, WriteType
from tidb_tpu_torch.mockstore.rpc import RegionCtx, RPCShim, TimeoutError_

__all__ = ["Cluster", "Region", "Store", "MVCCStore", "WriteType",
           "RegionCtx", "RPCShim", "TimeoutError_"]
