"""The reference's `tests/test_parallel.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU). The port has no `parallel/` import shims:
`MeshAggKernel` comes from ops/meshagg.py and `build_mesh` from
devplane.py, on an 8-shard plane on the CPU."""

from tests.test_torch_server import replay

replay("test_parallel.py", globals(), subs={
    "from tidb_tpu.parallel import MeshAggKernel, build_mesh":
        "from tidb_tpu.ops.meshagg import MeshAggKernel\n"
        "from tidb_tpu.devplane import build_mesh",
    "return build_mesh(8)": 'return build_mesh(8, device="cpu")'})
