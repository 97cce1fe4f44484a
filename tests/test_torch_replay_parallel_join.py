"""The reference's `tests/test_parallel_join.py`, replayed against the
port (`replay`: its source with the package pointed at `tidb_tpu_torch`).
The port has no `parallel/` import shims: the lookup-aggregate kernel
comes from ops/meshjoin.py and `build_mesh` from devplane.py, on an
8-shard plane on the CPU."""

from tests.test_torch_server import replay

replay("test_parallel_join.py", globals(), subs={
    "from tidb_tpu.parallel import build_mesh":
        "from tidb_tpu.devplane import build_mesh",
    "from tidb_tpu.parallel.dist_join import":
        "from tidb_tpu.ops.meshjoin import",
    "return build_mesh(8)": 'return build_mesh(8, device="cpu")'})
