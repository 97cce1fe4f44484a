"""The reference's `tests/test_mesh_stream.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU). `tidb_tpu.parallel` maps onto the port's
devplane: the plane of 8 shards on the CPU."""

from tests.test_torch_server import replay

replay("test_mesh_stream.py", globals(), subs={
    "from tidb_tpu import config, parallel":
        "from tidb_tpu import config\n"
        "from tidb_tpu import devplane as parallel",
    "    parallel.enable_mesh(8)\n    yield":
        '    parallel.enable_mesh(8, device="cpu")\n    yield',
    "        parallel.enable_mesh(8)\n":
        '        parallel.enable_mesh(8, device="cpu")\n'})
