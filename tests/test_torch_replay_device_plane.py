"""The reference's `tests/test_device_plane.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU): the accounting and observability seams fire
identically on a 1-shard and an 8-shard plane (8 shards on the CPU)."""

from tests.test_torch_server import replay

replay("test_device_plane.py", globals(), subs={
    "        devplane.enable_mesh(n)":
        '        devplane.enable_mesh(n, device="cpu")'})
