"""The reference's `tests/test_codec.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU)."""

from tests.test_torch_server import replay

replay("test_codec.py", globals())
