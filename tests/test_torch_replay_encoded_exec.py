"""The reference's `tests/test_encoded_exec.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU)."""

from tests.test_torch_server import replay

replay("test_encoded_exec.py", globals(), subs={
    "capacity=1024)": 'capacity=1024, device="cpu")',
    "capacity=16384)": 'capacity=16384, device="cpu")'})
