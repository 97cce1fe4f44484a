"""The reference's `tests/test_ranger.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU)."""

from tests.test_torch_server import replay

replay("test_ranger.py", globals(), subs={
    # the port splits executor/__init__.py: IndexLookUp is in reader.py
    "import tidb_tpu.executor as ex\n":
    "import tidb_tpu.executor.reader as ex\n",
    "ex.IndexLookUpExec": "ex.IndexLookUp"})
