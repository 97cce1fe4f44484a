"""The reference's `tests/test_physical_selection.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU)."""

from tests.test_torch_server import replay

replay("test_physical_selection.py", globals(), subs={
    # the port splits executor/__init__.py: TableReader is in reader.py
    # and holds its CopPlan itself
    "from tidb_tpu import executor as ex\n":
    "from tidb_tpu.executor import reader as ex\n",
    "ex.TableReaderExec": "ex.TableReader",
    "self.plan.cop.table.name": "self.cop.table.name"})
