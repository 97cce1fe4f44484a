"""The reference's `tests/test_mesh_sql.py`, replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch` and
every storage on the CPU). `tidb_tpu.parallel` maps onto the port's
devplane (the plane of 8 shards on the CPU) and ops/meshshuffle.py; the
port's HashJoin operator is executor/join.HashJoin."""

from tests.test_torch_server import replay

replay("test_mesh_sql.py", globals(), subs={
    "from tidb_tpu import parallel":
        "from tidb_tpu import devplane as parallel",
    "    parallel.enable_mesh(8)\n    yield":
        '    parallel.enable_mesh(8, device="cpu")\n    yield',
    "            parallel.enable_mesh(8)\n":
        '            parallel.enable_mesh(8, device="cpu")\n',
    "parallel.enable_mesh(1)":
        'parallel.enable_mesh(1, device="cpu")',
    "from tidb_tpu import executor as ex":
        "from tidb_tpu.executor import join as ex",
    "ex.HashJoinExec": "ex.HashJoin",
    "from tidb_tpu.parallel import shuffle_join as sj":
        "from tidb_tpu.ops import meshshuffle as sj"})
