"""The port's fleet plane against the reference's own tests: one store
plane and N stateless SQL servers, each with its own coherent caches,
the membership registry, the `cluster_*` memtables, `/cluster/state`
and `/fleet/*`, and trace ids carrying the member nonce.

Replayed against the port (`replay`: the source pointed at
`tidb_tpu_torch`, every storage, store plane, `connect` and `Fleet` on
the CPU): `tests/test_fleet_coherence.py` (journal-window coherence of
a fleet SQL server's local caches, in process),
`tests/test_fleet_process.py` (a real `Fleet(n_sql=2)` of subprocesses,
module-scoped: cross-process schema, the cluster plane, chaos; its
clients are the port's `util/mysqlclient.MiniClient`),
`tests/test_trace_remote.py` (span trees grafted across the wire) and
`tests/test_failpoint.py`, whose `TestStatusEndpoint` arms failpoints
over the status port. `Fleet()` refuses to start without a card unless
it is asked for the CPU; a child's readiness wait keeps its deadline,
and a chatty child never blocks on its own output.
"""

import pytest

from tests.test_torch_server import replay


def test_fleet_without_a_card_refuses_to_start():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from tidb_tpu_torch.fleet import Fleet
    f = None
    with pytest.raises(RuntimeError, match="CUDA"):
        f = Fleet(n_sql=2)
    assert f is None


def test_await_line_keeps_its_deadline_on_a_silent_child():
    import sys
    import time
    from tidb_tpu_torch import fleet
    proc = fleet._spawn([sys.executable, "-c",
                         "import time; time.sleep(60)"])
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            fleet._await_line(proc, "storage listening on", timeout=1.0)
        assert time.monotonic() - t0 < 10
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_a_chatty_child_never_blocks_on_its_output():
    """Past the pipe's buffer (64 KiB) a child whose output nobody read
    would block in its next write; the fleet drains it."""
    import sys
    from tidb_tpu_torch import fleet
    proc = fleet._spawn([sys.executable, "-c",
                         "print('status API on 127.0.0.1:1', flush=True)\n"
                         "for i in range(20000): print('x' * 60)"])
    assert fleet._await_line(proc, "status API on").endswith(":1\n")
    assert proc.wait(timeout=60) == 0


replay("test_fleet_coherence.py", globals())
# its clients are the port's own (util/mysqlclient.py, what Fleet.client
# hands out), so the errors it expects are the port's client's
replay("test_fleet_process.py", globals(),
       subs={"from tests.mysql_client import MiniClient, MySQLError":
             "from tidb_tpu_torch.util.mysqlclient import MiniClient, "
             "MySQLError"})
replay("test_trace_remote.py", globals())
replay("test_failpoint.py", globals())
