"""The race harness over the port's threaded store paths, under the
port's runtime lock-order sanitizer.

The reference's `tests/test_race_harness.py` is replayed against the
port (`replay`: its source with the package pointed at
`tidb_tpu_torch` and every storage on the CPU): each workload multiplies
thread interleavings (`tidb_tpu_torch/util/racecheck.stress`) and
asserts semantic invariants — monotonic TSO, no lost updates, one
unique-insert winner, scans across region splits, DDL beside DML, delta
writes beside analytic scans — while `tidb_tpu_torch/util/lockorder`
checks every acquisition of a lock built at a registered site against
the static DAG of the port's own `lock-order` rule. The checker's own
cases (inversions caught, hierarchies allowed, self-deadlocks raised)
run against its synthetic DAG. Every case is replayed.
"""

import os
import subprocess
import sys

from tests.test_torch_server import ROOT, replay

replay("test_race_harness.py", globals())


def test_static_dag_is_the_ports():
    from tidb_tpu_torch.util import lockorder
    dag = lockorder.static_dag()
    names = set(dag["kinds"])
    assert names and all(n.startswith("tidb_tpu_torch/") for n in names)
    assert "tidb_tpu_torch/memtrack.py:MemTracker._mu" in names
    assert all(rel.startswith("tidb_tpu_torch/") for rel, _ln in
               dag["sites"])


def test_env_gate_enables_the_sanitizer_at_import():
    """TIDB_TPU_LOCK_SANITIZER=1 patches the lock factories at `import
    tidb_tpu_torch`; a lock built at a registered site comes back
    tracked, and nothing of the JAX package is loaded."""
    code = ("import sys, tidb_tpu_torch\n"
            "from tidb_tpu_torch.util import lockorder\n"
            "from tidb_tpu_torch.memtrack import MemTracker\n"
            "assert lockorder.active() is not None\n"
            "t = MemTracker('x')\n"
            "assert isinstance(t._mu, lockorder._TrackedLock), t._mu\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'tidb_tpu.')) or m == 'tidb_tpu']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {**os.environ, "TIDB_TPU_LOCK_SANITIZER": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stderr[-2000:]
