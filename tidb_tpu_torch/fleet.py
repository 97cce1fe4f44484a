"""Fleet orchestration harness: one store plane + N stateless SQL servers.

The deployment shape of the source system (a stateless SQL layer scaling
horizontally over one shared MVCC store): this module spawns

  * one store-plane server (`python -m tidb_tpu_torch storeserve`) hosting the
    MVCCStore + TSO + region map behind the wire protocol
    (store/remote.py), with a delta-journal retention window so SQL
    servers can pull coherence deltas (store/fleetcop.py), and
  * N SQL-server processes (`python -m tidb_tpu_torch --store HOST:PORT`),
    each a full wire server with its own coherent chunk/HBM caches,

health-checks members over their status ports, hands out round-robin
client connections, and supports killing/restarting a member — the
chaos surface the fleet tests and the smoke's `fleet` phase drive. Every fleet
fault degrades to a slower correct mode: killing a SQL server yields
retryable errors on ITS clients only (errcode.ER_STORE_UNAVAILABLE
class), survivors keep serving, and the DDL owner lease fails over
within one lease interval (owner.py over the shared store).

The port's copy of the JAX package's fleet.py. Every child runs on the
fleet's torch `device` (`--device`, CUDA unless the caller asks for the
CPU): one card is shared by the store plane and the N SQL members, each
with its own HBM cache, so the members' `sql_args` should bound their
`tidb_tpu_device_cache_bytes`. `store_args` are extra arguments of the
store plane (e.g. `--snapshot PATH`), as `sql_args` are of the members.
Children start as fresh interpreters (subprocess), never as forks of a
process that may have initialized CUDA. Unlike the reference, a thread
drains each child's output for its whole life: a readiness wait keeps
its deadline even when the child prints nothing, and a child that logs
past the pipe's buffer never blocks on a write nobody reads.
"""

from __future__ import annotations

import os
import queue
import signal
import subprocess
import sys
import threading
import time

from tidb_tpu_torch.util import statusclient
from tidb_tpu_torch.util.mysqlclient import MiniClient

__all__ = ["Fleet", "SQLMember"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env(extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO_ROOT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if extra:
        env.update(extra)
    return env


def _spawn(cmd: list, extra_env=None) -> subprocess.Popen:
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=_REPO_ROOT, env=_child_env(extra_env))
    proc.lines = queue.Queue()     # the child's output, None at its end

    def drain():
        try:
            for line in proc.stdout:
                proc.lines.put(line)
        except (OSError, ValueError):
            pass                   # stdout closed under us (stop/restart)
        proc.lines.put(None)
    threading.Thread(target=drain, daemon=True,
                     name="fleet-child-output").start()
    return proc


def _await_line(proc: subprocess.Popen, needle: str,
                timeout: float = 60.0) -> str:
    """The child's first output line containing `needle` (ports are
    reported this way: the children bind port 0), within `timeout`
    seconds whether or not the child prints anything."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            line = proc.lines.get(
                timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            raise TimeoutError(
                f"no {needle!r} line within {timeout}s") from None
        if line is None:
            rc = proc.wait(timeout=10)
            raise RuntimeError(f"fleet member exited (rc={rc}) before "
                               f"reporting {needle!r}")
        if needle in line:
            return line


def _port_of(line: str) -> int:
    return int(line.strip().rsplit(":", 1)[1])


class SQLMember:
    """One SQL-server process of the fleet."""

    def __init__(self, index: int, proc: subprocess.Popen, port: int,
                 status_port: int):
        self.index = index
        self.proc = proc
        self.port = port
        self.status_port = status_port

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class Fleet:
    """Spawns and supervises the store plane + SQL servers.

    Usage::

        with Fleet(n_sql=4) as f:
            c = f.client()          # round-robin MiniClient
            c.query("SELECT 1")
            f.kill(0)               # SIGKILL one SQL server
            f.restart(0)
    """

    def __init__(self, n_sql: int = 2, host: str = "127.0.0.1",
                 retain_ms: int = 5000, sql_args=(), env=None,
                 device="cuda", store_args=()):
        # refuse here, not in a child's log: no card means no fleet
        # unless the caller asks for the CPU
        from tidb_tpu_torch.ops.runtime import resolve_device
        self.device = str(resolve_device(device))
        self.store_args = list(store_args)
        self.host = host
        self.n_sql = n_sql
        self.retain_ms = retain_ms
        self.sql_args = list(sql_args)
        self.env = dict(env or {})
        self.store_proc: subprocess.Popen | None = None
        self.store_port: int | None = None
        self.store_status_port: int | None = None
        self.members: list[SQLMember] = []
        self._rr = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Fleet":
        self.store_proc = _spawn(
            [sys.executable, "-m", "tidb_tpu_torch", "storeserve",
             "--host", self.host, "--port", "0",
             "--retain-ms", str(self.retain_ms),
             "--device", self.device, *self.store_args], self.env)
        line = _await_line(self.store_proc, "storage listening on")
        self.store_port = _port_of(line)
        # the store plane is a fleet member too: its status port serves
        # /cluster/state so cluster_* queries see store-side traces
        self.store_status_port = _port_of(
            _await_line(self.store_proc, "status API on"))
        for i in range(self.n_sql):
            self.members.append(self._spawn_sql(i))
        return self

    def _spawn_sql(self, index: int) -> SQLMember:
        proc = _spawn(
            [sys.executable, "-m", "tidb_tpu_torch",
             "--host", self.host, "--port", "0", "--status-port", "0",
             "--no-mesh", "--store", f"{self.host}:{self.store_port}",
             "--device", self.device, *self.sql_args], self.env)
        port = _port_of(_await_line(proc, "MySQL protocol on"))
        status_port = _port_of(_await_line(proc, "status API on"))
        return SQLMember(index, proc, port, status_port)

    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, *_exc) -> None:
        self.stop()

    def stop(self) -> None:
        for m in self.members:
            if m.alive():
                m.proc.terminate()
        for m in self.members:
            if m.proc is not None:
                try:
                    m.proc.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    m.proc.kill()
                    m.proc.wait(timeout=10)
                m.proc.stdout.close()
        self.members.clear()
        if self.store_proc is not None:
            self.store_proc.terminate()
            try:
                self.store_proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                self.store_proc.kill()
                self.store_proc.wait(timeout=10)
            self.store_proc.stdout.close()
            self.store_proc = None

    # -- chaos surface -------------------------------------------------------

    def kill(self, index: int, sig: int = signal.SIGKILL) -> None:
        """Forcibly kill one SQL member (default SIGKILL: no graceful
        close, in-flight statements die with it)."""
        m = self.members[index]
        if m.alive():
            m.proc.send_signal(sig)
            m.proc.wait(timeout=20)

    def restart(self, index: int) -> SQLMember:
        """Replace a (dead or alive) member with a fresh process on new
        ports, reconnected to the same store plane."""
        if self.members[index].alive():
            self.kill(index, signal.SIGTERM)
        if self.members[index].proc is not None:
            self.members[index].proc.stdout.close()
        self.members[index] = self._spawn_sql(index)
        return self.members[index]

    # -- health + routing ----------------------------------------------------

    def health(self, index: int, timeout: float = 5.0) -> dict:
        """GET /status of one SQL member (the liveness probe)."""
        m = self.members[index]
        return statusclient.get_json(self.host, m.status_port,
                                     "/status", timeout=timeout)

    def wait_healthy(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        for i in range(len(self.members)):
            while True:
                try:
                    self.health(i)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"member {i} not healthy in {timeout}s")
                    time.sleep(0.1)

    def client(self, index: int | None = None, db: str = "",
               **kw):
        """A MiniClient (util/mysqlclient.py) to one member — round-robin
        over live members when `index` is None."""
        if index is None:
            live = [m for m in self.members if m.alive()]
            if not live:
                raise RuntimeError("no live SQL members")
            m = live[self._rr % len(live)]
            self._rr += 1
        else:
            m = self.members[index]
        return MiniClient(self.host, m.port, db=db, **kw)
