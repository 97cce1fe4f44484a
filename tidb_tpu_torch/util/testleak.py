"""Thread-leak detection for tests.

Reference: TiDB's util/testleak/leaktest.go — AfterTest
snapshots goroutines and fails a test that leaves new ones running,
with an allowlist for long-lived infrastructure. Python analogue over
threading.enumerate(): long-lived daemon loops this framework starts
deliberately (schema/stats workers, server accept loops, status HTTP)
are allowlisted by thread name; anything else left running after a test
is a leak."""

from __future__ import annotations

import threading
import time

__all__ = ["snapshot", "check", "ALLOWED_PREFIXES"]

# deliberate long-lived loops (started once, daemon, never joined)
ALLOWED_PREFIXES = (
    "MainThread", "pytest", "schema-worker", "stats-worker",
    "stats-auto-analyze", "storage-accept", "storage-conn",
    "status-http", "server-accept", "x-server", "gc-worker",
    "ThreadPoolExecutor", "delta-merge", "dispatch-watchdog",
    "metrics-history",
)


def _interesting(t: threading.Thread) -> bool:
    if not t.is_alive():
        return False
    return not any(t.name.startswith(p) for p in ALLOWED_PREFIXES)


def snapshot() -> set[str]:
    """Names of live, non-allowlisted threads."""
    return {t.name for t in threading.enumerate() if _interesting(t)}


def check(before: set[str], timeout: float = 2.0) -> list[str]:
    """-> names of threads alive now but not in `before`, after giving
    short-lived workers `timeout` seconds to drain (the reference polls
    the same way, leaktest.go checkLeakAfterTest)."""
    deadline = time.time() + timeout
    while True:
        leaked = sorted(snapshot() - before)
        if not leaked or time.time() >= deadline:
            return leaked
        time.sleep(0.05)
