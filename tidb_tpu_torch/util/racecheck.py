"""Race-detection harness for the threaded store/DDL paths.

The reference leans on Go's -race (Makefile:124). CPython has no
equivalent sanitizer; what catches the same bug class in practice is
maximizing thread interleavings while asserting SEMANTIC invariants
(no lost updates, monotonic TSO, one unique-insert winner...):
`stress()` drops the interpreter's switch interval to its floor — the
standard CPython trick for surfacing races — and
tests/test_torch_race_harness.py runs the store workloads under it.
"""

from __future__ import annotations

import contextlib
import sys

__all__ = ["stress"]


@contextlib.contextmanager
def stress(interval: float = 1e-6):
    """Minimize the GIL switch interval to maximize interleavings."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(interval)
    try:
        yield
    finally:
        sys.setswitchinterval(old)
