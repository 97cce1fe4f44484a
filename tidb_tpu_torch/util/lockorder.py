"""Runtime lock-order sanitizer: the dynamic half of the lint suite's
whole-program concurrency analysis (tidb_tpu_torch/lint/flow).

The static side derives a lock acquisition-order DAG over every
`threading.Lock/RLock/Condition` construction site in the package,
named `<module>:<Class.>attr` (docs/CONCURRENCY_TORCH.md holds the
inventory). This module replays real executions against that DAG:

* `enable()` patches the `threading` Lock/RLock/Condition factories.
  While enabled, every such lock constructed AT A REGISTERED SITE
  (caller file:line is looked up in the registry — stdlib and
  test-local locks pass through untouched) comes back wrapped in a
  proxy that reports acquire and release to the sanitizer. Semaphores
  are registered statically but deliberately NOT wrapped: a permit is
  routinely released by a different thread than acquired it
  (admission tokens handed across the accept loop), so per-thread
  held-order tracking would fabricate edges — their orderings are
  covered by the static rule only.
* Each thread keeps its ordered held-lock list. Acquiring B while
  holding H observes the edge H -> B; the edge is checked against the
  union of the static DAG and everything observed so far, and any
  ordering that closes a cycle is recorded as a violation — the
  dynamic witness of a deadlock the static rule would call
  `lock-order`. A same-instance re-acquire of a non-reentrant lock
  raises immediately instead of hanging the suite.
* Same-NAME nested acquires of DISTINCT instances (the memtracker
  tree walking parent/child `_mu`s) are hierarchical locking the
  static names cannot order; they are skipped, mirroring the static
  analysis's reentrant-kind self-edge rule.

Gating: default OFF — zero production overhead. Turn it on with
`TIDB_TPU_LOCK_SANITIZER=1` in the environment (patched at
`import tidb_tpu_torch`, so per-object locks constructed after that are
tracked) or the `sanitize()` context manager, which is how
tests/test_torch_race_harness.py runs: the race harness stress-executes the
store paths under the sanitizer, so the dynamic run validates the
static model and the static DAG gives the dynamic run its oracle.

Limitations, by design: locks constructed BEFORE enabling (module
globals of already-imported modules) are not wrapped, and the checker
sees only orders the workload actually executes — it is a sanitizer,
not a prover. The prover half is `python -m tidb_tpu_torch.lint --rule
lock-order`.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from dataclasses import dataclass

__all__ = ["LockOrderError", "Violation", "LockOrderSanitizer",
           "static_dag", "enable", "disable", "sanitize", "active"]

_REENTRANT = frozenset({"RLock", "Condition", "Semaphore"})


class LockOrderError(AssertionError):
    """Raised for orderings the DAG forbids (see Violation list)."""


@dataclass(frozen=True)
class Violation:
    kind: str            # "cycle" | "self-deadlock"
    edge: tuple          # (held name, acquired name)
    thread: str
    detail: str

    def __str__(self):
        return f"[{self.kind}] {self.edge[0]} -> {self.edge[1]} " \
               f"on {self.thread}: {self.detail}"


@dataclass
class _Held:
    proxy: object
    name: str
    count: int = 1


class _TrackedLock:
    """Proxy over a real Lock/RLock: context-manager + acquire/release
    + locked(), reporting transitions to the sanitizer."""

    __slots__ = ("_inner", "_lo_name", "_lo_kind", "_san")

    def __init__(self, inner, name: str, kind: str, san):
        self._inner = inner
        self._lo_name = name
        self._lo_kind = kind
        self._san = san

    def acquire(self, *a, **kw):
        blocking = a[0] if a else kw.get("blocking", True)
        timeout = a[1] if len(a) > 1 else kw.get("timeout", -1)
        if blocking and timeout == -1:
            # plain blocking acquire: note at ATTEMPT time — a real
            # deadlock would hang before success, and the self-deadlock
            # check must fire before the hang
            self._san.note_acquire(self)
            return self._inner.acquire(*a, **kw)
        # trylock / timed form: deliberate deadlock AVOIDANCE — a miss
        # must record nothing (the program backed off exactly so this
        # ordering would not happen)
        got = self._inner.acquire(*a, **kw)
        if got:
            self._san.note_acquire(self)
        return got

    def release(self):
        self._san.note_release(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<sanitized {self._lo_kind} {self._lo_name}>"


class _TrackedCondition(_TrackedLock):
    """Condition proxy: wait/notify delegate to the inner condition,
    with the held entry popped around wait()'s internal release and
    re-checked on re-acquisition."""

    __slots__ = ()

    def wait(self, timeout=None):
        self._san.note_release(self)
        try:
            return self._inner.wait(timeout)
        finally:
            self._san.note_acquire(self)

    def wait_for(self, predicate, timeout=None):
        self._san.note_release(self)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._san.note_acquire(self)

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()

    def locked(self):
        return self._inner._lock.locked()


class LockOrderSanitizer:
    """Order checker over the statically-derived DAG (dag_export() of
    tidb_tpu_torch/lint/flow/analysis.py)."""

    def __init__(self, dag: dict):
        self.sites = dict(dag.get("sites", {}))
        self.kinds = dict(dag.get("kinds", {}))
        self._mu = threading.Lock()
        self.observed: set = set()      # guarded-by: _mu
        self.violations: list[Violation] = []   # guarded-by: _mu
        self.acquires = 0               # guarded-by: _mu  (tracked ops)
        # adjacency over the union of static + observed edges
        self._adj: dict = {}            # guarded-by: _mu
        for a, b in dag.get("edges", ()):
            self._adj.setdefault(a, set()).add(b)
        self._tls = threading.local()

    # -- per-thread held list ------------------------------------------------

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def note_acquire(self, proxy) -> None:
        held = self._held()
        name = proxy._lo_name
        for h in held:
            if h.proxy is proxy:
                if proxy._lo_kind in _REENTRANT:
                    h.count += 1
                    return
                v = Violation(
                    "self-deadlock", (name, name),
                    threading.current_thread().name,
                    "non-reentrant lock re-acquired by its holder — "
                    "this blocks forever; raising instead of hanging")
                with self._mu:
                    self.violations.append(v)
                raise LockOrderError(str(v))
        with self._mu:
            self.acquires += 1
            for h in held:
                if h.name != name:      # same-name = hierarchy, skip
                    self._check_edge_locked(h.name, name)
        held.append(_Held(proxy, name))

    def note_release(self, proxy) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].proxy is proxy:
                held[i].count -= 1
                if held[i].count == 0:
                    del held[i]
                return
        # releasing a lock this thread never tracked (e.g. acquired
        # before enable, or cross-thread release): nothing to unwind

    # -- the DAG check -------------------------------------------------------

    def _check_edge_locked(self, src: str, dst: str) -> None:
        if (src, dst) in self.observed:
            return
        if self._reaches(dst, src):
            self.violations.append(Violation(
                "cycle", (src, dst), threading.current_thread().name,
                f"acquiring {dst} while holding {src} closes a cycle: "
                f"the DAG (static edges + observed orders) already "
                f"requires {dst} before {src}"))
            return                      # don't poison the graph
        self.observed.add((src, dst))
        self._adj.setdefault(src, set()).add(dst)

    def _reaches(self, src: str, dst: str) -> bool:
        seen = {src}
        frontier = [src]
        while frontier:
            node = frontier.pop()
            if node == dst:
                return True
            for nxt in self._adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return False

    # -- wrapping ------------------------------------------------------------

    def wrap(self, inner, name: str, kind: str = "Lock"):
        """Explicitly wrap a lock under a registry name (tests; code
        paths that want tracking without factory patching)."""
        cls = _TrackedCondition if kind == "Condition" else _TrackedLock
        return cls(inner, name, kind, self)

    def site(self, filename: str, lineno: int):
        """Registry entry for a construction site, or None."""
        rel = os.path.relpath(filename, _REPO)
        return self.sites.get((rel, lineno))


# -- factory patching --------------------------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_active: LockOrderSanitizer | None = None
_originals: dict = {}


def active() -> LockOrderSanitizer | None:
    return _active


def _factory(orig, kind):
    def make(*args, **kwargs):
        inner = orig(*args, **kwargs)
        san = _active
        if san is None:
            return inner
        frame = sys._getframe(1)
        hit = san.site(frame.f_code.co_filename, frame.f_lineno)
        if hit is None:
            return inner
        name, _site_kind = hit
        return san.wrap(inner, name, kind)
    make._lockorder_patch = True
    return make


def static_dag() -> dict:
    """The statically-derived order DAG (one forest parse + flow
    analysis, cached for the process)."""
    global _dag_cache
    if _dag_cache is None:
        from tidb_tpu_torch.lint.engine import Forest
        from tidb_tpu_torch.lint.flow import flow_of
        _dag_cache = flow_of(Forest.load()).dag_export()
    return _dag_cache


_dag_cache: dict | None = None


def enable(dag: dict | None = None) -> LockOrderSanitizer:
    """Patch the threading factories; idempotent while enabled."""
    global _active
    if _active is not None:
        return _active
    san = LockOrderSanitizer(static_dag() if dag is None else dag)
    for attr, kind in (("Lock", "Lock"), ("RLock", "RLock"),
                       ("Condition", "Condition")):
        _originals[attr] = getattr(threading, attr)
        setattr(threading, attr, _factory(_originals[attr], kind))
    _active = san
    return san


def disable() -> None:
    global _active
    if _active is None:
        return
    for attr, orig in _originals.items():
        setattr(threading, attr, orig)
    _originals.clear()
    _active = None


@contextlib.contextmanager
def sanitize(dag: dict | None = None):
    """Enable for a scope; raise LockOrderError on exit if any ordering
    observed WITHIN the scope contradicted the DAG.

    If a sanitizer is already active (the env gate, or an outer
    sanitize()), the scope joins it instead of replacing it: `dag` is
    ignored, the factories stay patched on exit, and only violations
    that appeared during this scope are raised — pre-existing ones
    belong to whoever enabled it."""
    created = _active is None
    san = enable(dag)
    base = len(san.violations)
    try:
        yield san
    finally:
        if created:
            disable()
    fresh = san.violations[base:]
    if fresh:
        raise LockOrderError(
            "lock-order sanitizer: %d violation(s):\n%s" % (
                len(fresh), "\n".join(str(v) for v in fresh)))


def enable_from_env() -> LockOrderSanitizer | None:
    """`TIDB_TPU_LOCK_SANITIZER=1` turns the sanitizer on at package
    import (tidb_tpu_torch/__init__.py calls this). Anything else: no-op."""
    if os.environ.get("TIDB_TPU_LOCK_SANITIZER", "0") != "1":
        return None
    return enable()
