"""Lock acquisition discipline for the concurrency-bearing layers."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule
from tidb_tpu_torch.lint.rules._shape import release_try_follows

SCAN = ("tidb_tpu_torch/memtrack.py", "tidb_tpu_torch/metrics.py",
        "tidb_tpu_torch/session/", "tidb_tpu_torch/store/")


def _releases(stmts) -> bool:
    for s in stmts:
        for n in ast.walk(s):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr == "release":
                return True
    return False


def _acquires(expr):
    for n in ast.walk(expr):
        if isinstance(n, ast.Call) and \
                isinstance(n.func, ast.Attribute) and \
                n.func.attr == "acquire":
            yield n


_WAITERS = ("wait", "wait_for", "notify", "notify_all")


def _condition_names(pf) -> set:
    """Attributes / globals assigned `threading.Condition(...)` in this
    file — the receivers whose wait/notify calls the rule checks (an
    Event.wait or Thread.join must not false-positive)."""
    out = set()
    for n in pf.nodes:
        if isinstance(n, (ast.Assign, ast.AnnAssign)) and \
                isinstance(getattr(n, "value", None), ast.Call):
            fn = n.value.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else None
            if name != "Condition":
                continue
            targets = n.targets if isinstance(n, ast.Assign) \
                else [n.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
                elif isinstance(t, ast.Attribute):
                    out.add(t.attr)
    return out


def _receiver_name(expr) -> str | None:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


@register_rule("lock-discipline")
class LockDisciplineRule(Rule):
    """No bare .acquire() outside `with` / try-finally, and no
    Condition wait/notify outside `with cond:`, in memtrack.py,
    metrics.py, session/ and store/.

    A lock or semaphore acquired without an immediately-following
    try/finally release leaks on the first exception between acquire
    and release — and in these layers (the memory-tracker tree, the
    metrics registry, session statement lifecycle, the connection-pool
    semaphores) a leaked permit deadlocks the process quietly. The
    sanctioned shape is `with lock:` or `x.acquire()` followed (bar
    trivial assignments) by `try: ... finally: x.release()` — the
    assign form `got = x.acquire(timeout=...)` ahead of the try/finally
    included; an acquire already inside a try whose finally releases
    also passes. RLocks are held to the same shape: reentrancy forgives
    double-acquire, not a leak on the exception path.

    The Condition leg: `cond.wait()` / `cond.notify()` /
    `cond.notify_all()` on a `threading.Condition` constructed in the
    same file must sit lexically inside `with cond:` — calling either
    without the underlying lock raises RuntimeError at the worst
    possible time (under load, on the signaling path).
    """

    fixture_rel = "tidb_tpu_torch/store/__lint_fixture__.py"
    fixture = (
        "import threading\n"
        "_lock = threading.Lock()\n"
        "def f(work):\n"
        "    _lock.acquire()\n"
        "    work()\n"
        "    _lock.release()\n"
    )

    def check(self, forest):
        for pf in forest:
            if not (pf.rel in SCAN[:2] or pf.rel.startswith(SCAN[2:])):
                continue
            self._conds = _condition_names(pf)
            yield from self._block(pf, pf.tree.body, False, ())

    def _finding(self, pf, node):
        return Finding(
            pf.rel, node.lineno, self.name,
            "bare .acquire() outside with/try-finally — a raise before "
            "the matching release leaks the permit; acquire, then "
            "`try: ... finally: release()` (or use `with`)")

    def _wait_finding(self, pf, call):
        return Finding(
            pf.rel, call.lineno, self.name,
            f"Condition.{call.func.attr}() outside `with` of its "
            f"condition — raises RuntimeError('cannot ... un-acquired "
            f"lock') on the signaling path; wrap in `with cond:`")

    def _header(self, pf, exprs, protected, withs):
        for expr in exprs:
            if expr is None:
                continue
            for call in _acquires(expr):
                self.sites += 1
                if not protected:
                    yield self._finding(pf, call)
            for n in ast.walk(expr):
                if isinstance(n, ast.Call) and \
                        isinstance(n.func, ast.Attribute) and \
                        n.func.attr in _WAITERS and \
                        _receiver_name(n.func.value) in self._conds:
                    self.sites += 1
                    if ast.dump(n.func.value) not in withs:
                        yield self._wait_finding(pf, n)

    def _block(self, pf, stmts, protected, withs):
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                yield from self._block(pf, stmt.body, False, ())
            elif isinstance(stmt, ast.Try):
                prot = protected or _releases(stmt.finalbody)
                yield from self._block(pf, stmt.body, prot, withs)
                for h in stmt.handlers:
                    yield from self._block(pf, h.body, prot, withs)
                yield from self._block(pf, stmt.orelse, prot, withs)
                yield from self._block(pf, stmt.finalbody, protected,
                                       withs)
            elif isinstance(stmt, (ast.If, ast.While)):
                yield from self._header(pf, [stmt.test], protected, withs)
                yield from self._block(pf, stmt.body, protected, withs)
                yield from self._block(pf, stmt.orelse, protected, withs)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                yield from self._header(pf, [stmt.iter], protected, withs)
                yield from self._block(pf, stmt.body, protected, withs)
                yield from self._block(pf, stmt.orelse, protected, withs)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from self._header(
                    pf, [it.context_expr for it in stmt.items],
                    protected, withs)
                inner = withs + tuple(
                    ast.dump(it.context_expr) for it in stmt.items)
                yield from self._block(pf, stmt.body, protected, inner)
            elif isinstance(stmt, ast.Match):
                yield from self._header(pf, [stmt.subject], protected,
                                        withs)
                for case in stmt.cases:
                    yield from self._block(pf, case.body, protected,
                                           withs)
            elif isinstance(stmt, (ast.Expr, ast.Assign, ast.AnnAssign)) \
                    and isinstance(getattr(stmt, "value", None),
                                   ast.Call) and \
                    isinstance(stmt.value.func, ast.Attribute) and \
                    stmt.value.func.attr == "acquire":
                # canonical statement forms: `x.acquire()` and
                # `got = x.acquire(timeout=...)` ahead of try/finally
                self.sites += 1
                if not (protected or
                        self._release_try_follows(stmts, i + 1)):
                    yield self._finding(pf, stmt.value)
            else:
                yield from self._header(pf, [stmt], protected, withs)

    @staticmethod
    def _release_try_follows(stmts, j) -> bool:
        """Skip trivial assignments, then require try/finally-release
        (the shared sequence-shape recognizer, rules/_shape.py)."""
        return release_try_follows(stmts, j, _releases)
