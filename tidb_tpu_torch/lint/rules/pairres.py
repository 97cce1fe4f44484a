"""Paired-resource dataflow: memtrack consume/release balance and
kernel dispatch/finalize pairing."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule
from tidb_tpu_torch.lint.flow import flow_of
from tidb_tpu_torch.lint.rules._shape import TRIVIAL_STMTS, release_try_follows

# the tracker implementation itself (its wrappers ARE the pairing) is
# out of scope; everything that CALLS it is in scope
_IMPL = "tidb_tpu_torch/memtrack.py"

# between a consume and its settling try, plain expression statements
# (logging, metrics bumps) are also tolerated — unlike a lock permit,
# a ledger charge outliving one of those by a raise is reclaimed by
# the statement root's detach, so the floor is deliberately softer
_SIMPLE = TRIVIAL_STMTS + (ast.Expr,)


def _terminal(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _kw(call: ast.Call) -> set:
    return {k.arg for k in call.keywords if k.arg}


def _is_consume(n) -> bool:
    return isinstance(n, ast.Call) and _terminal(n) == "consume" and \
        (_kw(n) & {"host", "device"})


def _is_release(n) -> bool:
    return isinstance(n, ast.Call) and _terminal(n) == "release" and \
        (_kw(n) & {"host", "device"})


def _releases_mem(stmts) -> bool:
    for s in stmts:
        for n in ast.walk(s):
            if _is_release(n):
                return True
    return False


@register_rule("paired-resource")
class PairedResourceRule(Rule):
    """memtrack consume must release on all paths (exceptions included);
    kernel dispatch() results must reach a finalize().

    A `consume(host=/device=)` charge that a raised exception can strand
    inflates the statement ledger until detach-on-close papers over it —
    and under per-query quotas an inflated ledger cancels INNOCENT
    statements. The sanctioned shapes, checked per top-level function
    (nested closures included):

      * the consume sits under a `try` whose `finally` releases (or is
        immediately followed by one, bar trivial assignments);
      * the consume lives in a nested closure of a pipeline whose
        driver releases in a `finally` (dispatch/finalize pairs split
        across closures — ops/runtime.pipeline_map's shape);
      * `memtrack.device_scope(...)` — balanced by construction.

    Deliberate cross-function ownership transfers (cache residency
    released on eviction, sorter buffers released on spill/drain) are
    audited drops: tag them `# lint: exempt[paired-resource] reason`.

    The dispatch leg: a function that calls `<kernel>.dispatch(` must
    also finalize — a dispatched future that never reaches
    `finalize()` silently drops its result AND its device-ledger
    release (every kernel's finalize path credits dispatch_nbytes
    back).
    """

    min_sites = 15

    fixture = (
        "from tidb_tpu_torch import memtrack\n"
        "def leak(plan, rows):\n"
        "    memtrack.consume(plan, host=64)\n"
        "    return rows\n"
        "def drop(kernel, chunk):\n"
        "    tok = kernel.dispatch(chunk)\n"
        "    return tok\n"
        "def drop_partition_loop(kernel, parts):\n"
        "    # the hybrid-join partition staging shape, abandoned:\n"
        "    # per-partition dispatches that never reach a finalize\n"
        "    toks = []\n"
        "    for p in parts:\n"
        "        toks.append(kernel.dispatch(p))\n"
        "    return toks\n"
        "class StagedStore:\n"
        "    # the delta store's stage->merge->release shape, UNtagged:\n"
        "    # bytes staged in one method and released in another are a\n"
        "    # cross-function ownership transfer the rule must flag\n"
        "    # unless the consume site carries the exempt tag\n"
        "    def stage(self, plan, part):\n"
        "        memtrack.consume(plan, host=32)\n"
        "        self.parts.append(part)\n"
        "    def merge(self, plan):\n"
        "        self.parts.clear()\n"
        "        memtrack.release(plan, host=32)\n"
    )

    def check(self, forest):
        fl = flow_of(forest)
        for fi in fl.graph.funcs.values():
            if fi.parent is not None or fi.rel == _IMPL:
                continue
            yield from self._check_toplevel(fi)

    def _check_toplevel(self, fi):
        subtree = list(ast.walk(fi.node))
        cross_release = any(
            isinstance(n, ast.Try) and _releases_mem(n.finalbody)
            for n in subtree)
        has_finalize = any(
            isinstance(n, ast.Call) and _terminal(n) == "finalize"
            for n in subtree)
        for n in subtree:
            if isinstance(n, ast.Call) and isinstance(n.func,
                                                      ast.Attribute) \
                    and n.func.attr == "dispatch":
                self.sites += 1
                if not has_finalize:
                    yield Finding(
                        fi.rel, n.lineno, self.name,
                        f"dispatch() result in {fi.qualname} never "
                        f"reaches a finalize() — the async future (and "
                        f"its device-ledger release) is dropped")
        yield from self._scan(fi, fi.node.body, False, False,
                              cross_release)

    def _scan(self, fi, stmts, protected, nested, cross_release):
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a closure's body runs at CALL time: the enclosing
                # try/finally protects its definition, not its charges
                yield from self._scan(fi, stmt.body, False, True,
                                      cross_release)
                continue
            if isinstance(stmt, ast.ClassDef):
                yield from self._scan(fi, stmt.body, False, nested,
                                      cross_release)
                continue
            if isinstance(stmt, ast.Try):
                prot = protected or _releases_mem(stmt.finalbody)
                yield from self._scan(fi, stmt.body, prot, nested,
                                      cross_release)
                for h in stmt.handlers:
                    yield from self._scan(fi, h.body, prot, nested,
                                          cross_release)
                yield from self._scan(fi, stmt.orelse, prot, nested,
                                      cross_release)
                yield from self._scan(fi, stmt.finalbody, protected,
                                      nested, cross_release)
                continue
            for block in ("body", "orelse", "finalbody"):
                if hasattr(stmt, block):
                    yield from self._scan(fi, getattr(stmt, block),
                                          protected, nested,
                                          cross_release)
            if isinstance(stmt, ast.Match):
                for case in stmt.cases:
                    yield from self._scan(fi, case.body, protected,
                                          nested, cross_release)
            for n in self._stmt_calls(stmt):
                if not _is_consume(n):
                    continue
                self.sites += 1
                if protected:
                    continue
                if self._release_try_follows(stmts, i + 1):
                    continue
                if nested and cross_release:
                    # pipeline shape: the charge is released by the
                    # driver's finally in this same top-level function
                    continue
                yield Finding(
                    fi.rel, n.lineno, self.name,
                    f"consume() in {fi.qualname} has no matching "
                    f"release on the exception path — wrap in "
                    f"try/finally (or memtrack.device_scope), or tag "
                    f"the deliberate ownership transfer")

    @staticmethod
    def _stmt_calls(stmt):
        """Calls in this statement's expression parts, not descending
        into sub-blocks (they are scanned as statements) or nested
        defs (they are scanned with nested=True)."""
        header: list = []
        if isinstance(stmt, (ast.If, ast.While)):
            header = [stmt.test]
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            header = [stmt.iter]
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            header = [it.context_expr for it in stmt.items]
        elif isinstance(stmt, ast.Match):
            header = [stmt.subject]
        elif isinstance(stmt, ast.Try):
            header = []
        else:
            header = [stmt]
        for e in header:
            for n in ast.walk(e):
                if isinstance(n, ast.Call):
                    yield n

    @staticmethod
    def _release_try_follows(stmts, j) -> bool:
        return release_try_follows(stmts, j, _releases_mem,
                                   trivial=_SIMPLE)
