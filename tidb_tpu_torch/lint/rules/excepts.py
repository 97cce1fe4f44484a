"""Exception-swallowing discipline for the execution and storage
layers."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

_SCAN_DIRS = ("tidb_tpu_torch/executor/", "tidb_tpu_torch/ops/",
              "tidb_tpu_torch/store/")


def _is_bare(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    t = handler.type
    return isinstance(t, ast.Name) and t.id == "BaseException"


def _reraises(handler: ast.ExceptHandler) -> bool:
    """True if the handler contains a raise that can actually
    propagate: not one swallowed by a nested try, and not one inside a
    nested def that merely defines (doesn't run) it."""

    def scan(stmts) -> bool:
        for s in stmts:
            if isinstance(s, ast.Raise):
                return True
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(s, ast.Try):
                # raises in the inner body may be caught there — unless
                # the try has no except clauses (pure try/finally, the
                # canonical cleanup-then-raise shape); raises in its
                # handlers / orelse / finally escape the handler
                if not s.handlers and scan(s.body):
                    return True
                if scan(s.orelse) or scan(s.finalbody) or \
                        any(scan(h.body) for h in s.handlers):
                    return True
            elif isinstance(s, (ast.If, ast.While, ast.For,
                                ast.AsyncFor)):
                if scan(s.body) or scan(s.orelse):
                    return True
            elif isinstance(s, (ast.With, ast.AsyncWith)):
                if scan(s.body):
                    return True
            elif isinstance(s, ast.Match):
                if any(scan(c.body) for c in s.cases):
                    return True
        return False

    return scan(handler.body)


@register_rule("bare-except")
class BareExceptRule(Rule):
    """No `except:` / `except BaseException:` that swallows in
    executor/, ops/ and store/.

    A blanket handler in these layers eats KeyboardInterrupt, the
    cooperative-kill QuotaExceededError, and the typed storage errors
    the retry machinery classifies — turning a cancelled query into
    silently-wrong results. Catching BaseException is sanctioned only
    as a cleanup-then-`raise` shape (release a ledger, then re-raise);
    a handler with no raise must name the exceptions it really means.
    """

    fixture_rel = "tidb_tpu_torch/store/__lint_fixture__.py"
    fixture = (
        "def f(work):\n"
        "    try:\n"
        "        work()\n"
        "    except BaseException:\n"
        "        return None\n"
    )

    def check(self, forest):
        for pf in forest:
            if not pf.rel.startswith(_SCAN_DIRS):
                continue
            for node in pf.nodes:
                if not isinstance(node, ast.ExceptHandler):
                    continue
                self.sites += 1
                if _is_bare(node) and not _reraises(node):
                    what = "bare except" if node.type is None else \
                        "except BaseException"
                    yield Finding(
                        pf.rel, node.lineno, self.name,
                        f"{what} without re-raise swallows "
                        f"KeyboardInterrupt, quota cancellation and "
                        f"typed storage errors — name the exceptions, "
                        f"or clean up and `raise`")
