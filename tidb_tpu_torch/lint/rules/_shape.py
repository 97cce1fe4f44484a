"""Statement-shape recognizers shared by more than one rule — one
implementation so pairing semantics cannot drift between rules."""

from __future__ import annotations

import ast

# statements allowed between a resource charge and the try/finally
# that settles it: bindings that cannot re-enter the resource
TRIVIAL_STMTS = (ast.Assign, ast.AnnAssign, ast.AugAssign)


def release_try_follows(stmts, j, releases,
                        trivial=TRIVIAL_STMTS) -> bool:
    """The sanctioned sequence shape: after skipping `trivial`
    statements from stmts[j], the next statement is a `try` whose
    finalbody satisfies `releases` (a predicate over the statement
    list — lock-discipline looks for `.release()`, paired-resource for
    ledger `release(host=/device=)` calls)."""
    while j < len(stmts) and isinstance(stmts[j], trivial):
        j += 1
    return j < len(stmts) and isinstance(stmts[j], ast.Try) and \
        releases(stmts[j].finalbody)
