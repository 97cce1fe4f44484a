"""MySQL error-code discipline: codes come from errcode.py, never from
integer literals at raise sites."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.astutil import call_name
from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

# call shapes that put an error code on the client-visible wire
_SINKS = ("SQLError", "add_warning")
_CODE_LO, _CODE_HI = 1000, 9999


@register_rule("errcode-discipline")
class ErrcodeDisciplineRule(Rule):
    """SQLError / add_warning never take an integer-literal error code —
    use the named constants of errcode.py.

    errcode.py is the single catalog mapping the framework's errors
    onto the MySQL wire codes drivers switch on (1062 duplicate key,
    8175 mem quota, 9xxx retryable storage). A literal `1051` at a
    raise site is invisible to that catalog: it can't be audited for
    retryability classification, and a typo ships a wrong code straight
    to clients.
    """

    fixture = (
        "from tidb_tpu_torch.session import SQLError\n"
        "def f():\n"
        "    raise SQLError(1064, 'syntax error')\n"
    )

    def check(self, forest):
        for pf in forest:
            for node in pf.nodes:
                if not (isinstance(node, ast.Call) and
                        call_name(node) in _SINKS):
                    continue
                self.sites += 1
                args = list(node.args) + [kw.value for kw in node.keywords]
                for arg in args:
                    if isinstance(arg, ast.Constant) and \
                            isinstance(arg.value, int) and \
                            not isinstance(arg.value, bool) and \
                            _CODE_LO <= arg.value <= _CODE_HI:
                        yield Finding(
                            pf.rel, node.lineno, self.name,
                            f"{call_name(node)} with integer-literal "
                            f"code {arg.value} — use the named constant "
                            f"from errcode.py so the catalog stays the "
                            f"single source of wire codes")
