"""Failpoint registry discipline: the declared table and the eval sites
track each other (same shape as the metric-names rule)."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

_FAILPOINT = "tidb_tpu_torch/util/failpoint.py"


def declared_points(pf) -> dict[str, int]:
    """String keys of failpoint.py's module-level REGISTRY dict
    -> lineno."""
    out = {}
    for node in pf.tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        if len(targets) == 1 and isinstance(targets[0], ast.Name) and \
                targets[0].id == "REGISTRY" and \
                isinstance(node.value, ast.Dict):
            for key in node.value.keys:
                if isinstance(key, ast.Constant) and \
                        isinstance(key.value, str):
                    out[key.value] = key.lineno
    return out


def _eval_calls(pf):
    """failpoint.eval(...) / failpoint.enable(...) / .disable(...)
    where the receiver is the failpoint module. enable/disable sites
    matter too: arming a typo'd name in package code would raise only
    on the path that was never tested."""
    for node in pf.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and \
                fn.attr in ("eval", "enable", "disable") and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id == "failpoint":
            yield node, fn.attr


@register_rule("failpoint-discipline")
class FailpointDisciplineRule(Rule):
    """Every failpoint.eval()/enable()/disable() call site names a
    point declared in failpoint.REGISTRY, as a string literal; and
    every declared point is evaluated by at least one in-tree seam.

    The registry table is the operator-facing fault catalog
    (docs/ROBUSTNESS.md, GET /failpoint): an eval of an undeclared
    name is a seam chaos tooling can never arm (it silently never
    fires), and a declared name with no eval site is catalog fiction —
    an operator arming it would believe a fault was injected when
    nothing can fire it.
    """

    min_sites = 8       # the instrumented seams across the device plane
    fixture = (
        "from tidb_tpu_torch.util import failpoint\n"
        "def f():\n"
        "    failpoint.eval('not/declared')\n"
    )
    fixture_support = {
        _FAILPOINT: 'REGISTRY = {"hbm/fill": "device cache upload"}\n',
    }

    def check(self, forest):
        decl_pf = forest.get(_FAILPOINT)
        if decl_pf is None:
            yield Finding(_FAILPOINT, 1, self.name,
                          "util/failpoint.py missing from the forest — "
                          "the failpoint registry is gone")
            return
        declared = declared_points(decl_pf)
        if not declared:
            yield Finding(_FAILPOINT, 1, self.name,
                          "failpoint.py lost its REGISTRY table")
            return
        evaluated: set[str] = set()
        for pf in forest:
            if pf.rel == _FAILPOINT:
                continue    # the registry module's own helpers
            for call, kind in _eval_calls(pf):
                self.sites += 1
                arg = call.args[0] if call.args else None
                if not (isinstance(arg, ast.Constant) and
                        isinstance(arg.value, str)):
                    yield Finding(
                        pf.rel, call.lineno, self.name,
                        f"failpoint.{kind} must name its point with a "
                        f"string literal (computed names defeat the "
                        f"registry audit)")
                    continue
                if arg.value not in declared:
                    yield Finding(
                        pf.rel, call.lineno, self.name,
                        f"failpoint.{kind}({arg.value!r}) names a point "
                        f"not declared in failpoint.REGISTRY — declare "
                        f"it (one table, docs/ROBUSTNESS.md catalog)")
                    continue
                if kind == "eval":
                    evaluated.add(arg.value)
        for name, lineno in sorted(declared.items()):
            if name not in evaluated:
                yield Finding(
                    _FAILPOINT, lineno, self.name,
                    f"failpoint {name!r} is declared but no in-tree "
                    f"seam evaluates it — dead catalog entry (arming "
                    f"it can never fire)")
