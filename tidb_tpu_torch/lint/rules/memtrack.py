"""Memory-accounting discipline (port of tests/test_lint_memtrack.py).

The old walker consulted the `memtrack.AUDITED_HELPERS` function
registry plus an ad-hoc ``# memtrack: exempt`` tag; both conventions now
ride the uniform suppression syntax — a ``# lint: exempt[memtrack-alloc]
reason`` directly above a `def` covers the whole helper (the registry's
successor, kept honest by the engine's unused-suppression check), and
the legacy tag spelling keeps working as a registered alias.
"""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.astutil import enclosing_map
from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

SCAN_DIRS = ("tidb_tpu_torch/executor/", "tidb_tpu_torch/ops/")
ALLOC_FNS = ("empty", "zeros", "concatenate")
CONST_MAX = 4096


def _const_size(arg):
    """Statically-known element count of a size argument, else None."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, int):
        return arg.value
    if isinstance(arg, (ast.Tuple, ast.List)):
        prod = 1
        for el in arg.elts:
            if not (isinstance(el, ast.Constant) and
                    isinstance(el.value, int)):
                return None
            prod *= el.value
        return prod
    return None


def _is_bool_dtype(call) -> bool:
    cands = [kw.value for kw in call.keywords if kw.arg == "dtype"]
    if len(call.args) > 1:
        cands.append(call.args[1])
    return any(isinstance(c, ast.Name) and c.id == "bool" for c in cands)


def _below_threshold(call) -> bool:
    if not call.args:
        return True                     # no size: nothing to bound
    size = _const_size(call.args[0])
    if size is not None and size <= CONST_MAX:
        return True
    return _is_bool_dtype(call)


@register_rule("memtrack-alloc")
class MemtrackAllocRule(Rule):
    """Every data-sized numpy allocation in executor/ and ops/ is
    covered by memtrack accounting or carries an explicit exemption.

    np.empty / np.zeros / np.concatenate whose size scales with input
    data must either live inside an exempted helper (its bytes are
    billed by the function's owner, directly or through its caller) or
    carry a per-line exempt tag — a new operator buffering rows without
    billing a tracker fails this rule instead of silently bypassing
    per-query accounting. Auto-exempt below-threshold sites: constant
    sizes <= 4096 elements, and bool masks (1 byte/row, an order of
    magnitude below the column payloads the trackers bound).
    """

    aliases = ("# memtrack: exempt",)
    min_sites = 30      # the scan must actually see the alloc sites
    fixture_rel = "tidb_tpu_torch/executor/__lint_fixture__.py"
    fixture = (
        "import numpy as np\n"
        "def buffer_rows(n):\n"
        "    return np.empty(n, dtype=np.int64)\n"
    )

    def check(self, forest):
        for pf in forest:
            if not pf.rel.startswith(SCAN_DIRS):
                continue
            enclosing = None    # built on first finding only
            for node in pf.nodes:
                if not (isinstance(node, ast.Call) and
                        isinstance(node.func, ast.Attribute) and
                        node.func.attr in ALLOC_FNS and
                        isinstance(node.func.value, ast.Name) and
                        node.func.value.id == "np"):
                    continue
                self.sites += 1
                if _below_threshold(node):
                    continue
                if enclosing is None:
                    enclosing = enclosing_map(pf.tree)
                qual = enclosing(node.lineno) or "<module>"
                yield Finding(
                    pf.rel, node.lineno, self.name,
                    f"data-sized np.{node.func.attr} in {qual} without "
                    f"memtrack accounting — bill a tracker node or tag "
                    f"'# lint: exempt[memtrack-alloc] <reason>'")
