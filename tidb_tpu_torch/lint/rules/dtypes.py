"""Device dtype discipline: no 64-bit device-tensor construction in ops/
without an explicit, justified exemption."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

_SCAN_DIR = "tidb_tpu_torch/ops/"
_CONSTRUCT = ("empty", "zeros", "ones", "full", "full_like",
              "zeros_like", "ones_like", "empty_like", "arange",
              "as_tensor", "tensor", "to", "astype")
_HOSTILE = ("int64", "float64", "long", "double")
# the 64-bit cast methods: x.long() / x.double()
_CASTS = ("long", "double")


def _hostile_dtype(call: ast.Call) -> str | None:
    """'torch.int64'/'torch.float64' (or the long/double aliases) if any
    argument pins a 64-bit device dtype, else None. Only torch-rooted
    dtypes count: host-side numpy int64 lanes are the SQL-exactness
    representation and are uploaded as they are, by the audited
    transfer (runtime.put_lanes)."""
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        for n in ast.walk(arg):
            if isinstance(n, ast.Attribute) and n.attr in _HOSTILE and \
                    isinstance(n.value, ast.Name) and \
                    n.value.id == "torch":
                return f"torch.{n.attr}"
    return None


@register_rule("dtype-discipline")
class DtypeDisciplineRule(Rule):
    """No torch.int64 / torch.float64 tensor construction (or a
    .long() / .double() cast) in ops/ without an exempt tag naming why
    the 64-bit lanes are required.

    The H100 has no 64-bit integer ALU path: int64 arithmetic lowers to
    multi-instruction 32-bit sequences, float64 runs at a fraction of
    the float32 rate, and both double every lane's HBM bytes — the
    resource a memory-bound scan kernel is timed against. The kernels
    that genuinely need exactness (scaled-decimal sums, memcomparable
    key codes, bitcast hashing) declare it with a per-site or
    per-function `# lint: exempt[dtype-discipline] reason` so every
    64-bit device buffer in ops/ is a documented decision, not an
    accident.
    """

    fixture_rel = "tidb_tpu_torch/ops/__lint_fixture__.py"
    fixture = (
        "import torch\n"
        "def slots(n):\n"
        "    return torch.zeros(n, dtype=torch.int64)\n"
    )

    def check(self, forest):
        for pf in forest:
            if not pf.rel.startswith(_SCAN_DIR):
                continue
            for node in pf.nodes:
                if not (isinstance(node, ast.Call) and
                        isinstance(node.func, ast.Attribute)):
                    continue
                attr = node.func.attr
                if attr in _CASTS and not node.args:
                    self.sites += 1
                    hostile = f".{attr}()"
                elif attr in _CONSTRUCT:
                    self.sites += 1
                    hostile = _hostile_dtype(node)
                else:
                    continue
                if hostile is None:
                    continue
                yield Finding(
                    pf.rel, node.lineno, self.name,
                    f"{attr} with {hostile}: 64-bit device dtype (int64 "
                    f"arithmetic is emulated on the SMs, and the lane "
                    f"doubles its HBM bytes) — narrow at the device "
                    f"boundary, or justify it with "
                    f"'# lint: exempt[dtype-discipline] <reason>'")
