"""Device-plane import discipline: package code addresses the unified
plane directly; tidb_tpu_torch.parallel exists only as compatibility shims."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

_SHIM_PKG = "tidb_tpu_torch/parallel/"
_LEGACY = "tidb_tpu_torch.parallel"
# the unified plane modules package code imports instead; counting
# their in-tree import sites is the vacuity floor — a refactor that
# renames the plane out from under this rule fails loudly instead of
# hollowing it out
_PLANE = ("tidb_tpu_torch.devplane", "tidb_tpu_torch.ops.meshagg",
          "tidb_tpu_torch.ops.meshjoin", "tidb_tpu_torch.ops.meshshuffle")


@register_rule("no-parallel-import")
class NoParallelImportRule(Rule):
    """Package code (outside the tidb_tpu_torch/parallel/ shims themselves)
    never imports tidb_tpu_torch.parallel.

    The unified device plane — tidb_tpu_torch/devplane.py plus
    ops/meshagg.py / ops/meshjoin.py / ops/meshshuffle.py — is the real
    module set; the parallel package is a frozen compatibility surface
    kept for historical import paths (tests, external callers). A
    package-internal import of a shim re-couples new code to the
    retired layer, hides the true dependency graph, and quietly
    resurrects the split-world execution paths this refactor removed.
    """

    min_sites = 4   # the plane modules really are imported in-package
    fixture = (
        "from tidb_tpu_torch.parallel import MeshAggKernel\n"
        "def run(mesh, ch):\n"
        "    return MeshAggKernel(mesh, None, [], [])(ch)\n"
    )

    def check(self, forest):
        for pf in forest:
            in_shim = pf.rel.startswith(_SHIM_PKG)
            for node in pf.nodes:
                cands = self._candidates(node)
                if not cands:
                    continue
                legacy = [c for c in cands
                          if c == _LEGACY or
                          c.startswith(_LEGACY + ".")]
                if legacy:
                    self.sites += 1
                    if in_shim:
                        continue    # the shims may reference themselves
                    yield Finding(
                        pf.rel, node.lineno, self.name,
                        f"import of the legacy {_LEGACY} shim package "
                        f"from package code — import the unified device "
                        f"plane (tidb_tpu_torch.devplane, or "
                        f"tidb_tpu_torch.ops.meshagg / meshjoin / "
                        f"meshshuffle) directly")
                elif any(c in _PLANE for c in cands):
                    self.sites += 1     # vacuity floor: plane imports

    @staticmethod
    def _candidates(node) -> list:
        """Dotted module paths an import statement could bind: for
        ``from a.b import c`` both ``a.b`` and ``a.b.c`` (the latter
        catches ``from tidb_tpu_torch import parallel``)."""
        if isinstance(node, ast.Import):
            return [a.name for a in node.names]
        if isinstance(node, ast.ImportFrom) and node.module:
            return [node.module] + \
                [node.module + "." + a.name for a in node.names]
        return []
