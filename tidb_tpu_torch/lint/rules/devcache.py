"""Device-cache upload discipline: region columns reach HBM only through
the audited upload helper."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

_SCOPES = ("tidb_tpu_torch/store/", "tidb_tpu_torch/executor/")
_AUDITED = "tidb_tpu_torch/store/device_cache.py"
_UPLOADS = ("device_put_chunk", "put_lanes")
_FACTORIES = ("as_tensor", "tensor", "from_numpy")


def _names_device(expr) -> bool:
    """A `.to(...)` target that is a device, not a dtype: a name or
    attribute spelling a device, or a 'cuda...' string."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and \
            expr.value.startswith("cuda")
    for n in ast.walk(expr):
        ident = n.id if isinstance(n, ast.Name) else \
            n.attr if isinstance(n, ast.Attribute) else None
        if ident is not None and "dev" in ident.lower():
            return True
    return False


@register_rule("device-cache")
class DeviceCacheRule(Rule):
    """In store/ and executor/, host->device transfers (`.to(device)`,
    `.cuda()`, `torch.as_tensor/tensor/from_numpy(..., device=)`, and
    runtime.device_put_chunk / put_lanes) live ONLY in
    store/device_cache.py (the audited upload helper).

    The HBM region-block cache is the single owner of device residency
    for region columns: its ledger (memtrack `hbm-cache` node) is exact
    only if every upload of storage-side columns flows through
    `upload_block`. A stray upload in a handler or executor creates
    untracked, unbudgeted HBM residency that the eviction/OOM machinery
    can neither see nor reclaim — the exact failure mode the old
    per-chunk transfer memos had. Kernel-internal transfers (ops/) are
    out of scope: they are transient dispatch staging, billed
    per-dispatch via dispatch_nbytes.
    """

    min_sites = 1       # the audited upload_block site must still exist
    fixture_rel = "tidb_tpu_torch/store/__lint_fixture__.py"
    fixture = (
        "import torch\n"
        "def serve_block(data, device):\n"
        "    return torch.from_numpy(data).to(device)\n"
    )

    def check(self, forest):
        for pf in forest:
            if not pf.rel.startswith(_SCOPES):
                continue
            for node in pf.nodes:
                kind = self._upload_kind(node)
                if kind is None:
                    continue
                self.sites += 1
                if pf.rel == _AUDITED:
                    continue        # sanctioned: the audited helper
                yield Finding(
                    pf.rel, node.lineno, self.name,
                    f"direct {kind} of region columns outside the "
                    f"audited upload helper — route the transfer "
                    f"through store/device_cache.upload_block so HBM "
                    f"residency stays tracked and evictable")

    @staticmethod
    def _upload_kind(node) -> str | None:
        if not isinstance(node, ast.Call):
            return None
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else \
            (fn.id if isinstance(fn, ast.Name) else None)
        if name in _UPLOADS:
            return name
        if name == "cuda" and isinstance(fn, ast.Attribute) and \
                not (isinstance(fn.value, ast.Name) and
                     fn.value.id == "torch"):
            return ".cuda()"
        if name == "to" and isinstance(fn, ast.Attribute):
            targets = list(node.args[:1]) + [kw.value for kw in
                                             node.keywords
                                             if kw.arg == "device"]
            if any(_names_device(t) for t in targets):
                return ".to(device)"
        if name in _FACTORIES and isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id == "torch" and \
                any(kw.arg == "device" for kw in node.keywords):
            return f"torch.{name}(..., device=)"
        return None
