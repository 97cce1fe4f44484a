"""Decode discipline: full-column dictionary decodes live only in
registered late-materialize helpers."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.astutil import call_name, enclosing_map
from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

# the hot operator layer the encoded path flows through; decode-shaped
# gathers anywhere here silently rot encoded execution back to wide
# vectors (store/device_cache.py's per-delta encode loops are the
# ENCODE direction and out of scope)
_SCOPES = ("tidb_tpu_torch/ops/",)
_EXTRA_FILES = ("tidb_tpu_torch/store/copr.py",)

_DECODER = "decode_codes"


def _registry() -> set[tuple[str, str]]:
    """(file, function) pairs sanctioned to decode whole columns —
    read from the live module so the registry and the rule cannot
    drift (a stale entry is itself a finding)."""
    from tidb_tpu_torch.ops.encoded import LATE_MATERIALIZE
    return set(LATE_MATERIALIZE)


@register_rule("decode-discipline")
class DecodeDisciplineRule(Rule):
    """In ops/ and store/copr.py, full-column dictionary decode —
    calling decode_codes, or gathering a dictionary by a codes array —
    happens only inside helpers registered in
    ops/encoded.LATE_MATERIALIZE (or behind a justified tag).

    Encoded execution (`tidb_tpu_encoded_exec`) only pays off while the
    operator layer stays in code space end-to-end: one convenience
    decode in a kernel wrapper quietly re-materializes the wide vectors
    the whole path exists to avoid, and nothing fails — queries just
    get slower. Matched shapes: (a) any call to decode_codes (THE
    audited decoder) outside a registered late-materialize helper;
    (b) a comprehension gathering `values[c] for c in codes` where the
    container or iterable name is dictionary-shaped (contains 'values'
    or 'dict') — the hand-rolled form of the same decode. Registered
    helpers that stop existing are reported (registry staleness).
    """

    min_sites = 1       # decode_codes' own registered body must exist
    fixture_rel = "tidb_tpu_torch/ops/__lint_fixture__.py"
    fixture = (
        "def serve(values, codes):\n"
        "    return [values[c] for c in codes]\n"
    )

    def check(self, forest):
        registry = _registry()
        seen_funcs: set[tuple[str, str]] = set()
        seen_files: set[str] = set()
        for pf in forest:
            seen_files.add(pf.rel)
            if not (pf.rel.startswith(_SCOPES) or
                    pf.rel in _EXTRA_FILES):
                continue
            enclosing = enclosing_map(pf.tree)
            for node in pf.nodes:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    seen_funcs.add((pf.rel, node.name))
                    if (pf.rel, node.name) in registry:
                        # the audited decoder itself: the site the
                        # min_sites floor guards (scope drift that
                        # loses it must fail loudly)
                        self.sites += 1
                kind = self._decode_kind(node)
                if kind is None:
                    continue
                self.sites += 1
                fn = (enclosing(node.lineno) or "").split(".")[-1]
                if (pf.rel, fn) in registry:
                    continue        # sanctioned late-materialize helper
                yield Finding(
                    pf.rel, node.lineno, self.name,
                    f"full-column dictionary decode ({kind}) outside a "
                    f"registered late-materialize helper — decode at "
                    f"the operator-output finalize boundary "
                    f"(ops/encoded.decode_codes) or register the "
                    f"helper in ops/encoded.LATE_MATERIALIZE")
        # registry staleness: a sanctioned helper that stopped existing
        # must not silently exempt future code at its old name. Only
        # judged for files this forest actually parsed — fixture
        # forests see a handful of synthetic files
        for rel, fn in sorted(registry):
            if rel in seen_files and (rel, fn) not in seen_funcs:
                yield Finding(
                    rel, 0, self.name,
                    f"LATE_MATERIALIZE registers {fn}() which no longer "
                    f"exists in {rel} — prune the registry entry")

    @staticmethod
    def _decode_kind(node) -> str | None:
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name and name.split(".")[-1] == _DECODER:
                return f"{_DECODER} call"
            return None
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            if len(node.generators) != 1:
                return None
            gen = node.generators[0]
            if not isinstance(gen.target, ast.Name):
                return None
            target = gen.target.id
            for sub in ast.walk(node.elt):
                if (isinstance(sub, ast.Subscript) and
                        isinstance(sub.value, ast.Name) and
                        isinstance(sub.slice, ast.Name) and
                        sub.slice.id == target and
                        any(k in sub.value.id.lower()
                            for k in ("values", "dict"))):
                    return "dictionary gather comprehension"
        return None
