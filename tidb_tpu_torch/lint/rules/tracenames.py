"""Trace span-name discipline: the declared SPAN_NAMES vocabulary and
the trace.begin/trace.span call sites track each other (same registry
shape as metric-names and failpoint-discipline)."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

_TRACE = "tidb_tpu_torch/trace.py"


def declared_span_names(pf) -> dict[str, int]:
    """String keys of trace.py's module-level SPAN_NAMES dict
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
                targets[0].id == "SPAN_NAMES" and \
                isinstance(node.value, ast.Dict):
            for key in node.value.keys:
                if isinstance(key, ast.Constant) and \
                        isinstance(key.value, str):
                    out[key.value] = key.lineno
    return out


def _span_calls(pf):
    """trace.begin(...) / trace.span(...) / trace.Span(...) where the
    receiver is the trace module (incl. the `_trace` local-import
    alias). Span() construction counts: session builds its pre-closed
    parse span that way, and a constructed span enters the same trees
    the registry documents."""
    for node in pf.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and \
                fn.attr in ("begin", "span", "Span") and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id in ("trace", "_trace"):
            yield node, fn.attr


@register_rule("trace-names")
class TraceNamesRule(Rule):
    """Every trace.begin()/trace.span()/trace.Span() call site names a
    span declared in trace.SPAN_NAMES, as a string literal; and every
    declared name is opened by at least one in-tree site.

    The registry is the operator-facing span vocabulary (the docs, the
    Chrome export lanes and the bench latency attribution all read
    these names): a span opened under an undeclared name is a timeline
    lane no attribution bucket or doc explains, and a declared name no
    site opens is catalog fiction.
    """

    min_sites = 20      # lifecycle + device plane + storage seams
    fixture = (
        "from tidb_tpu_torch import trace\n"
        "def f():\n"
        "    with trace.span('not/declared'):\n"
        "        pass\n"
    )
    fixture_support = {
        _TRACE: 'SPAN_NAMES = {"plan": "planning"}\n',
    }

    def check(self, forest):
        decl_pf = forest.get(_TRACE)
        if decl_pf is None:
            yield Finding(_TRACE, 1, self.name,
                          "trace.py missing from the forest — the span "
                          "registry is gone")
            return
        declared = declared_span_names(decl_pf)
        if not declared:
            yield Finding(_TRACE, 1, self.name,
                          "trace.py lost its SPAN_NAMES table")
            return
        used: set[str] = set()
        for pf in forest:
            if pf.rel == _TRACE:
                continue    # the registry module's own helpers
            for call, kind in _span_calls(pf):
                self.sites += 1
                arg = call.args[0] if call.args else None
                if not (isinstance(arg, ast.Constant) and
                        isinstance(arg.value, str)):
                    yield Finding(
                        pf.rel, call.lineno, self.name,
                        f"trace.{kind} must name its span with a "
                        f"string literal from trace.SPAN_NAMES "
                        f"(computed names defeat the vocabulary audit)")
                    continue
                if arg.value not in declared:
                    yield Finding(
                        pf.rel, call.lineno, self.name,
                        f"trace.{kind}({arg.value!r}) opens a span not "
                        f"declared in trace.SPAN_NAMES — declare it "
                        f"(one vocabulary: docs, Chrome export, bench "
                        f"attribution)")
                    continue
                used.add(arg.value)
        for name, lineno in sorted(declared.items()):
            if name not in used:
                yield Finding(
                    _TRACE, lineno, self.name,
                    f"span name {name!r} is declared but no in-tree "
                    f"site opens it — dead vocabulary entry")
