"""Metric-name registry discipline (port of tests/test_lint_metrics.py)."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule

_METRICS = "tidb_tpu_torch/metrics.py"


def declared_constants(pf) -> dict[str, tuple[str, int]]:
    """UPPERCASE module-level string constants of metrics.py:
    NAME -> (value, lineno)."""
    out = {}
    for node in pf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id.isupper() and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            out[node.targets[0].id] = (node.value.value, node.lineno)
    return out


def _metric_calls(pf):
    """<anything>.counter/.histogram/.gauge(...) where the receiver is
    the metrics module (imported as `metrics`)."""
    for node in pf.nodes:
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and \
                fn.attr in ("counter", "histogram", "gauge") and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id == "metrics":
            yield node


def _name_arg(call):
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "name":
            return kw.value
    return None


@register_rule("metric-names")
class MetricNamesRule(Rule):
    """Every metrics.counter/histogram/gauge call site passes a name
    CONSTANT declared in metrics.py — never a string literal.

    A typo'd stringly family name would silently fork a metric family;
    the registry of names in metrics.py is the single place scrape
    dashboards are built against. Declared names must also follow the
    Prometheus conventions (tidb_tpu_ prefix, lowercase, unit suffix
    _total/_seconds/_bytes — or the unitless gauge-level suffixes
    _current/_depth/_ratio for instantaneous counts and proportions
    like open connections, queue depths and device utilization, which
    carry no unit to name).
    """

    min_sites = 10      # the session + coprocessor layers really emit
    fixture = (
        "from tidb_tpu_torch import metrics\n"
        "def f():\n"
        "    metrics.counter('tidb_tpu_oops_total')\n"
    )
    fixture_support = {
        _METRICS: 'QUERIES_TOTAL = "tidb_tpu_queries_total"\n',
    }

    def check(self, forest):
        decl_pf = forest.get(_METRICS)
        if decl_pf is None:
            yield Finding(_METRICS, 1, self.name,
                          "metrics.py missing from the forest — the "
                          "metric-name registry is gone")
            return
        consts = declared_constants(decl_pf)
        if not consts:
            yield Finding(_METRICS, 1, self.name,
                          "metrics.py lost its name constants")
        for const, (value, lineno) in consts.items():
            ok = (value.startswith("tidb_tpu_") and value == value.lower()
                  and value.endswith(("_total", "_seconds", "_bytes",
                                      "_current", "_depth", "_ratio")))
            if not ok:
                yield Finding(
                    decl_pf.rel, lineno, self.name,
                    f"{const} = {value!r} breaks Prometheus naming: "
                    f"tidb_tpu_ prefix, lowercase, unit suffix "
                    f"_total/_seconds/_bytes (or gauge-level "
                    f"_current/_depth/_ratio)")
        for pf in forest:
            for call in _metric_calls(pf):
                self.sites += 1
                arg = _name_arg(call)
                if arg is None:
                    yield Finding(pf.rel, call.lineno, self.name,
                                  "metric call without a name argument")
                    continue
                if isinstance(arg, ast.Attribute) and \
                        isinstance(arg.value, ast.Name) and \
                        arg.value.id == "metrics" and arg.attr in consts:
                    continue
                yield Finding(
                    pf.rel, call.lineno, self.name,
                    f"metric name must be a metrics.<CONSTANT> declared "
                    f"in metrics.py, got {ast.dump(arg)[:60]}")


def _labels_arg(call):
    """The labels argument of a metrics.counter/histogram/gauge call
    (positional position differs: counter(name, labels), histogram/
    gauge(name, value, labels))."""
    idx = 1 if call.func.attr == "counter" else 2
    if len(call.args) > idx:
        return call.args[idx]
    for kw in call.keywords:
        if kw.arg == "labels":
            return kw.value
    return None


# label keys that ARE a per-tenant / per-statement dimension: one series
# per session or statement is unbounded cardinality by construction
_FORBIDDEN_LABEL_KEYS = frozenset({
    "session", "session_id", "sid", "conn", "conn_id", "connection",
    "user", "username", "tenant", "digest", "digest_text", "stmt",
    "stmt_id", "statement", "trace_id", "sql", "query",
})

# identifiers whose VALUE is per-session/per-statement state: binding
# one as a label value mints a series per tenant even under an innocent
# key name
_FORBIDDEN_VALUE_IDENTS = frozenset({
    "session_id", "sid", "conn_id", "digest", "trace_id", "sql",
    "current_sql", "user", "username",
})


@register_rule("metric-cardinality")
class MetricCardinalityRule(Rule):
    """Prometheus label sets stay bounded: no per-session, per-user,
    per-statement or per-trace label values at metrics.* call sites.

    The metrics registry is process-cumulative and every labeled series
    lives forever in the exposition — a label keyed by session id or
    SQL digest grows one series per tenant/statement shape and
    eventually dominates scrape cost and registry memory. That
    attribution belongs in the resource meter and its memtables
    (tidb_tpu_torch/meter.py: information_schema.resource_usage, GET /top),
    which are bounded and evictable. Three checks per call site:

      * the labels argument is an inline dict literal (reviewable
        cardinality — a dict built elsewhere hides its keys);
      * no label KEY names a tenant/statement dimension
        (session/user/digest/sql/trace_id/...);
      * no label VALUE is an f-string, string concatenation, call, or
        a name/attribute bound to per-session state (session_id, sql,
        digest, ...) — computed values are how unbounded series get
        minted by accident.

    Constants and bounded enums (outcome/reason/op/worker names) pass.
    """

    min_sites = 10      # every labeled family in the tree goes through
    fixture = (
        "from tidb_tpu_torch import metrics\n"
        "Q = 'x'\n"
        "def f(session_id, digest):\n"
        "    metrics.counter(metrics.Q, {'session': session_id})\n"
        "    metrics.counter(metrics.Q, {'op': digest})\n"
        "    metrics.counter(metrics.Q, {'op': f'q-{session_id}'})\n"
    )
    fixture_support = {
        _METRICS: 'Q = "tidb_tpu_queries_total"\n',
    }

    def _value_ident(self, node):
        """Terminal identifier of a Name/Attribute value expression."""
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr
        return None

    def check(self, forest):
        for pf in forest:
            for call in _metric_calls(pf):
                labels = _labels_arg(call)
                if labels is None or (
                        isinstance(labels, ast.Constant)
                        and labels.value is None):
                    continue
                self.sites += 1
                if not isinstance(labels, ast.Dict):
                    yield Finding(
                        pf.rel, call.lineno, self.name,
                        "metric labels must be an inline dict literal "
                        "so the label cardinality is reviewable at the "
                        "call site")
                    continue
                for key, val in zip(labels.keys, labels.values):
                    if isinstance(key, ast.Constant) and \
                            isinstance(key.value, str) and \
                            key.value.lower() in _FORBIDDEN_LABEL_KEYS:
                        yield Finding(
                            pf.rel, call.lineno, self.name,
                            f"label key {key.value!r} is a per-tenant/"
                            f"per-statement dimension — unbounded "
                            f"series cardinality; attribute this in "
                            f"the resource meter (tidb_tpu_torch/meter.py), "
                            f"not Prometheus")
                    if isinstance(val, ast.Constant):
                        continue
                    if isinstance(val, (ast.JoinedStr, ast.BinOp,
                                        ast.Call, ast.Subscript)):
                        yield Finding(
                            pf.rel, call.lineno, self.name,
                            "computed label value (f-string/concat/"
                            "call/index) can mint unbounded series — "
                            "use a bounded enum name, or move the "
                            "attribution into the resource meter")
                        continue
                    ident = self._value_ident(val)
                    if ident is not None and \
                            ident.lower() in _FORBIDDEN_VALUE_IDENTS:
                        yield Finding(
                            pf.rel, call.lineno, self.name,
                            f"label value {ident!r} is per-session/"
                            f"per-statement state — one series per "
                            f"tenant; attribute this in the resource "
                            f"meter (tidb_tpu_torch/meter.py) instead")
