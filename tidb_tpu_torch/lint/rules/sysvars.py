"""Sysvar registry discipline: the tidb_tpu_* namespace is closed, and
the docs track the registry."""

from __future__ import annotations

import ast
import glob
import os
import re

from tidb_tpu_torch.lint.engine import PKG_REL, Finding, Rule, register_rule
from tidb_tpu_torch.lint.rules.metrics import declared_constants

_CONFIG = "tidb_tpu_torch/config.py"
_METRICS = "tidb_tpu_torch/metrics.py"
_PREFIX = "tidb_tpu_"


def declared_sysvars(pf) -> dict[str, int]:
    """Keys of the config.py _DEFS registry dict -> lineno."""
    out = {}
    for node in pf.tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        else:
            continue
        if len(targets) == 1 and isinstance(targets[0], ast.Name) and \
                targets[0].id == "_DEFS" and \
                isinstance(node.value, ast.Dict):
            for key in node.value.keys:
                if isinstance(key, ast.Constant) and \
                        isinstance(key.value, str):
                    out[key.value] = key.lineno
    return out


_PKG_NAME = re.compile(re.escape(PKG_REL) + r"(?![A-Za-z0-9_])")


def _package_name(text: str) -> bool:
    """Text that starts with the package's own name (a logger, module or
    file path, a docstring: 'tidb_tpu_torch.server', 'tidb_tpu_torch/')
    shares the sysvar prefix but names no variable."""
    return _PKG_NAME.match(text) is not None


@register_rule("sysvar-registry")
class SysvarRegistryRule(Rule):
    """Every tidb_tpu_* string literal in the package is a sysvar
    declared in config.py (or a metric name declared in metrics.py),
    and every declared sysvar appears in the docs.

    The namespace is the user-facing contract: `SET @@tidb_tpu_x` only
    works for registered vars, and a get_var("tidb_tpu_tpyo") raises at
    runtime on exactly the path that was never tested. Conversely a
    sysvar added without documentation is invisible to operators — the
    docs leg doubles as a drift check (docs/*.md + README.md are
    scanned for each declared name).
    """

    fixture = 'FLAG = "tidb_tpu_bogus_knob"\n'
    fixture_support = {
        _CONFIG: '_DEFS = {"tidb_tpu_device": ("bool", 1)}\n',
        _METRICS: 'Q = "tidb_tpu_queries_total"\n',
    }

    def check(self, forest):
        cfg = forest.get(_CONFIG)
        if cfg is None:
            yield Finding(_CONFIG, 1, self.name,
                          "config.py missing from the forest — the "
                          "sysvar registry is gone")
            return
        sysvars = declared_sysvars(cfg)
        if not sysvars:
            yield Finding(_CONFIG, 1, self.name,
                          "config.py lost its _DEFS sysvar registry")
            return
        metrics_pf = forest.get(_METRICS)
        metric_names = set()
        if metrics_pf is not None:
            metric_names = {v for v, _ in
                            declared_constants(metrics_pf).values()}
        known = set(sysvars) | metric_names
        self.sites += len(sysvars)
        for pf in forest:
            if pf.rel in (_CONFIG, _METRICS):
                continue        # the declaration sites themselves
            for node in pf.nodes:
                if isinstance(node, ast.Constant) and \
                        isinstance(node.value, str) and \
                        node.value.startswith(_PREFIX) and \
                        not _package_name(node.value):
                    self.sites += 1
                    if node.value not in known:
                        yield Finding(
                            pf.rel, node.lineno, self.name,
                            f"string literal {node.value!r} is not a "
                            f"sysvar declared in config.py (nor a "
                            f"declared metric name) — register it or "
                            f"rename it out of the tidb_tpu_ namespace")
        yield from self._docs_leg(forest, sysvars)

    def _docs_leg(self, forest, sysvars):
        if forest.root is None:
            return              # synthetic forest: no docs on disk
        corpus = ""
        for path in [os.path.join(forest.root, "README.md"), *sorted(
                glob.glob(os.path.join(forest.root, "docs", "*.md")))]:
            try:
                with open(path, encoding="utf-8") as f:
                    corpus += f.read() + "\n"
            except OSError:
                continue
        for name, lineno in sorted(sysvars.items()):
            if not re.search(re.escape(name) + r"(?![a-z0-9_])", corpus):
                yield Finding(
                    _CONFIG, lineno, self.name,
                    f"sysvar {name!r} is declared but appears nowhere "
                    f"in README.md or docs/*.md — document it (operator "
                    f"surface must track the registry)")
