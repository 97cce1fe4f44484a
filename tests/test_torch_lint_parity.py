"""The port's rules that carry over from the JAX package's lint give the
reference's findings on the same sources.

Each source goes through `tidb_tpu.lint` as it is and through
`tidb_tpu_torch.lint` with only the package name changed (`tidb_tpu` ->
`tidb_tpu_torch`, in the code and in the file paths). For every rule
that carries over (all but the seven device rules, which match torch),
the raw findings — before suppression tags apply — must be identical:
the same rule, file, line and message, up to the package name. Two
corpora: every rule's own positive fixture (with its support files), and
the JAX package's whole tree, whose raw findings are the sites its tags
sanction.
"""

import os
import re

import pytest

from tidb_tpu.lint import REGISTRY as JREG
from tidb_tpu.lint.engine import Forest as JForest
from tidb_tpu_torch.lint import REGISTRY as PREG
from tidb_tpu_torch.lint.engine import REPO
from tidb_tpu_torch.lint.engine import Forest as PForest

DEVICE_RULES = {"hot-path-sync", "device-sync", "dtype-discipline",
                "device-cache", "cache-key", "retrace-hazard",
                "donation-safety", "inplace-safety"}
CARRIED = [r for r in JREG if r not in DEVICE_RULES]
_PKG = re.compile(r"\btidb_tpu\b")


def to_port(text: str) -> str:
    return _PKG.sub("tidb_tpu_torch", text)


def back(text: str) -> str:
    return text.replace("tidb_tpu_torch", "tidb_tpu")


def raw(reg, rule, forest) -> list:
    return sorted((f.rule, f.file, f.line, f.message)
                  for f in reg[rule]().check(forest))


def both(sources: dict) -> tuple:
    jf = JForest.from_sources(sources)
    pf = PForest.from_sources({to_port(rel): to_port(src)
                               for rel, src in sources.items()})
    return jf, pf


def same(rule, jf, pf) -> tuple:
    want = raw(JREG, rule, jf)
    got = [(r, back(f), ln, back(m)) for r, f, ln, m in raw(PREG, rule, pf)]
    return want, sorted(got)


def test_the_carried_rules_are_the_reference_ones_less_the_device_rules():
    assert len(CARRIED) == 15
    assert set(CARRIED) <= set(PREG)
    assert set(PREG) - set(CARRIED) == DEVICE_RULES - {"donation-safety"}


FIXTURES = {name: {**cls.fixture_support, cls.fixture_rel: cls.fixture}
            for name, cls in JREG.items()}


@pytest.mark.parametrize("rule", CARRIED)
def test_fixture_corpus_gives_the_reference_findings(rule):
    """Every reference fixture (each rule's positive snippet and its
    support files), through this rule in both packages."""
    fired = 0
    for sources in FIXTURES.values():
        want, got = same(rule, *both(sources))
        assert got == want, (rule, sources)
        fired += len(want)
    assert fired >= 1       # its own fixture fires


@pytest.fixture(scope="module")
def reference_tree():
    """The JAX package's tree as sources: each module as it is, and its
    renamed twin for the port."""
    sources = {}
    pkg = os.path.join(REPO, "tidb_tpu")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__"
                             and not (d == "lint" and dirpath == pkg))
        for f in sorted(filenames):
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    sources[os.path.relpath(path, REPO)] = fh.read()
    return both(sources)


@pytest.mark.parametrize("rule", CARRIED)
def test_reference_tree_gives_the_reference_raw_findings(rule,
                                                         reference_tree):
    want, got = same(rule, *reference_tree)
    assert got == want
