"""Single-parse static-analysis engine (ref: TiDB's `make check` — gofmt
plus govet plus project-specific vet rules — rebuilt for this package).

The package's correctness invariants used to live in four copy-pasted
AST-walking test files, each re-parsing all ~100 package modules with
its own ad-hoc suppression convention. This engine parses every module ONCE
into a shared forest (`Forest`), runs every registered `Rule` over it,
and owns the one suppression syntax:

    # lint: exempt[rule-name] reason why this site is sanctioned

* Placed on (or directly above) an offending line, the tag suppresses
  that rule's findings on the tag line and the line below it.
* Placed directly above a `def` (or its decorators), it suppresses the
  rule for the whole function body — the successor of the old
  `memtrack.AUDITED_HELPERS` function registry.
* `exempt[a,b]` exempts several rules at once; the reason is required
  (a reasonless tag is itself a finding — no blanket exemptions).
* Rules may declare legacy `aliases` (e.g. ``# memtrack: exempt``) so
  historic tags keep working while call sites migrate.

Two guards keep the suite honest:

* unused-suppression: a tag that suppressed nothing is reported — a
  stale exemption would silently sanction future regressions.
* vacuity guard: every rule declares a positive `fixture` snippet that
  must produce a finding when linted in isolation, and a `min_sites`
  floor of real in-tree sites it must have examined. A refactor that
  moves the code a rule watches out of its scope fails loudly instead
  of hollowing the rule out.

Front ends: ``python -m tidb_tpu_torch.lint`` (CLI, see __main__.py) and
the parametrized pytest shim tests/test_torch_lint.py.
"""

from __future__ import annotations

import ast
import io
import os
import re
import time
import tokenize
from dataclasses import dataclass, field

__all__ = ["Finding", "Suppression", "ParsedFile", "Forest", "Rule",
           "register_rule", "REGISTRY", "Report", "run", "selfcheck",
           "parse_count", "REPO", "PKG_REL"]

# repo root: tidb_tpu_torch/lint/engine.py -> repo
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG_REL = "tidb_tpu_torch"

# pseudo-rules emitted by the engine itself (suppression hygiene)
UNUSED_RULE = "unused-suppression"
BAD_RULE = "bad-suppression"

# every ast.parse the engine ever performs, process-wide: the
# single-parse guarantee is asserted on THIS counter (test_lint.py's
# single-parse case, replayed by tests/test_torch_lint.py, pins `run()`
# to exactly one parse per package module, however many rules run), not
# on wall time — wall time flakes under concurrent CPU load inside the
# tier-1 budget, parse counts cannot
_PARSE_CALLS = 0


def parse_count() -> int:
    return _PARSE_CALLS

_TAG_RE = re.compile(r"#\s*lint:\s*exempt\[([A-Za-z0-9_,-]*)\]\s*(.*)")


@dataclass(frozen=True)
class Finding:
    """One structured lint result."""
    file: str          # repo-relative path
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Suppression:
    rule: str
    reason: str
    line: int          # line the tag sits on (1-based)
    start: int         # first line it covers
    end: int           # last line it covers (inclusive)
    alias: bool = False
    used: bool = False


class ParsedFile:
    """One module of the forest: AST + source lines + suppressions."""

    def __init__(self, rel: str, source: str,
                 aliases: dict[str, str] | None = None):
        global _PARSE_CALLS
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        _PARSE_CALLS += 1
        self.tree = ast.parse(source, filename=rel)
        self.bad_tags: list[Finding] = []
        self._def_spans = self._collect_def_spans()
        self.suppressions: list[Suppression] = []
        self._parse_tags(aliases or {})
        self._nodes: list | None = None

    @property
    def nodes(self) -> list:
        """Flat ast.walk order, computed once and shared by every rule
        (a list scan is much cheaper than a fresh tree walk per rule)."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def _collect_def_spans(self) -> dict[int, tuple[int, int]]:
        """first source line of a def (decorator included) -> body span.
        Functions only: a tag above a `class` would blanket-exempt
        every method under one reason, defeating the per-site audit."""
        spans: dict[int, tuple[int, int]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                first = min([node.lineno] +
                            [d.lineno for d in node.decorator_list])
                span = (first, node.end_lineno or node.lineno)
                spans[first] = span
                spans[node.lineno] = span   # tag trailing a decorated def
        return spans

    def _scope_for_tag(self, lineno: int) -> tuple[int, int]:
        """A STANDALONE comment tag directly above a def (comment runs
        allowed) covers the def's whole span; a tag trailing the def
        line itself does too. A standalone comment anywhere else covers
        the next line; a tag trailing an ordinary statement covers that
        statement ONLY — never the line (or def) below it."""
        if lineno in self._def_spans:        # tag trailing the def line
            return self._def_spans[lineno]
        if not self.lines[lineno - 1].lstrip().startswith("#"):
            return (lineno, lineno)          # trailing a code line
        ln = lineno + 1
        while ln <= len(self.lines) and \
                self.lines[ln - 1].lstrip().startswith("#"):
            ln += 1
        if ln in self._def_spans:
            start, end = self._def_spans[ln]
            return (min(lineno, start), end)
        # standalone tag: cover the comment run down to the next code
        # line, so stacked per-rule tags above one site all apply
        return (lineno, ln)

    def _comments(self) -> dict[int, str]:
        """line -> comment text, via tokenize — so a string literal
        that merely QUOTES the tag syntax can neither suppress an
        adjacent finding nor trip the unused-suppression check."""
        out: dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.source).readline):
                if tok.type == tokenize.COMMENT:
                    out[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # already ast-parsed, so this is unreachable in practice;
            # degrade to the raw-line scan rather than dropping tags
            for i, text in enumerate(self.lines, start=1):
                if "#" in text:
                    out[i] = text[text.index("#"):]
        return out

    def _parse_tags(self, aliases: dict[str, str]) -> None:
        needles = ["lint:"] + [t.lstrip("# ") for t in aliases]
        if not any(n in self.source for n in needles):
            return              # fast path: no candidate tags at all
        for i, text in sorted(self._comments().items()):
            m = _TAG_RE.search(text)
            if m:
                names = [n.strip() for n in m.group(1).split(",")]
                reason = m.group(2).strip()
                start, end = self._scope_for_tag(i)
                if not reason:
                    self.bad_tags.append(Finding(
                        self.rel, i, BAD_RULE,
                        "exempt tag without a reason — every exemption "
                        "must justify itself"))
                for name in names:
                    if not name:
                        self.bad_tags.append(Finding(
                            self.rel, i, BAD_RULE,
                            "exempt tag with empty rule name"))
                        continue
                    self.suppressions.append(
                        Suppression(name, reason, i, start, end))
                continue
            for tag, rule_name in aliases.items():
                if tag in text:
                    start, end = self._scope_for_tag(i)
                    reason = text.split(tag, 1)[1].lstrip(" -:").strip()
                    if not reason:
                        self.bad_tags.append(Finding(
                            self.rel, i, BAD_RULE,
                            f"legacy exempt tag {tag!r} without a "
                            f"reason — every exemption must justify "
                            f"itself"))
                    self.suppressions.append(Suppression(
                        rule_name, reason, i, start, end, alias=True))

    def suppressed(self, rule: str, lineno: int) -> bool:
        hit = False
        for s in self.suppressions:
            if s.rule == rule and s.start <= lineno <= s.end:
                s.used = True
                hit = True
        return hit


class Forest:
    """Every package module, parsed exactly once."""

    def __init__(self, files: dict[str, ParsedFile], root: str | None):
        self.files = files
        self.root = root        # None => synthetic forest (no docs leg)

    @classmethod
    def load(cls, root: str = REPO) -> "Forest":
        aliases = _alias_map()
        files: dict[str, ParsedFile] = {}
        pkg = os.path.join(root, PKG_REL)
        for dirpath, dirnames, filenames in os.walk(pkg):
            # the linter does not scan itself (rule fixtures contain
            # violations by design) — but only the package-root lint/,
            # not any future directory that happens to share the name
            dirnames[:] = sorted(
                d for d in dirnames
                if d != "__pycache__" and not (d == "lint"
                                               and dirpath == pkg))
            for f in sorted(filenames):
                if not f.endswith(".py"):
                    continue
                path = os.path.join(dirpath, f)
                rel = os.path.relpath(path, root)
                with open(path, encoding="utf-8") as fh:
                    files[rel] = ParsedFile(rel, fh.read(), aliases)
        return cls(files, root)

    @classmethod
    def from_sources(cls, sources: dict[str, str],
                     root: str | None = None) -> "Forest":
        aliases = _alias_map()
        return cls({rel: ParsedFile(rel, src, aliases)
                    for rel, src in sources.items()}, root)

    def __iter__(self):
        return iter(self.files.values())

    def get(self, rel: str) -> ParsedFile | None:
        return self.files.get(rel)


class Rule:
    """Base class: subclass, decorate with @register_rule("name"), and
    implement check(). Findings are yielded raw — the engine applies
    suppressions afterwards. check() must tally every candidate site it
    examined into self.sites (matched or not), feeding the vacuity
    guard; `fixture` is a snippet that must yield at least one finding
    when linted in isolation as `fixture_rel` (+ fixture_support)."""

    name: str = ""
    aliases: tuple[str, ...] = ()
    min_sites: int = 1
    fixture: str = ""
    fixture_rel: str = "tidb_tpu_torch/__lint_fixture__.py"
    fixture_support: dict[str, str] = {}

    def __init__(self):
        self.sites = 0

    @classmethod
    def doc(cls) -> str:
        return (cls.__doc__ or "").strip().splitlines()[0]

    def check(self, forest: Forest):
        raise NotImplementedError


REGISTRY: dict[str, type[Rule]] = {}


def register_rule(name: str):
    def deco(cls: type[Rule]) -> type[Rule]:
        if name in REGISTRY:
            raise ValueError(f"duplicate rule {name!r}")
        cls.name = name
        REGISTRY[name] = cls
        return cls
    return deco


def _alias_map() -> dict[str, str]:
    return {tag: cls.name
            for cls in REGISTRY.values() for tag in cls.aliases}


def selfcheck(cls: type[Rule]) -> list[Finding]:
    """Vacuity guard, fixture leg: the rule's positive fixture must
    produce at least one finding when linted in isolation. Returns the
    problems (empty list == healthy rule)."""
    if not cls.fixture:
        return [Finding("tidb_tpu_torch/lint", 0, cls.name,
                        "vacuity guard: rule declares no positive fixture")]
    sources = dict(cls.fixture_support)
    sources[cls.fixture_rel] = cls.fixture
    try:
        forest = Forest.from_sources(sources)
    except SyntaxError as e:
        return [Finding("tidb_tpu_torch/lint", 0, cls.name,
                        f"vacuity guard: fixture does not parse: {e}")]
    rule = cls()
    hits = [f for f in rule.check(forest) if f.file == cls.fixture_rel]
    if not hits:
        return [Finding("tidb_tpu_torch/lint", 0, cls.name,
                        "vacuity guard: positive fixture produced no "
                        "finding — the rule no longer matches the "
                        "pattern it documents")]
    return []


@dataclass
class Report:
    findings: list[Finding] = field(default_factory=list)
    rule_times: dict[str, float] = field(default_factory=dict)
    parse_time: float = 0.0
    total_time: float = 0.0
    files: int = 0
    rules_run: list[str] = field(default_factory=list)
    parse_calls: int = 0     # ast.parse calls Forest.load spent (one
    #                          per module; rules add ZERO)

    @property
    def clean(self) -> bool:
        return not self.findings


def run(rules: list[str] | None = None, forest: Forest | None = None,
        root: str = REPO, with_selfcheck: bool = True,
        with_vacuity: bool = True) -> Report:
    """Run `rules` (default: all registered, in registration order) over
    one shared parse of the package. Returns a Report; report.clean is
    the CI contract. with_vacuity=False skips the min_sites floor (for
    synthetic forests in the framework's own tests)."""
    t0 = time.perf_counter()
    names = list(REGISTRY) if rules is None else list(rules)
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        raise KeyError(f"unknown rule(s): {', '.join(unknown)} "
                       f"(see --list-rules)")
    report = Report()
    if forest is None:
        p0 = _PARSE_CALLS
        forest = Forest.load(root)
        report.parse_time = time.perf_counter() - t0
        report.parse_calls = _PARSE_CALLS - p0
    report.files = len(forest.files)
    report.rules_run = names

    for f in forest:
        report.findings.extend(f.bad_tags)

    for name in names:
        cls = REGISTRY[name]
        t1 = time.perf_counter()
        rule = cls()
        for finding in rule.check(forest):
            pf = forest.get(finding.file)
            if pf is not None and pf.suppressed(name, finding.line):
                continue
            report.findings.append(finding)
        if with_vacuity and rule.sites < cls.min_sites:
            report.findings.append(Finding(
                "tidb_tpu_torch/lint", 0, name,
                f"vacuity guard: rule examined {rule.sites} in-tree "
                f"site(s), expected >= {cls.min_sites} — its scope no "
                f"longer matches the code it was written to watch"))
        if with_selfcheck:
            report.findings.extend(selfcheck(cls))
        report.rule_times[name] = time.perf_counter() - t1

    ran = set(names)
    for f in forest:
        for s in f.suppressions:
            if s.rule in ran and not s.used:
                report.findings.append(Finding(
                    f.rel, s.line, UNUSED_RULE,
                    f"exempt[{s.rule}] suppressed nothing — stale tags "
                    f"sanction future regressions; delete it"))
            elif s.rule not in REGISTRY:
                report.findings.append(Finding(
                    f.rel, s.line, BAD_RULE,
                    f"exempt tag names unknown rule {s.rule!r}"))

    report.findings.sort(key=lambda x: (x.file, x.line, x.rule))
    report.total_time = time.perf_counter() - t0
    return report
