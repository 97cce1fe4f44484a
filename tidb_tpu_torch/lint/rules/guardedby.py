"""Guarded-by checking: writes to annotated shared state must hold the
owning lock."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule
from tidb_tpu_torch.lint.flow import flow_of
from tidb_tpu_torch.lint.flow.analysis import MUTATORS


@register_rule("guarded-by")
class GuardedByRule(Rule):
    """Writes to a `# guarded-by: <lock>`-annotated attribute must hold
    the owning lock.

    The annotation sits on (or directly above) the attribute's
    initialization line:

        self.host = 0          # guarded-by: _mu
        _STATS = _fresh()      # guarded-by: _stats_lock

    and declares, in the module that owns the state, which lock
    protects it. Any write to that attribute elsewhere in the module —
    assignment, augmented assignment, `del`, or a container mutation
    (`.append`/`.pop`/`.update`/...) — must happen with the lock held:
    lexically inside `with lock:`, or in a helper whose every in-tree
    call site holds it (`DeviceCache._drop_locked` is the canonical
    case). `__init__` bodies and module import time are construction —
    single-threaded by definition — and exempt. Reads are out of
    scope: the seeded modules' read paths are either locked already or
    deliberately racy-by-design snapshots, and a read-barrier lint
    would drown the write findings that actually corrupt state.

    An annotation naming a lock the registry cannot resolve is itself
    a finding — a typo'd guard is a silently unchecked one.
    """

    min_sites = 30      # annotations + writes examined in-tree

    fixture = (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._mu = threading.Lock()\n"
        "        self.n = 0   # guarded-by: _mu\n"
        "    def bump(self):\n"
        "        self.n += 1\n"
    )

    def check(self, forest):
        fl = flow_of(forest)
        # (rel, attr) -> annotation, split by base kind
        attr_owned: dict[tuple, object] = {}
        name_owned: dict[tuple, object] = {}
        for ann in fl.annotations:
            self.sites += 1
            if not ann.attr:
                yield Finding(
                    ann.rel, ann.lineno, self.name,
                    "guarded-by tag is not attached to an attribute or "
                    "module-global initialization line")
                continue
            if ann.lock is None:
                yield Finding(
                    ann.rel, ann.lineno, self.name,
                    f"guarded-by names {ann.lock_text!r}, which resolves "
                    f"to no registered lock in this module — a typo'd "
                    f"guard checks nothing")
                continue
            if ann.cls is not None:
                attr_owned[(ann.rel, ann.attr)] = ann
            else:
                name_owned[(ann.rel, ann.attr)] = ann
        if not attr_owned and not name_owned:
            return
        for pf in forest:
            yield from self._check_module(fl, pf, attr_owned, name_owned)

    def _check_module(self, fl, pf, attr_owned, name_owned):
        rel = pf.rel
        facts = [(key, f) for key, f in fl.facts.items()
                 if key[0] == rel]
        for _key, f in facts:
            for w in f.writes:
                ann = attr_owned.get((rel, w.name)) if w.base == "attr" \
                    else name_owned.get((rel, w.name))
                if ann is None:
                    continue
                self.sites += 1
                if self._allowed(fl, w, ann):
                    continue
                yield Finding(
                    rel, w.lineno, self.name,
                    f"write to {w.name!r} without holding {ann.lock} "
                    f"(declared guarded-by at {ann.rel}:{ann.lineno}) — "
                    f"a concurrent reader/writer sees torn state")
            for cs in f.calls:
                fn = cs.call.func
                if not (isinstance(fn, ast.Attribute) and
                        fn.attr in MUTATORS):
                    continue
                base = fn.value
                ann = None
                if isinstance(base, ast.Attribute):
                    ann = attr_owned.get((rel, base.attr))
                    wname = base.attr
                elif isinstance(base, ast.Name):
                    ann = name_owned.get((rel, base.id))
                    wname = base.id
                if ann is None:
                    continue
                self.sites += 1
                held = frozenset(cs.held) | fl.caller_held.get(
                    cs.func.key, frozenset())
                if ann.lock in held or cs.func.node.name == "__init__":
                    continue
                yield Finding(
                    rel, cs.lineno, self.name,
                    f"mutation of {wname!r} (.{fn.attr}) without holding "
                    f"{ann.lock} (declared guarded-by at "
                    f"{ann.rel}:{ann.lineno})")

    @staticmethod
    def _allowed(fl, w, ann) -> bool:
        if w.func.node.name == "__init__":
            return True         # construction is single-threaded
        return ann.lock in fl.held_at(w)
