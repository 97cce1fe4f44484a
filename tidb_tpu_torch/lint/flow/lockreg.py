"""Auto-discovered lock registry: every `threading.Lock()/RLock()/
Condition()` construction site in the forest, named by module + owning
attribute.

Names are static identities, not runtime objects: every instance of
`MemTracker` shares the one name `tidb_tpu_torch/memtrack.py:MemTracker._mu`.
That is exactly the granularity a lock-ORDER discipline needs — the
ordering contract is written per construction site, and the runtime
sanitizer (util/lockorder.py) maps live locks back to these names by
their construction (file, line).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

__all__ = ["LockSite", "LockRegistry", "discover"]

_FACTORIES = {"Lock": "Lock", "RLock": "RLock", "Condition": "Condition",
              "Semaphore": "Semaphore",
              "BoundedSemaphore": "Semaphore"}


@dataclass(frozen=True)
class LockSite:
    rel: str            # module path, repo-relative
    lineno: int         # construction line
    cls: str | None     # owning class (None: module-level)
    attr: str           # attribute / global name the lock is bound to
    kind: str           # Lock | RLock | Condition | Semaphore

    @property
    def name(self) -> str:
        owner = f"{self.cls}.{self.attr}" if self.cls else self.attr
        return f"{self.rel}:{owner}"


def _factory_kind(call: ast.Call) -> str | None:
    """'threading.Lock(...)' / 'Lock(...)' -> 'Lock' (etc.), else None."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and \
            isinstance(fn.value, ast.Name) and fn.value.id == "threading":
        return _FACTORIES.get(fn.attr)
    if isinstance(fn, ast.Name):
        return _FACTORIES.get(fn.id)
    return None


class LockRegistry:
    """Lock sites indexed for the resolution policy the analysis uses."""

    def __init__(self, sites: list[LockSite]):
        self.sites = sites
        self.by_name: dict[str, LockSite] = {s.name: s for s in sites}
        self.kinds: dict[str, str] = {s.name: s.kind for s in sites}
        # (rel, cls, attr) -> site  and  (rel, attr) -> module-level site
        self._scoped: dict[tuple, LockSite] = {}
        # (rel, attr) -> class-scoped sites in that module (for
        # receiver-typeless `obj.attr` resolution)
        self._mod_attr: dict[tuple, list[LockSite]] = {}
        for s in sites:
            self._scoped[(s.rel, s.cls, s.attr)] = s
            if s.cls is not None:
                self._mod_attr.setdefault((s.rel, s.attr), []).append(s)

    def module_level(self, rel: str, name: str) -> LockSite | None:
        return self._scoped.get((rel, None, name))

    def class_attr(self, rel: str, cls: str | None,
                   attr: str) -> LockSite | None:
        return self._scoped.get((rel, cls, attr))

    def unique_in_module(self, rel: str, attr: str) -> LockSite | None:
        cands = self._mod_attr.get((rel, attr), [])
        return cands[0] if len(cands) == 1 else None

    def resolve(self, rel: str, cls: str | None,
                expr: ast.expr) -> LockSite | None:
        """Resolve a lock-valued expression at a `with`/acquire site.

        Deliberately under-approximate — an unresolvable expression adds
        no edge and checks no guard, it never guesses:
          * bare name        -> this module's global of that name;
          * `self.X` in C    -> this module's C.X;
          * `<anything>.X`   -> the UNIQUE class-scoped X in this module
                                (e.g. `node._mu` inside memtrack.py);
          * ambiguous / cross-module receivers -> None.
        """
        if isinstance(expr, ast.Name):
            return self.module_level(rel, expr.id) or \
                self.class_attr(rel, cls, expr.id)
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and \
                    expr.value.id == "self" and cls is not None:
                hit = self.class_attr(rel, cls, expr.attr)
                if hit is not None:
                    return hit
            return self.unique_in_module(rel, expr.attr)
        return None


def discover(forest) -> LockRegistry:
    """Walk every module for lock constructions bound to an attribute
    (`self.X = threading.Lock()` in a class, `X = threading.Lock()` at
    module or class scope)."""
    sites: list[LockSite] = []

    def visit(pf, node, cls: str | None, in_func: bool):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(pf, child, child.name, in_func)
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(pf, child, cls, True)
                continue
            if isinstance(child, (ast.Assign, ast.AnnAssign)):
                value = child.value
                if not isinstance(value, ast.Call):
                    continue
                kind = _factory_kind(value)
                if kind is None:
                    continue
                targets = child.targets if isinstance(child, ast.Assign) \
                    else [child.target]
                for t in targets:
                    if isinstance(t, ast.Name) and not in_func:
                        # module/class scope only: a function-local
                        # lock has no stable cross-call identity
                        sites.append(LockSite(pf.rel, child.lineno,
                                              cls, t.id, kind))
                    elif isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        sites.append(LockSite(pf.rel, child.lineno,
                                              cls, t.attr, kind))
            else:
                visit(pf, child, cls, in_func)

    for pf in forest:
        visit(pf, pf.tree, None, False)
    return LockRegistry(sites)
