"""Cross-module call graph over the lint forest.

Resolution is name-based and deliberately conservative (Python has no
static types to lean on): a call that cannot be resolved with
confidence resolves to NOTHING rather than fanning out to every
same-named method — for the flow rules an under-approximate graph
means missed edges, never false deadlock reports.

Functions are keyed `(rel, qualname)`:

    tidb_tpu_torch/store/copr.py : cop_handler
    tidb_tpu_torch/store/copr.py : CopClient._run_task
    tidb_tpu_torch/store/stream.py : region_stream.<locals>.emit

Resolution policy, in order:
  * bare `f()`       -> a nested def of the lexically enclosing
                        function chain, else this module's top-level
                        `f`, else an `from x import f` target, else a
                        class constructor (`C()` -> `C.__init__`);
  * `self.m()`       -> this class's method `m` (no MRO walk);
  * `mod.f()`        -> module-level `f` of the imported module `mod`;
  * `<expr>.m()`     -> the UNIQUE function named `m` across the whole
                        forest, unless `m` is on the ambiguity deny
                        list (names shared with builtin containers /
                        stdlib objects, e.g. `get`, `put`, `release`).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

__all__ = ["FuncInfo", "CallGraph"]

# attribute names too generic to resolve by global uniqueness: they
# collide with dict/list/queue/lock/file/executor methods, so a unique
# in-forest homonym would hijack stdlib calls
_AMBIGUOUS = frozenset({
    "get", "put", "set", "add", "pop", "clear", "update", "remove",
    "append", "extend", "insert", "discard", "release", "acquire",
    "wait", "notify", "notify_all", "close", "open", "read", "write",
    "send", "recv", "join", "start", "run", "submit", "result", "copy",
    "items", "keys", "values", "encode", "decode", "flush", "next",
    "sort", "index", "count", "split", "strip", "format", "popleft",
    "appendleft", "popitem", "setdefault", "move_to_end", "shutdown",
    "cancel", "total", "snapshot", "name", "is_set",
})


@dataclass
class FuncInfo:
    rel: str
    qualname: str
    cls: str | None                 # innermost enclosing class
    node: ast.AST
    nested: dict[str, "FuncInfo"] = field(default_factory=dict)
    parent: "FuncInfo | None" = None

    @property
    def key(self) -> tuple[str, str]:
        return (self.rel, self.qualname)


def _module_rel(dotted: str) -> str:
    """'tidb_tpu_torch.store.copr' -> 'tidb_tpu_torch/store/copr.py'
    (packages map to their __init__)."""
    return dotted.replace(".", "/") + ".py"


class CallGraph:
    def __init__(self, forest):
        self.forest = forest
        self.funcs: dict[tuple, FuncInfo] = {}
        # per-module lookup tables
        self._top: dict[tuple, FuncInfo] = {}       # (rel, name)
        self._method: dict[tuple, FuncInfo] = {}    # (rel, cls, name)
        self._classes: dict[tuple, str] = {}        # (rel, Class) -> rel
        self._by_name: dict[str, list[FuncInfo]] = {}
        self._imports: dict[str, dict[str, tuple]] = {}
        rels = {pf.rel for pf in forest}
        for pf in forest:
            self._index_module(pf, rels)

    # -- indexing ------------------------------------------------------------

    def _index_module(self, pf, rels: set[str]) -> None:
        imports: dict[str, tuple] = {}   # local name -> ("mod", rel) |
        #                                  ("func", rel, name)
        for node in pf.nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    rel = _module_rel(alias.name)
                    pkg = alias.name.replace(".", "/") + "/__init__.py"
                    target = rel if rel in rels else \
                        (pkg if pkg in rels else None)
                    if target:
                        imports[alias.asname or
                                alias.name.split(".")[0]] = \
                            ("mod", target)
            elif isinstance(node, ast.ImportFrom) and node.module and \
                    not node.level:
                base = node.module
                for alias in node.names:
                    local = alias.asname or alias.name
                    sub = _module_rel(f"{base}.{alias.name}")
                    subpkg = f"{base}.{alias.name}".replace(".", "/") + \
                        "/__init__.py"
                    modrel = _module_rel(base)
                    modpkg = base.replace(".", "/") + "/__init__.py"
                    if sub in rels:
                        imports[local] = ("mod", sub)
                    elif subpkg in rels:
                        imports[local] = ("mod", subpkg)
                    elif modrel in rels:
                        imports[local] = ("func", modrel, alias.name)
                    elif modpkg in rels:
                        imports[local] = ("func", modpkg, alias.name)
        self._imports[pf.rel] = imports

        def visit(node, qual: str, cls: str | None,
                  parent: FuncInfo | None):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    q = f"{qual}.{child.name}" if qual else child.name
                    self._classes[(pf.rel, child.name)] = pf.rel
                    visit(child, q, child.name, parent)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    if parent is not None:
                        q = f"{parent.qualname}.<locals>.{child.name}"
                    else:
                        q = f"{qual}.{child.name}" if qual else child.name
                    fi = FuncInfo(pf.rel, q, cls, child, parent=parent)
                    self.funcs[fi.key] = fi
                    self._by_name.setdefault(child.name, []).append(fi)
                    if parent is not None:
                        parent.nested[child.name] = fi
                    elif cls is not None:
                        self._method[(pf.rel, cls, child.name)] = fi
                    else:
                        self._top[(pf.rel, child.name)] = fi
                    visit(child, q, cls, fi)
                else:
                    visit(child, qual, cls, parent)

        visit(pf.tree, "", None, None)

    # -- resolution ----------------------------------------------------------

    def resolve_call(self, call: ast.Call, rel: str,
                     enclosing: FuncInfo | None) -> FuncInfo | None:
        fn = call.func
        if isinstance(fn, ast.Name):
            f = enclosing
            while f is not None:            # lexical closure chain
                hit = f.nested.get(fn.id)
                if hit is not None:
                    return hit
                f = f.parent
            hit = self._top.get((rel, fn.id))
            if hit is not None:
                return hit
            imp = self._imports.get(rel, {}).get(fn.id)
            if imp and imp[0] == "func":
                return self._top.get((imp[1], imp[2])) or \
                    self._method.get((imp[1], imp[2], "__init__"))
            if (rel, fn.id) in self._classes:
                return self._method.get((rel, fn.id, "__init__"))
            return None
        if isinstance(fn, ast.Attribute):
            base = fn.value
            if isinstance(base, ast.Name):
                if base.id == "self" and enclosing is not None and \
                        enclosing.cls is not None:
                    hit = self._method.get((rel, enclosing.cls, fn.attr))
                    if hit is not None:
                        return hit
                imp = self._imports.get(rel, {}).get(base.id)
                if imp and imp[0] == "mod":
                    return self._top.get((imp[1], fn.attr))
            if fn.attr in _AMBIGUOUS or fn.attr.startswith("__"):
                return None
            cands = self._by_name.get(fn.attr, [])
            # nested defs are only callable from their closure; exclude
            # them from the global-uniqueness fallback
            cands = [c for c in cands if c.parent is None]
            return cands[0] if len(cands) == 1 else None
        return None

    def enclosing(self, rel: str, qualname: str) -> FuncInfo | None:
        return self.funcs.get((rel, qualname))
