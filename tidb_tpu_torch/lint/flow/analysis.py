"""The shared flow facts: lock-acquisition order, held-lock sets, and
`# guarded-by:` annotations, computed once per forest.

Three passes over the already-parsed forest (no re-parse — the
engine's single-parse contract):

1. **Per-function walk.** Every function body is walked with the
   ordered list of locks lexically held. `with lock:` blocks and
   statement-form `lock.acquire()` push resolved locks; each
   acquisition under a non-empty held set records an ORDER EDGE
   (held -> acquired). Call sites and attribute/global writes are
   recorded with the held set at the site.

2. **Interprocedural propagation.** `trans_acq(F)` — the locks F may
   acquire, transitively through the call graph — is a fixpoint; a
   call made while holding H adds edges H -> trans_acq(callee).
   Dually, `caller_held(F)` — locks held at EVERY known call site of
   F — is a meet-over-callers fixpoint, so a helper only ever invoked
   under its owner's lock (`DeviceCache._drop_locked`,
   `RegionCache._insert`) checks as guarded without a lexical `with`.

3. **Annotations.** `# guarded-by: <lock-attr>` on an attribute's
   initialization line (or directly above it) declares the lock that
   must be held to WRITE the attribute anywhere in that module.
   `__init__` bodies and module top level are construction-time and
   exempt by definition.

The lock-order DAG (edges over registry names) is exported to the
runtime sanitizer (util/lockorder.py), which asserts observed
acquisition orders stay consistent with it — the dynamic harness
validates the static model and vice versa.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field

from tidb_tpu_torch.lint.flow.callgraph import CallGraph, FuncInfo
from tidb_tpu_torch.lint.flow.lockreg import LockRegistry, discover

__all__ = ["FlowAnalysis", "GuardAnnotation", "MUTATORS"]

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")

# container mutations that count as writes to the annotated attribute
MUTATORS = frozenset({
    "append", "appendleft", "add", "pop", "popleft", "popitem", "clear",
    "update", "remove", "discard", "extend", "insert", "setdefault",
    "move_to_end", "sort", "reverse",
})

# reentrant kinds: a self-edge (same lock name on both sides) is the
# point of an RLock, not a deadlock; Condition's default lock is an
# RLock, and Semaphore permits are counted, not owned
_REENTRANT = frozenset({"RLock", "Condition", "Semaphore"})


@dataclass
class GuardAnnotation:
    rel: str
    lineno: int
    cls: str | None            # owning class (None: module global)
    attr: str                  # the guarded attribute / global
    lock_text: str             # the annotation's lock spelling
    lock: str | None           # resolved registry name (None = bad)


@dataclass
class _WriteSite:
    func: FuncInfo
    base: str                  # "attr" | "name"
    name: str
    lineno: int
    held: frozenset


@dataclass
class _CallSite:
    func: FuncInfo
    call: ast.Call
    callee: FuncInfo | None
    held: tuple
    lineno: int


@dataclass
class _FuncFacts:
    acquisitions: list = field(default_factory=list)   # (lock, lineno)
    calls: list = field(default_factory=list)          # _CallSite
    writes: list = field(default_factory=list)         # _WriteSite


class FlowAnalysis:
    def __init__(self, forest):
        self.forest = forest
        self.registry: LockRegistry = discover(forest)
        self.graph = CallGraph(forest)
        self.facts: dict[tuple, _FuncFacts] = {}
        # (src, dst) -> (rel, lineno, note): first site proving the edge
        self.edges: dict[tuple, tuple] = {}
        self.annotations: list[GuardAnnotation] = []
        self._cls_spans: dict[str, list] = {}
        for pf in forest:
            self._cls_spans[pf.rel] = self._class_spans(pf)
        for fi in self.graph.funcs.values():
            self.facts[fi.key] = self._walk_function(fi)
        self.trans_acq = self._trans_acq()
        self._interproc_edges()
        self.caller_held = self._caller_held()
        for pf in forest:
            self._collect_annotations(pf)

    # -- class spans (lineno -> innermost class) -----------------------------

    @staticmethod
    def _class_spans(pf) -> list:
        spans = []
        for node in pf.nodes:
            if isinstance(node, ast.ClassDef):
                spans.append((node.lineno, node.end_lineno or node.lineno,
                              node.name))
        return spans

    def class_at(self, rel: str, lineno: int) -> str | None:
        best = None
        for a, b, name in self._cls_spans.get(rel, ()):
            if a <= lineno <= b and (best is None or a >= best[0]):
                best = (a, name)
        return best[1] if best else None

    # -- pass 1: per-function walk -------------------------------------------

    def _walk_function(self, fi: FuncInfo) -> _FuncFacts:
        facts = _FuncFacts()
        self._walk_block(fi, fi.node.body, [], facts)
        return facts

    def _resolve(self, fi: FuncInfo, expr):
        site = self.registry.resolve(fi.rel, fi.cls, expr)
        return site.name if site is not None else None

    def _note_acquire(self, fi, facts, lock: str, held: list,
                      lineno: int) -> None:
        facts.acquisitions.append((lock, lineno))
        for h in held:
            self._add_edge(h, lock, fi.rel, lineno,
                           f"nested acquisition in {fi.qualname}")

    def _add_edge(self, src: str, dst: str, rel: str, lineno: int,
                  note: str) -> None:
        if src == dst:
            if self.registry.kinds.get(src) in _REENTRANT:
                return
        self.edges.setdefault((src, dst), (rel, lineno, note))

    def _scan_exprs(self, fi, facts, exprs, held) -> None:
        """Collect calls (and lambda bodies, which run inline at call
        sites near here) from the expression parts of one statement."""
        for e in exprs:
            if e is None:
                continue
            for n in ast.walk(e):
                if isinstance(n, ast.Call):
                    callee = self.graph.resolve_call(n, fi.rel, fi)
                    facts.calls.append(_CallSite(
                        fi, n, callee, tuple(held), n.lineno))

    def _note_writes(self, fi, facts, targets, held, lineno) -> None:
        for t in targets:
            base = t
            while isinstance(base, (ast.Subscript, ast.Starred)):
                base = base.value
            if isinstance(base, (ast.Tuple, ast.List)):
                self._note_writes(fi, facts, base.elts, held, lineno)
                continue
            if isinstance(base, ast.Attribute):
                facts.writes.append(_WriteSite(
                    fi, "attr", base.attr, lineno, frozenset(held)))
            elif isinstance(base, ast.Name):
                facts.writes.append(_WriteSite(
                    fi, "name", base.id, lineno, frozenset(held)))

    def _walk_block(self, fi, stmts, held: list, facts) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue            # separate function in the graph
            if isinstance(stmt, ast.ClassDef):
                continue            # methods indexed separately
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired = []
                for item in stmt.items:
                    self._scan_exprs(fi, facts, [item.context_expr], held)
                    lock = self._resolve(fi, item.context_expr)
                    if lock is not None:
                        self._note_acquire(fi, facts, lock, held,
                                           item.context_expr.lineno)
                        held.append(lock)
                        acquired.append(lock)
                self._walk_block(fi, stmt.body, held, facts)
                for _ in acquired:
                    held.pop()
                continue
            if isinstance(stmt, ast.Try):
                self._walk_block(fi, stmt.body, held, facts)
                for h in stmt.handlers:
                    self._walk_block(fi, h.body, held, facts)
                self._walk_block(fi, stmt.orelse, held, facts)
                self._walk_block(fi, stmt.finalbody, held, facts)
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                self._scan_exprs(fi, facts, [stmt.test], held)
                self._walk_block(fi, stmt.body, held, facts)
                self._walk_block(fi, stmt.orelse, held, facts)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_exprs(fi, facts, [stmt.iter], held)
                self._note_writes(fi, facts, [stmt.target], held,
                                  stmt.lineno)
                self._walk_block(fi, stmt.body, held, facts)
                self._walk_block(fi, stmt.orelse, held, facts)
                continue
            if isinstance(stmt, ast.Match):
                self._scan_exprs(fi, facts, [stmt.subject], held)
                for case in stmt.cases:
                    self._walk_block(fi, case.body, held, facts)
                continue
            # simple statements: writes, then acquire/release bookkeeping
            if isinstance(stmt, ast.Assign):
                self._note_writes(fi, facts, stmt.targets, held,
                                  stmt.lineno)
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                if getattr(stmt, "value", True) is not None:
                    self._note_writes(fi, facts, [stmt.target], held,
                                      stmt.lineno)
            elif isinstance(stmt, ast.Delete):
                self._note_writes(fi, facts, stmt.targets, held,
                                  stmt.lineno)
            self._scan_exprs(fi, facts, [stmt], held)
            call = getattr(stmt, "value", None)
            if isinstance(stmt, ast.Expr):
                call = stmt.value
            if isinstance(call, ast.Call) and \
                    isinstance(call.func, ast.Attribute):
                if call.func.attr == "acquire":
                    lock = self._resolve(fi, call.func.value)
                    if lock is not None:
                        self._note_acquire(fi, facts, lock, held,
                                           call.lineno)
                        held.append(lock)
                elif call.func.attr == "release":
                    lock = self._resolve(fi, call.func.value)
                    if lock is not None and lock in held:
                        held.reverse()
                        held.remove(lock)
                        held.reverse()

    # -- pass 2: interprocedural fixpoints -----------------------------------

    def _trans_acq(self) -> dict:
        ta = {key: {a for a, _ in f.acquisitions}
              for key, f in self.facts.items()}
        changed = True
        while changed:
            changed = False
            for key, f in self.facts.items():
                cur = ta[key]
                for cs in f.calls:
                    if cs.callee is None:
                        continue
                    extra = ta.get(cs.callee.key, set()) - cur
                    if extra:
                        cur |= extra
                        changed = True
        return ta

    def _interproc_edges(self) -> None:
        for f in self.facts.values():
            for cs in f.calls:
                if cs.callee is None or not cs.held:
                    continue
                for lock in self.trans_acq.get(cs.callee.key, ()):
                    for h in cs.held:
                        self._add_edge(
                            h, lock, cs.func.rel, cs.lineno,
                            f"{cs.func.qualname} calls "
                            f"{cs.callee.qualname} while holding")

    def _caller_held(self) -> dict:
        callers: dict[tuple, list] = {}
        for f in self.facts.values():
            for cs in f.calls:
                if cs.callee is not None:
                    callers.setdefault(cs.callee.key, []).append(cs)
        # None = top (no information yet); meet is set intersection
        ch: dict[tuple, frozenset | None] = {}
        for key in self.facts:
            ch[key] = None if callers.get(key) else frozenset()
        changed = True
        while changed:
            changed = False
            for key, sites in callers.items():
                acc: frozenset | None = None
                for cs in sites:
                    caller_ch = ch.get(cs.func.key)
                    if caller_ch is None and not cs.held:
                        continue    # caller unresolved yet: skip this site
                    site_held = frozenset(cs.held) | (caller_ch or
                                                      frozenset())
                    acc = site_held if acc is None else (acc & site_held)
                if acc is not None and acc != ch[key]:
                    ch[key] = acc
                    changed = True
        return {k: (v or frozenset()) for k, v in ch.items()}

    def held_at(self, write: _WriteSite) -> frozenset:
        return write.held | self.caller_held.get(write.func.key,
                                                 frozenset())

    # -- pass 3: guarded-by annotations --------------------------------------

    def _collect_annotations(self, pf) -> None:
        if "guarded-by" not in pf.source:
            return
        comments: dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(pf.source).readline):
                if tok.type == tokenize.COMMENT:
                    comments[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError, SyntaxError):
            for i, text in enumerate(pf.lines, start=1):
                if "#" in text:
                    comments[i] = text[text.index("#"):]
        assigns: dict[int, ast.stmt] = {}
        for node in pf.nodes:
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                # index the WHOLE span: a trailing tag on the
                # continuation line of a wrapped assignment must bind
                # to this assignment, not fall through to the next one
                for ln in range(node.lineno,
                                (node.end_lineno or node.lineno) + 1):
                    assigns.setdefault(ln, node)
        for lineno, text in sorted(comments.items()):
            m = _GUARD_RE.search(text)
            if m is None:
                continue
            stmt = assigns.get(lineno)
            if stmt is None:        # standalone comment: covers the
                ln = lineno + 1     # next code line
                while ln <= len(pf.lines) and \
                        pf.lines[ln - 1].lstrip().startswith("#"):
                    ln += 1
                stmt = assigns.get(ln)
            attr = cls = None
            if stmt is not None:
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                if len(targets) == 1:
                    t = targets[0]
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        attr = t.attr
                        cls = self.class_at(pf.rel, stmt.lineno)
                    elif isinstance(t, ast.Name):
                        attr = t.id
                        cls = self.class_at(pf.rel, stmt.lineno)
            lock_text = m.group(1)
            lock = None
            if attr is not None:
                if cls is not None:
                    site = self.registry.class_attr(pf.rel, cls,
                                                    lock_text)
                else:
                    site = None
                site = site or self.registry.module_level(pf.rel,
                                                          lock_text) \
                    or self.registry.unique_in_module(pf.rel, lock_text)
                lock = site.name if site is not None else None
            self.annotations.append(GuardAnnotation(
                pf.rel, lineno, cls, attr if attr is not None else "",
                lock_text, lock))

    # -- lock-order results --------------------------------------------------

    def cycles(self) -> list:
        """Strongly connected components of the order graph with more
        than one lock, plus non-reentrant self-edges. Each entry:
        (ordered lock names, [(src, dst, rel, lineno, note), ...])."""
        adj: dict[str, set] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        onstack: set = set()
        stack: list = []
        sccs: list = []
        counter = [0]

        def strongconnect(v):
            # iterative Tarjan (the package graph is shallow, but the
            # engine must not rely on recursion depth)
            work = [(v, iter(sorted(adj[v])))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            onstack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        onstack.add(w)
                        work.append((w, iter(sorted(adj[w]))))
                        advanced = True
                        break
                    if w in onstack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        onstack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    sccs.append(comp)

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)

        out = []
        for comp in sccs:
            comp_set = set(comp)
            if len(comp) > 1:
                proof = [(a, b, *self.edges[(a, b)])
                         for (a, b) in sorted(self.edges)
                         if a in comp_set and b in comp_set]
                out.append((sorted(comp), proof))
        for (a, b), (rel, lineno, note) in sorted(self.edges.items()):
            if a == b:          # non-reentrant self-edge (_add_edge
                out.append(([a], [(a, b, rel, lineno, note)]))
        return out

    def dag_export(self) -> dict:
        """The statically-derived order DAG for the runtime sanitizer:
        edges over registry names, lock kinds, and construction sites
        so live locks can be mapped back to their static identity."""
        return {
            "edges": set(self.edges),
            "kinds": dict(self.registry.kinds),
            "sites": {(s.rel, s.lineno): (s.name, s.kind)
                      for s in self.registry.sites},
        }
