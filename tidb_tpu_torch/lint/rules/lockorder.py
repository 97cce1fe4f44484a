"""Whole-program lock-order analysis: no cycles in the acquisition
order graph (the static half of a lock-order sanitizer)."""

from __future__ import annotations

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule
from tidb_tpu_torch.lint.flow import flow_of

_DOC = "docs/CONCURRENCY_TORCH.md"


@register_rule("lock-order")
class LockOrderRule(Rule):
    """No cycle in the whole-program lock acquisition order graph.

    Every `threading.Lock/RLock/Condition` construction site is
    auto-registered under a static name (module + attribute). Nested
    `with lock:` blocks and acquire/release sequences contribute order
    edges, propagated interprocedurally: a call made while holding L
    adds L -> every lock the callee may transitively acquire. A cycle
    in the resulting graph is a potential deadlock the moment two
    threads walk it from different entry points — exactly what
    concurrent serving does to the port's independently-invented
    locks. Self-edges on non-reentrant locks
    (a plain Lock re-acquired on the same thread) deadlock without any
    second thread and are reported too; RLock/Condition self-edges are
    reentrancy, not bugs. The runtime half is util/lockorder.py, which
    replays observed acquisition orders against this DAG under
    tests/test_torch_race_harness.py.

    The docs leg keeps docs/CONCURRENCY_TORCH.md's lock inventory in sync
    with the registry: every discovered lock must be listed there.
    """

    min_sites = 40      # in-tree acquisition sites the walk must visit

    fixture = (
        "import threading\n"
        "_a = threading.Lock()\n"
        "_b = threading.Lock()\n"
        "def f():\n"
        "    with _a:\n"
        "        with _b:\n"
        "            pass\n"
        "def g():\n"
        "    with _b:\n"
        "        with _a:\n"
        "            pass\n"
    )

    def check(self, forest):
        fl = flow_of(forest)
        for facts in fl.facts.values():
            self.sites += len(facts.acquisitions)
        for locks, proof in fl.cycles():
            a, b, rel, lineno, note = proof[0]
            if len(locks) == 1:
                msg = (f"lock {locks[0]} may be re-acquired while "
                       f"already held ({note}) — a non-reentrant lock "
                       f"self-deadlocks here; use an RLock or restructure")
            else:
                chain = " -> ".join(locks + [locks[0]])
                sites = "; ".join(
                    f"{s}->{d} at {r}:{ln} ({n})"
                    for s, d, r, ln, n in proof[:4])
                msg = (f"lock-order cycle {chain}: two threads entering "
                       f"from different edges deadlock. Edges: {sites}")
            yield Finding(rel, lineno, self.name, msg)
        yield from self._docs_leg(forest, fl)

    def _docs_leg(self, forest, fl):
        if forest.root is None:
            return              # synthetic forest: no docs on disk
        import os
        path = os.path.join(forest.root, _DOC)
        try:
            with open(path, encoding="utf-8") as f:
                corpus = f.read()
        except OSError:
            corpus = ""
        for site in fl.registry.sites:
            if site.name not in corpus:
                yield Finding(
                    site.rel, site.lineno, self.name,
                    f"lock {site.name} ({site.kind}) is missing from "
                    f"{_DOC}'s inventory table — the registry and the "
                    f"doc must not drift")
