"""tidb_tpu_torch.lint.flow — whole-program concurrency analysis over the
lint forest.

The single-parse engine (tidb_tpu_torch/lint/engine.py) gives every rule a
shared AST forest; this package builds the interprocedural layer the
three flow rules share, computed ONCE per forest and memoized on it:

* `callgraph`  — a cross-module call graph (imports resolved, methods
  keyed by class, nested defs keyed by their enclosing function);
* `lockreg`    — the auto-discovered lock registry: every
  `threading.Lock/RLock/Condition` construction site, named
  `<module>:<Class.>attr`;
* `analysis`   — the flow facts: lock-acquisition edges (intra- plus
  interprocedural through the call graph), per-write-site held-lock
  sets with caller-held propagation, `# guarded-by:` annotations, and
  the lock-order DAG the runtime sanitizer (util/lockorder.py)
  validates against.

Rules consuming this live in tidb_tpu_torch/lint/rules/ (lock-order,
guarded-by, paired-resource); `flow_of(forest)` is the one entry
point — calling it from three rules costs one analysis, preserving the
engine's parse-once/walk-cheaply contract.
"""

from tidb_tpu_torch.lint.flow.analysis import FlowAnalysis


def flow_of(forest) -> FlowAnalysis:
    """The forest's flow analysis, computed once and memoized on the
    forest instance (all three flow rules, and the runtime sanitizer's
    DAG export, share the same facts)."""
    fl = getattr(forest, "_flow_analysis", None)
    if fl is None:
        fl = FlowAnalysis(forest)
        forest._flow_analysis = fl
    return fl


__all__ = ["FlowAnalysis", "flow_of"]
