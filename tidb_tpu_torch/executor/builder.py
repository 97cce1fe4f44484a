"""Lowering of physical plans (plan/physical.py) onto the port's
operators: the port of the JAX package's executor builder
(executor/__init__.py, build_executor and _BUILDERS; ref:
executorBuilder.build, builder.go:62-146).

The reference's executors read their plan node; the port's operators
take the node's fields as arguments, so each builder below carries every
field the reference's executor reads: a HashJoin gets its keys, join
type, other condition and the planner's probe-side CMSketch
(`probe_cms`, the hybrid join's heavy-hitter seed); a HashAgg over a
plain inner HashJoin fuses probe and partial aggregation per probe
superchunk (executor/agg.py). The plan's output schema (a list of
plan/resolver.SchemaCol) becomes the operator's `schema`.

Every node built passes through runtime_stats.instrument, which wraps
the operator's output methods for the statement's runtime-stats
collector and links the operator (and a reader's CopPlans) to the plan
node's stats and memtrack rows, as the reference's build_executor does
(executor/__init__.py:111).
"""

from __future__ import annotations

from tidb_tpu_torch import runtime_stats
from tidb_tpu_torch.executor import ExecError
from tidb_tpu_torch.executor.agg import HashAgg, StreamAgg
from tidb_tpu_torch.executor.apply import Apply
from tidb_tpu_torch.executor.join import HashJoin, IndexJoin, MergeJoin
from tidb_tpu_torch.executor.reader import (IndexLookUp, IndexReader,
                                            TableReader)
from tidb_tpu_torch.executor.root import (FinalAgg, Limit, PointGet,
                                          Projection, Selection, Sort, TopN,
                                          Union, Values)
from tidb_tpu_torch.executor.write import (Delete, Insert, MultiDelete,
                                           MultiUpdate, Update)
from tidb_tpu_torch.plan import physical as ph

__all__ = ["build"]


def build(plan):
    b = _BUILDERS.get(type(plan))
    if b is None:
        raise ExecError(f"no executor for {type(plan).__name__}")
    op = b(plan)
    # children are built (and wrapped) inside the builder above, so
    # every node of the tree passes through here once per execution
    runtime_stats.instrument(op, plan)
    return op


def _cols(plan) -> list:
    return list(plan.schema.cols)


def _table_reader(p: ph.PhysTableReader):
    op = TableReader(p.cop, keep_order=p.keep_order)
    op.schema = _cols(p)
    return op


def _index_reader(p: ph.PhysIndexReader):
    op = IndexReader(p.cop, keep_order=getattr(p, "keep_order", False))
    op.schema = _cols(p)
    return op


def _index_lookup(p: ph.PhysIndexLookUp):
    return IndexLookUp(p.index_cop, p.table_cop, p.keep_order, _cols(p))


def _point_get(p: ph.PhysPointGet):
    return PointGet(p.table, p.cols, p.handle_col, p.handle, p.index,
                    p.index_values, p.filter, _cols(p))


def _values(p: ph.PhysValues):
    return Values(p.rows, _cols(p))


def _final_agg(p: ph.PhysFinalAgg):
    return FinalAgg(build(p.children[0]), p.aggs, p.num_group_cols,
                    _cols(p))


def _hash_agg(p: ph.PhysHashAgg):
    op = HashAgg(build(p.children[0]), p.group_exprs, p.aggs, plan=p)
    op.schema = _cols(p)
    return op


def _stream_agg(p: ph.PhysStreamAgg):
    op = StreamAgg(build(p.children[0]), p.group_exprs, p.aggs,
                   sorted_input=p.sorted_input)
    op.schema = _cols(p)
    return op


def _hash_join(p: ph.PhysHashJoin):
    # a keyless join runs as a cross join (HashJoin._cross_join)
    op = HashJoin(build(p.children[0]), build(p.children[1]),
                  p.left_keys, p.right_keys, join_type=p.join_type,
                  other_cond=p.other_cond,
                  probe_cms=getattr(p, "probe_cms", None))
    op.schema = _cols(p)
    return op


def _merge_join(p: ph.PhysMergeJoin):
    op = MergeJoin(build(p.children[0]), build(p.children[1]),
                   p.left_keys, p.right_keys, join_type=p.join_type,
                   other_cond=p.other_cond)
    op.schema = _cols(p)
    return op


def _index_join(p: ph.PhysIndexJoin):
    # the inner reader carries the CopPlan and schema; it is never scanned
    op = IndexJoin(build(p.children[0]), build(p.children[1]),
                   p.left_keys, p.right_keys, p.inner_index,
                   join_type=p.join_type, other_cond=p.other_cond)
    op.schema = _cols(p)
    return op


def _apply(p: ph.PhysApply):
    return Apply(build(p.children[0]), p)


def _union(p: ph.PhysUnion):
    return Union([build(c) for c in p.children], _cols(p))


def _selection(p: ph.PhysSelection):
    return Selection(build(p.children[0]), p.cond, _cols(p))


def _projection(p: ph.PhysProjection):
    return Projection(build(p.children[0]), p.exprs, _cols(p))


def _limit(p: ph.PhysLimit):
    return Limit(build(p.children[0]), p.count, p.offset, _cols(p))


def _sort(p: ph.PhysSort):
    return Sort(build(p.children[0]), p.by, _cols(p))


def _topn(p: ph.PhysTopN):
    return TopN(build(p.children[0]), p.by, p.count, p.offset, _cols(p))


def _insert(p: ph.PhysInsert):
    src = p.source
    if isinstance(src, ph.PhysValues) and not src.schema.cols:
        # literal VALUES rows, evaluated per cell (None = DEFAULT)
        return Insert(p.table, p.columns, None, values_rows=src.rows,
                      on_duplicate=p.on_duplicate,
                      is_replace=p.is_replace, ignore=p.ignore)
    return Insert(p.table, p.columns, build(src),
                  on_duplicate=p.on_duplicate, is_replace=p.is_replace,
                  ignore=p.ignore)


def _update(p: ph.PhysUpdate):
    return Update(p.table, build(p.reader), p.assignments)


def _delete(p: ph.PhysDelete):
    return Delete(p.table, build(p.reader))


def _multi_update(p: ph.PhysMultiUpdate):
    return MultiUpdate(p.targets, build(p.reader))


def _multi_delete(p: ph.PhysMultiDelete):
    return MultiDelete(p.targets, build(p.reader))


_BUILDERS = {
    ph.PhysApply: _apply,
    ph.PhysUnion: _union,
    ph.PhysTableReader: _table_reader,
    ph.PhysIndexReader: _index_reader,
    ph.PhysIndexLookUp: _index_lookup,
    ph.PhysPointGet: _point_get,
    ph.PhysValues: _values,
    ph.PhysFinalAgg: _final_agg,
    ph.PhysHashAgg: _hash_agg,
    ph.PhysStreamAgg: _stream_agg,
    ph.PhysHashJoin: _hash_join,
    ph.PhysMergeJoin: _merge_join,
    ph.PhysIndexJoin: _index_join,
    ph.PhysSelection: _selection,
    ph.PhysProjection: _projection,
    ph.PhysLimit: _limit,
    ph.PhysSort: _sort,
    ph.PhysTopN: _topn,
    ph.PhysInsert: _insert,
    ph.PhysUpdate: _update,
    ph.PhysDelete: _delete,
    ph.PhysMultiUpdate: _multi_update,
    ph.PhysMultiDelete: _multi_delete,
}
