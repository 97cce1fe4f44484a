"""Root-side operators of the SELECT path: the ports of the JAX package's
FinalAggExec, SelectionExec, ProjectionExec, LimitExec, SortExec,
TopNExec, ValuesExec and PointGetExec (executor/__init__.py).

Each takes its child operators and the fields of its plan node as
arguments, as HashAgg and HashJoin do (executor/builder.py lowers the
plan onto them), and yields Chunks from `chunks(ctx)`. `schema` is the
list of the plan's output SchemaCols (plan/resolver.py). They run on the
host: the device work of a query sits below them (the coprocessor's
partial aggregates, HashAgg, HashJoin, StreamAgg).
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch import codec, config, memtrack, tablecodec
from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.executor.agg import _empty_agg_value, _results_chunk
from tidb_tpu_torch.ops.hashagg import HashAggregator
from tidb_tpu_torch.ops.runtime import eval_filter_host
from tidb_tpu_torch.sqltypes import (EvalType, format_datetime, np_dtype_for,
                                     object_fill, scaled_to_decimal)
from tidb_tpu_torch.table import kvrows_to_chunk

__all__ = ["FinalAgg", "Selection", "Projection", "Limit", "Sort", "TopN",
           "Values", "PointGet", "Union"]


class FinalAgg:
    """Merges the storage-side partial aggregates a TableReader streams
    (the coprocessor's per-region GroupResults) into the final rows."""

    def __init__(self, reader, aggs, num_group_cols: int, schema):
        self.reader = reader
        self.aggs = list(aggs)
        self.num_group_cols = num_group_cols
        self.schema = list(schema)

    def chunks(self, ctx):
        # partials arrive pre-grouped: the key types are the schema's
        # leading num_group_cols columns
        agg = HashAggregator(
            self.aggs, [c.ft for c in self.schema[:self.num_group_cols]])
        tracked = 0
        try:
            for gr in self.reader.partials(ctx):
                agg.update(gr)
                tracked = memtrack.track_to(self, agg.approx_bytes(),
                                            tracked)
            results = agg.results()
            if not self.num_group_cols and not results:
                results = [((), [_empty_agg_value(a) for a in self.aggs])]
            yield _results_chunk(self.schema, results)
        finally:
            memtrack.release(self, host=tracked)


class Selection:
    def __init__(self, child, cond, schema):
        self.child = child
        self.cond = cond
        self.schema = list(schema)

    def chunks(self, ctx):
        for chunk in self.child.chunks(ctx):
            yield chunk.filter(eval_filter_host(self.cond, chunk))


class Projection:
    def __init__(self, child, exprs, schema):
        self.child = child
        self.exprs = list(exprs)
        self.schema = list(schema)

    def chunks(self, ctx):
        fts = [c.ft for c in self.schema]
        for chunk in self.child.chunks(ctx):
            cols = []
            for e, ft in zip(self.exprs, fts):
                d, v = e.eval(chunk)
                if d.dtype != np.dtype(object):
                    want = np_dtype_for(ft.tp, ft.flen)
                    if d.dtype != want:
                        d = d.astype(want)
                cols.append(Column(ft, d, v.copy()))
            yield Chunk(cols)


class Limit:
    def __init__(self, child, count: int, offset: int, schema):
        self.child = child
        self.count = count
        self.offset = offset
        self.schema = list(schema)

    def chunks(self, ctx):
        skip = self.offset
        left = self.count
        for chunk in self.child.chunks(ctx):
            if skip >= chunk.num_rows:
                skip -= chunk.num_rows
                continue
            if skip:
                chunk = chunk.slice(skip, chunk.num_rows)
                skip = 0
            if chunk.num_rows > left:
                chunk = chunk.slice(0, left)
            left -= chunk.num_rows
            yield chunk
            if left <= 0:
                return


def _sort_order(by, chunk) -> np.ndarray:
    """-> int64 permutation ordering chunk rows by the sort items. NULLs
    first ascending, last descending (MySQL)."""
    from tidb_tpu_torch.executor.extsort import order_from_keys
    keys = []
    for e, desc in by:
        d, v = e.eval(chunk)
        if e.ft.is_ci and np.asarray(d).dtype == np.dtype(object):
            from tidb_tpu_torch.sqltypes import fold_column
            d = fold_column(np.asarray(d))   # _ci ordering
        keys.append((d, v, desc))
    return order_from_keys(keys, chunk.num_rows)


class Sort:
    """Sort with spill-to-disk: below tidb_tpu_sort_spill_rows one
    in-memory lexsort; above it, rows spill to runs while the keys stay
    resident (executor/extsort.py)."""

    def __init__(self, child, by, schema):
        self.child = child
        self.by = list(by)
        self.schema = list(schema)

    def chunks(self, ctx):
        from tidb_tpu_torch.executor.extsort import SpillSorter
        # the sorter bills this operator and registers a quota spill
        # action: crossing tidb_tpu_mem_quota_query sheds the buffered
        # rows to disk instead of cancelling
        sorter = SpillSorter(self.by, run_rows=config.sort_spill_rows(),
                             tracker=memtrack.op_node(self))
        try:
            empty = None
            for chunk in self.child.chunks(ctx):
                if chunk.num_rows == 0:
                    empty = chunk
                    continue
                sorter.add(chunk)
            n = 0
            for out in sorter.sorted_chunks():
                n += out.num_rows
                yield out
            if n == 0 and empty is not None:
                yield empty
        finally:
            ctx.stats.sort_spilled_runs += sorter.spilled_runs
            sorter.close()


class TopN:
    """Keeps the best count + offset rows over the child's chunks."""

    def __init__(self, child, by, count: int, offset: int, schema):
        self.child = child
        self.by = list(by)
        self.count = count
        self.offset = offset
        self.schema = list(schema)

    def chunks(self, ctx):
        n = self.count + self.offset
        best = None
        tracked = 0
        try:
            for chunk in self.child.chunks(ctx):
                cand = chunk if best is None else best.concat(chunk)
                if cand.num_rows > 0:
                    best = cand.take(_sort_order(self.by, cand)[:n])
                else:
                    best = cand
                tracked = memtrack.track_to(
                    self, memtrack.chunk_bytes(best), tracked)
            if best is None:
                return
            yield best.slice(min(self.offset, best.num_rows),
                             best.num_rows)
        finally:
            memtrack.release(self, host=tracked)


class Values:
    """Constant rows: SELECT without FROM, the catalog memtables, and an
    INSERT ... VALUES source."""

    def __init__(self, rows, schema):
        self.rows = rows
        self.schema = list(schema)

    def chunks(self, ctx):
        fts = [c.ft for c in self.schema]
        rows = []
        for rexprs in self.rows:
            row = []
            for e in rexprs:
                d, v = e.eval_xp(np, [], 1)
                row.append(None if not v[0] else
                           (d[0].item() if hasattr(d[0], "item") else d[0]))
            rows.append(row)
        if not fts and rows:
            fts = [e.ft for e in self.rows[0]]
        cols = []
        for j, ft in enumerate(fts):
            dtype = np_dtype_for(ft.tp, ft.flen)
            valid = np.array([r[j] is not None for r in rows], dtype=bool)
            fill = object_fill(ft) if dtype == np.dtype(object) else 0
            data = np.array([fill if r[j] is None else r[j] for r in rows],
                            dtype=dtype)
            cols.append(Column(ft, data, valid))
        yield Chunk(cols)


class PointGet:
    """Single-row read by handle or unique-index point, bypassing the
    coprocessor; reads through the statement's transaction where there
    is one, so its own writes are visible."""

    def __init__(self, table, cols, handle_col, handle, index,
                 index_values, filter, schema):
        self.table = table
        self.cols = list(cols)
        self.handle_col = handle_col
        self.handle = handle
        self.index = index
        self.index_values = index_values
        self.filter = filter
        self.schema = list(schema)

    def chunks(self, ctx):
        retr = ctx.txn if ctx.txn is not None \
            else ctx.storage.snapshot(ctx.read_ts)
        handle = self.handle
        if self.index is not None:
            ik = tablecodec.index_key(self.table.id, self.index.id,
                                      list(self.index_values))
            v = retr.get(ik)
            if v is None:
                yield kvrows_to_chunk(self.table, self.cols, [],
                                      self.handle_col)
                return
            handle, _ = codec.decode_int(v, 0)
        rk = tablecodec.record_key(self.table.id, handle)
        raw = retr.get(rk)
        kvrows = [] if raw is None else [(rk, raw)]
        chunk = kvrows_to_chunk(self.table, self.cols, kvrows,
                                self.handle_col)
        if self.filter is not None and chunk.num_rows:
            chunk = chunk.filter(eval_filter_host(self.filter, chunk))
        yield chunk


class Union:
    """UNION ALL over the children's chunk streams, in order, each column
    coerced to the union's output type (MySQL's widening: to a string
    where any branch is a string, to the common decimal scale, to a
    double); DISTINCT is a HashAgg the planner puts on top."""

    def __init__(self, children, schema):
        self.children = list(children)
        self.schema = list(schema)

    @staticmethod
    def _coerce(c: Column, ft) -> Column:
        d, src = c.data, c.ft
        if ft.eval_type == EvalType.STRING and \
                src.eval_type != EvalType.STRING:
            # a mixed string/numeric union: MySQL coerces to a string
            if src.eval_type == EvalType.DECIMAL:
                vals = [str(scaled_to_decimal(int(x), src.frac))
                        for x in d]
            elif src.eval_type == EvalType.DATETIME:
                vals = [format_datetime(int(x), src.tp) for x in d]
            elif d.dtype == np.float64:
                vals = [repr(float(x)) for x in d]
            else:
                vals = [str(int(x)) for x in d]
            return Column(ft, np.array(vals, dtype=object), c.valid.copy())
        if ft.eval_type == EvalType.DECIMAL:
            if src.eval_type == EvalType.DECIMAL:
                if ft.frac > src.frac:
                    d = d.astype(np.int64) * np.int64(
                        10 ** (ft.frac - src.frac))
            elif src.eval_type == EvalType.INT:
                d = d.astype(np.int64) * np.int64(10 ** ft.frac)
        elif ft.eval_type == EvalType.REAL:
            if src.eval_type == EvalType.DECIMAL:
                d = d.astype(np.float64) / (10.0 ** src.frac)
            elif d.dtype != np.float64 and d.dtype != np.dtype(object):
                d = d.astype(np.float64)
        else:
            want = np_dtype_for(ft.tp, ft.flen)
            if d.dtype != want:
                d = d.astype(want)
        return Column(ft, d, c.valid.copy())

    def chunks(self, ctx):
        fts = [c.ft for c in self.schema]
        for child in self.children:
            for chunk in child.chunks(ctx):
                yield Chunk([self._coerce(c, ft)
                             for c, ft in zip(chunk.columns, fts)])
