"""The write executors: the ports of the JAX package's InsertExec,
UpdateExec, DeleteExec, MultiUpdateExec and MultiDeleteExec
(executor/__init__.py; ref: executor/write.go:896 InsertExec, duplicate
handling :1343; :479 multi-table UpdateExec; :194 deleteMultiTables).

`Insert.execute(ctx)` writes each source row into `ctx.txn` through
table.Table.add_record (record and index keys, auto-increment ids from
the meta layer) and returns the affected-row count. The source is a
literal VALUES list (evaluated per cell; a None expression is the
DEFAULT keyword) or any SELECT operator (INSERT ... SELECT). A duplicate
key is skipped (IGNORE), replaced (REPLACE) or updated (ON DUPLICATE KEY
UPDATE, over [old row | candidate row] so VALUES(col) reads the
candidate), else raised.

`Update.execute(ctx)` and `Delete.execute(ctx)` read the target rows
through their reader (a scan emitting the full row plus the handle;
inside a transaction through its union store) and rewrite or remove
each through table.Table, which keeps every writable index in step. An
UPDATE that moves an integer primary key is a delete plus an insert with
the duplicate check. The assignments are evaluated once per chunk on
the host chunk, and each chunk's lanes are read back once (`tolist`),
never per row. The multi-table forms walk the join result once and
write each target row once (deduplicated per handle).
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch import codec, tablecodec
from tidb_tpu_torch.chunk import Chunk
from tidb_tpu_torch.executor import ExecError
from tidb_tpu_torch.sqltypes import EvalType
from tidb_tpu_torch.table import (DupKeyError, Table, encode_datum_for_col,
                                  rows_to_chunk)

__all__ = ["Insert", "Update", "Delete", "MultiUpdate", "MultiDelete"]


class Insert:
    def __init__(self, table, columns, source, values_rows=None,
                 on_duplicate=(), is_replace: bool = False,
                 ignore: bool = False):
        self.table = table                # TableInfo
        self.columns = list(columns)      # target column names, in order
        self.source = source              # operator, or None for VALUES
        self.values_rows = values_rows    # [[Expression | None]]
        self.on_duplicate = list(on_duplicate)
        self.is_replace = is_replace
        self.ignore = ignore

    def execute(self, ctx) -> int:
        tbl = Table(self.table, ctx.storage)
        txn = ctx.txn
        affected = 0
        for values in self._source_rows(ctx):
            try:
                tbl.add_record(txn, values)
                affected += 1
            except DupKeyError:
                if self.ignore:
                    continue
                if self.is_replace or self.on_duplicate:
                    affected += self._handle_dup(tbl, txn, values)
                    continue
                raise
        if tbl.first_alloc_id is not None:
            # LAST_INSERT_ID(): first auto value of this statement
            ctx.last_insert_id = tbl.first_alloc_id
        return affected

    def _source_rows(self, ctx):
        """Yields {col_name: value} dicts; a key present with None is an
        explicit NULL, an absent key means 'use the default' (DEFAULT
        keyword or omitted column)."""
        if self.source is None:
            for rexprs in self.values_rows:
                values = {}
                for cname, e in zip(self.columns, rexprs):
                    if e is None:      # DEFAULT keyword
                        continue
                    d, v = e.eval_xp(np, [], 1)
                    if not v[0]:
                        values[cname] = None
                    elif e.ft.eval_type == EvalType.DECIMAL:
                        values[cname] = (e.ft.frac, int(d[0]))
                    else:
                        values[cname] = d[0].item() \
                            if hasattr(d[0], "item") else d[0]
                yield values
            return
        for chunk in self.source.chunks(ctx):
            src_cols = chunk.columns
            for i in range(chunk.num_rows):
                values = {}
                for cname, col in zip(self.columns, src_cols):
                    if not col.valid[i]:
                        values[cname] = None   # explicit NULL
                        continue
                    v = col.data[i]
                    if col.ft.eval_type == EvalType.DECIMAL:
                        # scaled at the SOURCE column's frac; the target
                        # frac conversion happens in encode_datum_for_col
                        values[cname] = (col.ft.frac, int(v))
                    else:
                        values[cname] = v.item() if hasattr(v, "item") \
                            else v
                yield values

    def _handle_dup(self, tbl: Table, txn, values) -> int:
        """REPLACE / ON DUPLICATE KEY UPDATE: find the conflicting row."""
        info = self.table
        handle = self._find_conflict(tbl, txn, values)
        if handle is None:
            raise ExecError("duplicate row vanished")
        old = tbl.row_by_handle(txn, handle)
        if self.is_replace:
            tbl.remove_record(txn, handle, old)
            tbl.add_record(txn, values)
            return 2
        cols = info.public_columns()
        cand = []
        for c in cols:
            cn = c.name.lower()
            if cn in values:
                cand.append(encode_datum_for_col(values[cn], c.ft))
            elif c.has_default:
                cand.append(encode_datum_for_col(c.default, c.ft))
            else:
                cand.append(None)
        row_chunk = rows_to_chunk(
            [c.ft for c in cols] * 2,
            [[old.get(c.id) for c in cols] + cand])
        new_vals = {}
        for cname, expr in self.on_duplicate:
            d, v = expr.eval(row_chunk)
            ci = info.col_by_name(cname)
            if not v[0]:
                new_vals[cname] = None
            elif ci.ft.eval_type == EvalType.DECIMAL:
                new_vals[cname] = (expr.ft.frac if
                                   expr.ft.eval_type == EvalType.DECIMAL
                                   else ci.ft.frac, int(d[0]))
            else:
                new_vals[cname] = d[0].item() if hasattr(d[0], "item") \
                    else d[0]
        tbl.update_record(txn, handle, old, new_vals)
        return 2

    def _find_conflict(self, tbl: Table, txn, values):
        info = self.table
        if info.pk_is_handle:
            v = values.get(info.pk_col_name.lower())
            if v is not None and tbl.row_by_handle(txn, int(v)) is not None:
                return int(v)
        for idx in info.indexes:
            if not idx.unique:
                continue
            vals = []
            for cn in idx.columns:
                ci = info.col_by_name(cn)
                v = encode_datum_for_col(values.get(cn.lower()), ci.ft)
                if ci.ft.is_ci and isinstance(v, str):
                    from tidb_tpu_torch.sqltypes import collation_key
                    v = collation_key(v)
                vals.append(v)
            if any(v is None for v in vals):
                continue
            raw = txn.get(tablecodec.index_key(info.id, idx.id, vals))
            if raw is not None:
                return codec.decode_int(raw)[0]
        return None


def _index_datum(v, ft):
    """numpy scalar -> the datum representation codec.encode_key expects
    for an index column of FieldType ft."""
    if ft.eval_type == EvalType.DECIMAL:
        return (ft.frac, int(v))
    if isinstance(v, (np.integer, int)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        return float(v)
    return v


def _row_datums(chunk: Chunk, cols):
    """A reader chunk's first len(cols) columns -> a function of the row
    giving {col_id: KV datum} (for index maintenance), the lanes read
    back once per chunk (the JAX package's _chunk_row_to_kvdatums reads
    each cell)."""
    lanes = []
    for j, ci in enumerate(cols):
        c = chunk.columns[j]
        dec = ci.ft.eval_type == EvalType.DECIMAL
        lanes.append((ci.id, c.valid.tolist(), c.data.tolist(), dec,
                      ci.ft.frac))

    def row(i: int) -> dict:
        out = {}
        for cid, valid, data, dec, frac in lanes:
            if not valid[i]:
                out[cid] = None
            elif dec:
                out[cid] = (frac, int(data[i]))
            else:
                out[cid] = data[i]
        return out
    return row


def _assigned(info, assignments, chunk: Chunk):
    """The assignments evaluated over `chunk` -> a function of the row
    giving {col_name: new python value} (DECIMAL as (frac, scaled))."""
    lanes = []
    for cname, expr in assignments:
        d, v = expr.eval(chunk)
        ci = info.col_by_name(cname)
        frac = None
        if ci.ft.eval_type == EvalType.DECIMAL:
            frac = expr.ft.frac if expr.ft.eval_type == EvalType.DECIMAL \
                else ci.ft.frac
        lanes.append((cname, np.asarray(v).tolist(),
                      np.asarray(d).tolist(), frac))

    def row(i: int) -> dict:
        out = {}
        for cname, valid, data, frac in lanes:
            if not valid[i]:
                out[cname] = None
            elif frac is not None:
                out[cname] = (frac, int(data[i]))
            else:
                out[cname] = data[i]
        return out
    return row


def _write_row(tbl: Table, txn, cols, pk_name, handle: int, old: dict,
               new_vals: dict) -> None:
    """Rewrite one row; a new integer primary key moves it (delete, then
    insert with the duplicate check) instead of rewriting it under the
    old handle."""
    if pk_name is not None and new_vals.get(pk_name) is not None and \
            int(new_vals[pk_name]) != handle:
        merged = {c.name.lower(): old.get(c.id) for c in cols}
        merged.update(new_vals)
        tbl.remove_record(txn, handle, old)
        tbl.add_record(txn, merged)
    else:
        tbl.update_record(txn, handle, old, new_vals)


def _pk_name(info):
    return info.pk_col_name.lower() if info.pk_is_handle else None


class Update:
    """UPDATE of one table: `reader` emits the full row plus the handle
    (last column); `assignments` are [(col_name, Expression)]."""

    def __init__(self, table, reader, assignments):
        self.table = table
        self.reader = reader
        self.assignments = list(assignments)

    def execute(self, ctx) -> int:
        info = self.table
        tbl = Table(info, ctx.storage)
        cols = info.public_columns()
        pk_name = _pk_name(info)
        affected = 0
        for chunk in self.reader.chunks(ctx):
            if chunk.num_rows == 0:
                continue
            handles = chunk.columns[-1].data.tolist()
            old_of = _row_datums(chunk, cols)
            new_of = _assigned(info, self.assignments, chunk)
            for i, handle in enumerate(handles):
                _write_row(tbl, ctx.txn, cols, pk_name, int(handle),
                           old_of(i), new_of(i))
                affected += 1
        return affected


class Delete:
    """DELETE from one table over `reader` (full row plus handle)."""

    def __init__(self, table, reader):
        self.table = table
        self.reader = reader

    def execute(self, ctx) -> int:
        tbl = Table(self.table, ctx.storage)
        cols = self.table.public_columns()
        affected = 0
        for chunk in self.reader.chunks(ctx):
            if chunk.num_rows == 0:
                continue
            old_of = _row_datums(chunk, cols)
            for i, handle in enumerate(chunk.columns[-1].data.tolist()):
                tbl.remove_record(ctx.txn, int(handle), old_of(i))
                affected += 1
        return affected


class MultiUpdate:
    """UPDATE t1, t2 SET ...: one pass over the join result; each target
    updates its matched rows once; the assignments evaluate over the
    whole join row, so t1's new value may read t2's columns. `targets`
    are (TableInfo, first column, handle column, assignments)."""

    def __init__(self, targets, reader):
        self.targets = list(targets)
        self.reader = reader

    def execute(self, ctx) -> int:
        per_target = [(Table(info, ctx.storage), info, col_start,
                       handle_idx, assigns, set())
                      for info, col_start, handle_idx, assigns
                      in self.targets]
        affected = 0
        for chunk in self.reader.chunks(ctx):
            if chunk.num_rows == 0:
                continue
            for tbl, info, col_start, handle_idx, assigns, seen \
                    in per_target:
                hcol = chunk.columns[handle_idx]
                cols = info.public_columns()
                old_of = _row_datums(
                    Chunk(chunk.columns[col_start:col_start + len(cols)]),
                    cols)
                new_of = _assigned(info, assigns, chunk)
                pk_name = _pk_name(info)
                for i, (ok, handle) in enumerate(zip(
                        hcol.valid.tolist(), hcol.data.tolist())):
                    if not ok or handle in seen:
                        continue    # outer-join padding, or written
                    seen.add(handle)
                    _write_row(tbl, ctx.txn, cols, pk_name, int(handle),
                               old_of(i), new_of(i))
                    affected += 1
        return affected


class MultiDelete:
    """DELETE t1, t2 FROM <join>: one pass over the join result; each
    target deletes its matched rows once. `targets` are (TableInfo,
    first column, handle column)."""

    def __init__(self, targets, reader):
        self.targets = list(targets)
        self.reader = reader

    def execute(self, ctx) -> int:
        per_target = [(Table(info, ctx.storage), info, col_start,
                       handle_idx, set())
                      for info, col_start, handle_idx in self.targets]
        affected = 0
        for chunk in self.reader.chunks(ctx):
            for tbl, info, col_start, handle_idx, seen in per_target:
                hcol = chunk.columns[handle_idx]
                cols = info.public_columns()
                old_of = _row_datums(
                    Chunk(chunk.columns[col_start:col_start + len(cols)]),
                    cols)
                for i, (ok, handle) in enumerate(zip(
                        hcol.valid.tolist(), hcol.data.tolist())):
                    if not ok or handle in seen:
                        continue    # outer-join padding, or deleted
                    seen.add(handle)
                    tbl.remove_record(ctx.txn, int(handle), old_of(i))
                    affected += 1
        return affected
