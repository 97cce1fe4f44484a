"""INSERT: the port of the JAX package's InsertExec (executor/__init__.py;
ref: executor/write.go:896 InsertExec, duplicate handling :1343).

`Insert.execute(ctx)` writes each source row into `ctx.txn` through
table.Table.add_record (record and index keys, auto-increment ids from
the meta layer) and returns the affected-row count. The source is a
literal VALUES list (evaluated per cell; a None expression is the
DEFAULT keyword) or any SELECT operator (INSERT ... SELECT). A duplicate
key is skipped (IGNORE), replaced (REPLACE) or updated (ON DUPLICATE KEY
UPDATE, over [old row | candidate row] so VALUES(col) reads the
candidate), else raised.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch import codec, tablecodec
from tidb_tpu_torch.executor import ExecError
from tidb_tpu_torch.sqltypes import EvalType
from tidb_tpu_torch.table import (DupKeyError, Table, encode_datum_for_col,
                                  rows_to_chunk)

__all__ = ["Insert"]


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
