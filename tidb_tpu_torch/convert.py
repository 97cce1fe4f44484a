"""Carry state across from the JAX package without importing it.

The port never imports the reference's types. A caller that holds both
(the parity tests) exports plain values from the reference's objects and
builds the port's from them: `chunk_from_arrays` takes a chunk's columns
as (type code, flen, frac, collation, data, valid) tuples, and
`expr_from` / `agg_from` rebuild an expression tree or an aggregate
descriptor by reading its attributes, never its class; `table_info_from`
carries a TableInfo through its JSON form and `cop_plan_from` a pushed
CopPlan with its expressions.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.expression import (AggDesc, AggFunc, ColumnRef, Constant,
                                       Op, ScalarFunc)
from tidb_tpu_torch.sqltypes import FieldType, TypeCode

__all__ = ["field_type", "chunk_from_arrays", "expr_from", "agg_from",
           "table_info_from", "cop_plan_from"]


def field_type(tp, flen: int = -1, frac: int = -1,
               collation: str = "utf8mb4_bin", flags: int = 0) -> FieldType:
    return FieldType(TypeCode(int(tp)), flags=int(flags), flen=int(flen),
                     frac=int(frac), collation=collation)


def chunk_from_arrays(columns) -> Chunk:
    """[(type code, flen, frac, collation, data ndarray, valid ndarray)]
    -> Chunk. The arrays are used as they are (no copy)."""
    cols = []
    for tp, flen, frac, collation, data, valid in columns:
        cols.append(Column(field_type(tp, flen, frac, collation),
                           np.asarray(data), np.asarray(valid, dtype=bool)))
    return Chunk(cols)


def _ft(ft) -> FieldType:
    return FieldType(TypeCode(int(ft.tp)), flags=int(ft.flags),
                     flen=int(ft.flen), frac=int(ft.frac),
                     charset=ft.charset, elems=tuple(ft.elems),
                     collation=ft.collation)


def expr_from(e):
    """A ColumnRef / Constant / ScalarFunc tree of either package -> the
    port's tree with the same structure, types and values."""
    if e is None:
        return None
    kind = type(e).__name__
    if kind == "ColumnRef":
        return ColumnRef(e.idx, _ft(e.ft), e.name)
    if kind == "Constant":
        return Constant(e.value, _ft(e.ft))
    if kind == "ScalarFunc":
        f = ScalarFunc.__new__(ScalarFunc)
        f.op = Op(e.op.value)
        f.args = [expr_from(a) for a in e.args]
        extra = e.extra
        f.extra = _ft(extra) if hasattr(extra, "tp") else extra
        f.ft = _ft(e.ft)
        return f
    raise TypeError(f"cannot carry a {kind} across")


def agg_from(a) -> AggDesc:
    return AggDesc(AggFunc(a.fn.value), expr_from(a.arg), a.distinct,
                   a.name, a.sep)


def table_info_from(info):
    """A TableInfo of either package -> the port's, through to_json (the
    form both packages store in their meta plane)."""
    from tidb_tpu_torch.schema.model import TableInfo
    return TableInfo.from_json(info.to_json())


def cop_plan_from(cop):
    """A CopPlan of either package -> the port's, with the same table,
    columns, ranges and expression trees."""
    from tidb_tpu_torch.kv import KVRange
    from tidb_tpu_torch.plan.physical import CopPlan
    from tidb_tpu_torch.schema.model import ColumnInfo, IndexInfo
    ranges = None if cop.ranges is None else \
        [KVRange(r.start, r.end) for r in cop.ranges]
    return CopPlan(
        table=table_info_from(cop.table),
        cols=[ColumnInfo.from_json(c.to_json()) for c in cop.cols],
        handle_col=cop.handle_col, ranges=ranges,
        filter=expr_from(cop.filter), host_filter=expr_from(cop.host_filter),
        group_exprs=None if cop.group_exprs is None else
        [expr_from(g) for g in cop.group_exprs],
        aggs=None if cop.aggs is None else [agg_from(a) for a in cop.aggs],
        limit=cop.limit, desc=cop.desc,
        index=None if cop.index is None else
        IndexInfo.from_json(cop.index.to_json()))
