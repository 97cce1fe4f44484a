"""Aggregate function descriptors and the partial/final protocol.

Reference: TiDB's expression/aggregation/aggregation.go:32-47 —
`Aggregation` iface with Update/GetPartialResult enabling the partial-agg
(storage-side) / final-agg (root-side) split used for pushdown.

Here the same split is expressed as data, not control flow: each AggFunc
defines its partial-state columns and a merge rule, so storage workers (and
device shards) produce partial-state chunks that any final aggregator —
numpy or a psum across a device mesh — can combine.

Partial states (all fixed-width, device-friendly):
    COUNT   -> [count:int64]                 merge: sum
    SUM     -> [sum, has:int64]              merge: sum, or
    AVG     -> [sum, count:int64]            merge: sum, sum
    MIN     -> [val, has:int64]              merge: min-where-has, or
    MAX     -> [val, has:int64]              merge: max-where-has, or
    FIRST   -> [val, has:int64]              merge: first-where-has
    BIT_AND/OR/XOR -> [val:int64]            merge: and/or/xor
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from tidb_tpu_torch.expression.core import Expression
from tidb_tpu_torch.sqltypes import (EvalType, FieldType, new_decimal_field,
                               new_double_field, new_int_field)

__all__ = ["AggFunc", "AggDesc"]


class AggFunc(Enum):
    COUNT = "count"
    SUM = "sum"
    AVG = "avg"
    MIN = "min"
    MAX = "max"
    FIRST_ROW = "firstrow"
    BIT_AND = "bit_and"
    BIT_OR = "bit_or"
    BIT_XOR = "bit_xor"
    GROUP_CONCAT = "group_concat"


@dataclass
class AggDesc:
    fn: AggFunc
    arg: Expression | None  # None for COUNT(*)
    distinct: bool = False
    name: str = ""
    sep: str = ","          # GROUP_CONCAT separator

    @property
    def result_ft(self) -> FieldType:
        if self.fn == AggFunc.COUNT:
            return new_int_field()
        if self.fn in (AggFunc.BIT_AND, AggFunc.BIT_OR, AggFunc.BIT_XOR):
            return new_int_field()
        if self.fn == AggFunc.GROUP_CONCAT:
            from tidb_tpu_torch.sqltypes import new_string_field
            return new_string_field()
        aft = self.arg.ft
        if self.fn == AggFunc.AVG:
            if aft.eval_type == EvalType.DECIMAL:
                if aft.is_wide_decimal:
                    # wide lane is exact python ints: MySQL's +4 digits
                    return new_decimal_field(
                        flen=min(aft.flen + 4, 65),
                        frac=min(aft.frac + 4, 30))
                # MySQL: avg adds 4 frac digits; we cap at 8 for int64 headroom
                return new_decimal_field(frac=min(aft.frac + 4, 8))
            return new_double_field()
        if self.fn == AggFunc.SUM:
            if aft.eval_type == EvalType.INT:
                return new_int_field()  # departure: MySQL promotes to decimal
            if aft.eval_type == EvalType.DECIMAL:
                # SUM widens precision (MySQL: DECIMAL(p+22, s)); a wide
                # arg keeps the exact object lane
                return new_decimal_field(
                    flen=min(aft.flen + 22, 65) if aft.is_wide_decimal
                    else aft.flen,
                    frac=aft.frac)
            return new_double_field()
        return aft  # MIN/MAX/FIRST keep the arg type

    @property
    def partial_width(self) -> int:
        """Number of int64/float64 lanes in this function's partial state."""
        if self.fn in (AggFunc.COUNT, AggFunc.BIT_AND, AggFunc.BIT_OR,
                       AggFunc.BIT_XOR):
            return 1
        return 2

    def __repr__(self):
        a = repr(self.arg) if self.arg is not None else "*"
        d = "distinct " if self.distinct else ""
        return f"{self.fn.value}({d}{a})"
