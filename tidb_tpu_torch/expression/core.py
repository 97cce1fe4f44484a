"""Scalar expression trees with columnar evaluation.

Reference: TiDB's expression/expression.go:35-75 (Expression iface
with 8 per-row EvalXxx methods) and expression/chunk_executor.go:29-100
(column-at-a-time driver that still dispatches row-scalar inside — the single
biggest CPU sink per SURVEY.md §3.2).

Columnar redesign: every builtin is implemented ONCE as a whole-column
function generic over the array namespace `xp` (numpy on the host path,
the torch namespace of ops/tnp.py on the device path). Evaluating an
expression over a Chunk is a handful of whole-column array ops, queued on
the device's stream. NULLs ride as a parallel boolean validity array (Kleene
logic for AND/OR, propagate-null elsewhere), replacing the reference's
per-value null tags.

Decimal columns are scaled int64 (sqltypes); this module inserts the scale
management (rescale on add/compare, scale-add on multiply, promote to double
on divide) that the reference's MyDecimal does per value.
"""

from __future__ import annotations

import math

from dataclasses import dataclass
from enum import Enum
from typing import Any, Sequence

import numpy as np
import torch

from tidb_tpu_torch.chunk import Chunk
from tidb_tpu_torch.sqltypes import (EvalType, FieldType, TypeCode,
                               decimal_to_scaled, new_double_field,
                               new_int_field, np_dtype_for)

__all__ = ["Expression", "ColumnRef", "Constant", "ScalarFunc", "Op",
           "col", "const", "func", "and_all"]


class Op(Enum):
    # arithmetic
    PLUS = "+"; MINUS = "-"; MUL = "*"; DIV = "/"; INTDIV = "div"; MOD = "%"
    UNARY_MINUS = "neg"
    # comparison
    EQ = "="; NE = "!="; LT = "<"; LE = "<="; GT = ">"; GE = ">="
    NULLEQ = "<=>"
    # logic
    AND = "and"; OR = "or"; NOT = "not"; XOR = "xor"
    # bit (on int64 two's complement; MySQL's BIGINT UNSIGNED domain is
    # shown signed here — same bits, doc'd in DEVIATIONS.md)
    BIT_AND = "&"; BIT_OR = "|"; BIT_XOR = "^"; SHL = "<<"; SHR = ">>"
    BIT_NEG = "~"
    # null tests
    IS_NULL = "isnull"; IS_NOT_NULL = "isnotnull"
    # membership / pattern
    IN = "in"; LIKE = "like"
    # control
    IF = "if"; IFNULL = "ifnull"; CASE = "case"; COALESCE = "coalesce"
    # math
    ABS = "abs"; CEIL = "ceil"; FLOOR = "floor"; ROUND = "round"
    POW = "pow"; SQRT = "sqrt"; EXP = "exp"; LN = "ln"; LOG2 = "log2"
    SIGN = "sign"
    # string (host-only)
    CONCAT = "concat"; LENGTH = "length"; UPPER = "upper"; LOWER = "lower"
    SUBSTRING = "substring"; TRIM = "trim"; LEFT = "left"; RIGHT = "right"
    REPLACE = "replace"; INSTR = "instr"; ASCII = "ascii"
    # date/time (on epoch-micros int64)
    YEAR = "year"; MONTH = "month"; DAY = "day"; HOUR = "hour"
    MINUTE = "minute"; SECOND = "second"
    DATE_ADD_DAYS = "date_add_days"; DATE_SUB_DAYS = "date_sub_days"
    DATEDIFF = "datediff"
    DATE_ADD_US = "date_add_us"     # fixed-width units as one micros delta
    ADD_MONTHS = "add_months"       # calendar-exact, day-clamping
    # cast
    CAST_INT = "cast_int"; CAST_REAL = "cast_real"; CAST_DECIMAL = "cast_decimal"
    CAST_STRING = "cast_string"
    # registry-dispatched long-tail builtins (expression/builtins.py);
    # extra = FnSpec
    GENERIC = "generic"


class Expression:
    """Base class. `ft` is the result FieldType."""

    ft: FieldType

    # -- evaluation ----------------------------------------------------------

    def eval(self, chunk: Chunk) -> tuple[np.ndarray, np.ndarray]:
        """Host path: returns (data, valid) numpy arrays of len(chunk)."""
        cols = [(c.data, c.valid) for c in chunk.columns]
        return self.eval_xp(np, cols, chunk.num_rows)

    def eval_xp(self, xp, cols: Sequence[tuple], n: int) -> tuple[Any, Any]:
        """Generic path: `cols[i]` is (data, valid) arrays in namespace xp.
        On the device path xp is a tnp namespace and arrays are tensors."""
        raise NotImplementedError

    # -- structure -----------------------------------------------------------

    def columns_used(self) -> set[int]:
        raise NotImplementedError

    def map_columns(self, mapping: dict[int, int]) -> "Expression":
        """Rewrite column indices (for projection pushdown)."""
        raise NotImplementedError

    def is_device_safe(self) -> bool:
        """True if the whole tree can run on the device (no varlen string ops)."""
        raise NotImplementedError

    # -- sugar ---------------------------------------------------------------

    def __add__(self, o): return func(Op.PLUS, self, _wrap(o))
    def __sub__(self, o): return func(Op.MINUS, self, _wrap(o))
    def __mul__(self, o): return func(Op.MUL, self, _wrap(o))
    def __truediv__(self, o): return func(Op.DIV, self, _wrap(o))
    def __neg__(self): return func(Op.UNARY_MINUS, self)

    def eq(self, o): return func(Op.EQ, self, _wrap(o))
    def ne(self, o): return func(Op.NE, self, _wrap(o))
    def lt(self, o): return func(Op.LT, self, _wrap(o))
    def le(self, o): return func(Op.LE, self, _wrap(o))
    def gt(self, o): return func(Op.GT, self, _wrap(o))
    def ge(self, o): return func(Op.GE, self, _wrap(o))


def _wrap(v) -> "Expression":
    return v if isinstance(v, Expression) else const(v)


@dataclass
class ColumnRef(Expression):
    idx: int
    ft: FieldType
    name: str = ""

    def eval_xp(self, xp, cols, n):
        return cols[self.idx]

    def columns_used(self):
        return {self.idx}

    def map_columns(self, mapping):
        return ColumnRef(mapping[self.idx], self.ft, self.name)

    def is_device_safe(self):
        return self.ft.fixed_width

    def __repr__(self):
        return self.name or f"col#{self.idx}"

    def __hash__(self):
        return hash(("col", self.idx))


class CorrelatedCol(Expression):
    """A reference to an OUTER query's column inside a subquery plan
    (ref: expression.CorrelatedColumn — a column whose value is bound per
    outer row by the apply executor). `cell` is the shared mutable
    [value, valid] slot the ApplyExec writes before each inner run; values
    live in the chunk layer (raw int64/float64/str; decimals scaled)."""

    def __init__(self, ft: FieldType, name: str = ""):
        self.ft = ft
        self.name = name
        self.cell = [None, False]

    def eval_xp(self, xp, cols, n):
        import numpy as _np
        v, valid = self.cell
        dtype = np_dtype_for(self.ft.tp, self.ft.flen)
        if not valid:
            data = _np.zeros(n, dtype=dtype) if dtype != _np.dtype(object) \
                else _np.full(n, "", dtype=object)
            return xp.asarray(data) if dtype != _np.dtype(object) else data, \
                (xp.zeros(n, dtype=bool) if xp is not _np
                 else _np.zeros(n, dtype=bool))
        if dtype == _np.dtype(object):
            return _np.full(n, v, dtype=object), _np.ones(n, dtype=bool)
        data = _np.full(n, v, dtype=dtype)
        return xp.asarray(data), (xp.ones(n, dtype=bool) if xp is not _np
                                  else _np.ones(n, dtype=bool))

    def columns_used(self):
        return set()            # references the OUTER plan, not this one

    def map_columns(self, mapping):
        return self

    def is_device_safe(self):
        return False            # rebound per outer row: host path only

    def __repr__(self):
        return f"corr({self.name or '?'})"


@dataclass
class Constant(Expression):
    value: Any
    ft: FieldType

    def eval_xp(self, xp, cols, n):
        if self.value is None:
            return xp.zeros(n, dtype=np.int64), xp.zeros(n, dtype=bool)
        v = self.value
        if self.ft.tp == TypeCode.NEWDECIMAL:
            v = decimal_to_scaled(v, self.ft.frac,
                                  wide=self.ft.is_wide_decimal)
        dtype = np_dtype_for(self.ft.tp, self.ft.flen)
        if dtype == np.dtype(object):
            data = np.full(n, v, dtype=object)  # host-only
            return data, np.ones(n, dtype=bool)
        return xp.full(n, v, dtype=dtype), xp.ones(n, dtype=bool)

    def columns_used(self):
        return set()

    def map_columns(self, mapping):
        return self

    def is_device_safe(self):
        return self.ft.fixed_width

    def __repr__(self):
        return repr(self.value)

    def __hash__(self):
        return hash(("const", str(self.value)))


def const(v, ft: FieldType | None = None) -> Constant:
    import decimal as _d
    import datetime as _dt
    from tidb_tpu_torch import sqltypes as st
    if ft is None:
        if v is None:
            ft = new_int_field()
        elif isinstance(v, bool):
            v, ft = int(v), new_int_field()
        elif isinstance(v, (int, np.integer)):
            if not (-(1 << 63) <= int(v) < (1 << 63)):
                # beyond BIGINT: promote to wide DECIMAL like MySQL —
                # exact against wide-decimal columns; comparisons vs
                # int columns still fold in _fold_huge_int_cmp
                import decimal as _d2
                v = _d2.Decimal(int(v))
                ft = st.new_decimal_field(
                    flen=len(v.as_tuple().digits), frac=0)
            else:
                ft = new_int_field()
        elif isinstance(v, (float, np.floating)):
            ft = new_double_field()
        elif isinstance(v, _d.Decimal):
            t = v.as_tuple()
            frac = max(0, -t.exponent)
            # magnitude digits: positive exponents (1E+30) add width
            digits = len(t.digits) + max(t.exponent, 0)
            ft = st.new_decimal_field(flen=max(digits, 15), frac=frac)
        elif isinstance(v, str):
            ft = st.new_string_field()
        elif isinstance(v, _dt.datetime):
            ft, v = st.new_datetime_field(), st.datetime_to_micros(v)
        elif isinstance(v, _dt.date):
            ft, v = st.new_date_field(), st.date_to_micros(v)
        else:
            raise TypeError(f"cannot infer type of constant {v!r}")
    return Constant(v, ft)


def col(idx: int, ft: FieldType, name: str = "") -> ColumnRef:
    return ColumnRef(idx, ft, name)


# ---------------------------------------------------------------------------
# ScalarFunc

_ARITH = {Op.PLUS, Op.MINUS, Op.MUL, Op.DIV, Op.INTDIV, Op.MOD}
_BIT = {Op.BIT_AND, Op.BIT_OR, Op.BIT_XOR, Op.SHL, Op.SHR, Op.BIT_NEG}
_CMP = {Op.EQ, Op.NE, Op.LT, Op.LE, Op.GT, Op.GE, Op.NULLEQ}
_LOGIC = {Op.AND, Op.OR, Op.NOT, Op.XOR}
_STRING_OPS = {Op.CONCAT, Op.LENGTH, Op.UPPER, Op.LOWER, Op.SUBSTRING,
               Op.TRIM, Op.LEFT, Op.RIGHT, Op.REPLACE, Op.INSTR, Op.ASCII,
               Op.LIKE}
_MATH = {Op.ABS, Op.CEIL, Op.FLOOR, Op.ROUND, Op.POW, Op.SQRT, Op.EXP,
         Op.LN, Op.LOG2, Op.SIGN}
_TIME_OPS = {Op.YEAR, Op.MONTH, Op.DAY, Op.HOUR, Op.MINUTE, Op.SECOND,
             Op.DATE_ADD_DAYS, Op.DATE_SUB_DAYS, Op.DATEDIFF,
             Op.DATE_ADD_US, Op.ADD_MONTHS}
_DATE_SHIFT = {Op.DATE_ADD_DAYS, Op.DATE_SUB_DAYS, Op.DATE_ADD_US,
               Op.ADD_MONTHS}

_MAX_DEC_FRAC = 9  # cap result frac on multiply to bound int64 range


class ScalarFunc(Expression):
    def __init__(self, op: Op, args: Sequence[Expression], extra: Any = None):
        self.op = op
        self.args = list(args)
        self.extra = extra  # e.g. IN value list, LIKE pattern, cast target ft
        self.ft = self._infer_type()

    # -- typing --------------------------------------------------------------

    def _infer_type(self) -> FieldType:
        op = self.op
        if op == Op.GENERIC:
            return self.extra.result_ft(self.args)
        if op in _CMP or op in _LOGIC or op in (Op.IS_NULL, Op.IS_NOT_NULL,
                                                Op.IN, Op.LIKE):
            return new_int_field()
        if op in (Op.LENGTH, Op.INSTR, Op.ASCII) or \
                op in _TIME_OPS and op not in _DATE_SHIFT:
            return new_int_field()
        if op in _DATE_SHIFT:
            return self.args[0].ft
        if op == Op.CAST_INT:
            return new_int_field()
        if op == Op.CAST_REAL:
            return new_double_field()
        if op == Op.CAST_DECIMAL:
            return self.extra
        if op == Op.CAST_STRING:
            from tidb_tpu_torch.sqltypes import new_string_field
            return new_string_field()
        if op in (Op.CONCAT, Op.UPPER, Op.LOWER, Op.SUBSTRING, Op.TRIM,
                  Op.LEFT, Op.RIGHT, Op.REPLACE):
            from tidb_tpu_torch.sqltypes import new_string_field
            return new_string_field()
        if op in (Op.SQRT, Op.EXP, Op.LN, Op.LOG2, Op.POW):
            return new_double_field()
        if op == Op.UNARY_MINUS or op in (Op.ABS, Op.SIGN, Op.CEIL, Op.FLOOR,
                                          Op.ROUND):
            base = self.args[0].ft
            if op in (Op.CEIL, Op.FLOOR) and base.eval_type != EvalType.INT:
                return new_int_field() if base.eval_type == EvalType.DECIMAL else base
            return base
        if op in (Op.IF,):
            return self._merge_types(self.args[1:])
        if op in (Op.IFNULL, Op.COALESCE, Op.CASE):
            if op == Op.CASE:
                # args: [cond1, val1, cond2, val2, ..., else?]
                vals = [self.args[i] for i in range(1, len(self.args), 2)]
                if len(self.args) % 2 == 1:
                    vals.append(self.args[-1])
                return self._merge_types(vals)
            return self._merge_types(self.args)
        if op in _ARITH:
            return self._arith_type()
        if op in _BIT:
            return new_int_field()
        raise ValueError(f"cannot type op {op}")

    def _merge_types(self, exprs) -> FieldType:
        ets = [e.ft.eval_type for e in exprs]
        if EvalType.STRING in ets:
            from tidb_tpu_torch.sqltypes import new_string_field
            return new_string_field()
        if EvalType.REAL in ets:
            return new_double_field()
        if EvalType.DECIMAL in ets:
            frac = max(e.ft.frac for e in exprs if e.ft.eval_type == EvalType.DECIMAL)
            from tidb_tpu_torch.sqltypes import new_decimal_field
            return new_decimal_field(frac=frac)
        if EvalType.DATETIME in ets:
            return exprs[0].ft
        return new_int_field()

    def _arith_type(self) -> FieldType:
        from tidb_tpu_torch.sqltypes import new_decimal_field
        a = self.args[0].ft
        b = self.args[1].ft if len(self.args) > 1 else a
        ea, eb = a.eval_type, b.eval_type
        if self.op == Op.DIV:
            return new_double_field()  # departure from MySQL decimal-div; doc'd
        if self.op == Op.INTDIV:
            return new_int_field()
        if EvalType.REAL in (ea, eb):
            return new_double_field()
        if EvalType.DECIMAL in (ea, eb):
            fa = a.frac if ea == EvalType.DECIMAL else 0
            fb = b.frac if eb == EvalType.DECIMAL else 0
            # a WIDE argument makes the result wide (exact bignum lane:
            # 25-digit * 28-digit literals must not squeeze into int64);
            # all-narrow chains stay on the int64 device lane
            any_wide = a.is_wide_decimal or b.is_wide_decimal
            la = a.flen if ea == EvalType.DECIMAL and a.flen > 0 else 19
            lb = b.flen if eb == EvalType.DECIMAL and b.flen > 0 else 19
            if self.op == Op.MUL:
                if any_wide:
                    return new_decimal_field(flen=min(la + lb, 65),
                                             frac=min(fa + fb, 30))
                return new_decimal_field(
                    frac=min(fa + fb, _MAX_DEC_FRAC))
            if any_wide:
                return new_decimal_field(flen=min(max(la, lb) + 1, 65),
                                         frac=max(fa, fb))
            return new_decimal_field(frac=max(fa, fb))
        if EvalType.DATETIME in (ea, eb):
            return new_int_field()
        return new_int_field()

    # -- evaluation ----------------------------------------------------------

    def eval_xp(self, xp, cols, n):
        op = self.op
        if op in _CMP:
            folded = self._fold_huge_int_cmp(xp, cols, n)
            if folded is not None:
                return folded
        argv = [a.eval_xp(xp, cols, n) for a in self.args]

        if op == Op.GENERIC:
            if xp is not np:
                raise RuntimeError(
                    f"builtin {self.extra.name} is host-only")
            return self.extra.fn(self.args, argv, n)
        if op in _LOGIC:
            return _eval_logic(xp, op, argv, n)
        if op == Op.IS_NULL:
            d, v = argv[0]
            return (~v).astype(np.int64) if xp is np else xp.asarray(~v, dtype=np.int64), _ones(xp, n)
        if op == Op.IS_NOT_NULL:
            d, v = argv[0]
            return v.astype(np.int64) if xp is np else xp.asarray(v, dtype=np.int64), _ones(xp, n)
        if op == Op.IN:
            return self._eval_in(xp, argv, n)
        if op in _STRING_OPS:
            if xp is not np:
                raise RuntimeError(f"string op {op} is host-only")
            return _eval_string(self, argv, n)
        if op in (Op.IF, Op.IFNULL, Op.COALESCE, Op.CASE):
            return self._eval_control(xp, argv, n)

        # numeric family: unify operand representation first
        datas, valids = zip(*argv) if argv else ((), ())
        valid = _and_valid(xp, valids, n)
        if op in _ARITH or op in _MATH or op in _BIT or \
                op == Op.UNARY_MINUS:
            # ENUM in numeric context evaluates as its 1-based member
            # index (MySQL: c + 0 -> ordinal)
            datas = [_enum_ordinals(a.ft, d)
                     for a, d in zip(self.args, datas)]

        if op in _CMP:
            d = _eval_cmp(xp, op, self.args, datas)
            if op == Op.NULLEQ:
                both_null = ~argv[0][1] & ~argv[1][1]
                d = xp.where(both_null, xp.ones_like(d), xp.where(
                    argv[0][1] & argv[1][1], d, xp.zeros_like(d)))
                return d, _ones(xp, n)
            return d, valid
        if op in _ARITH or op == Op.UNARY_MINUS:
            return _eval_arith(xp, op, self, datas, valid)
        if op in _BIT:
            return _eval_bit(xp, op, self, datas, valid)
        if op in _MATH:
            return _eval_math(xp, op, self, datas, valid)
        if op in _TIME_OPS:
            return _eval_time(xp, op, self, datas, valid)
        if op in (Op.CAST_INT, Op.CAST_REAL, Op.CAST_DECIMAL, Op.CAST_STRING):
            return _eval_cast(xp, op, self, argv, n)
        raise NotImplementedError(f"op {op}")

    def _fold_huge_int_cmp(self, xp, cols, n):
        """Comparing an int64-domain column with a constant beyond the
        int64 range: the truth value is known exactly (the constant is
        strictly outside every possible column value), while a numeric
        evaluation would wrap or lose precision at the boundary."""
        if len(self.args) != 2:
            return None
        i64_max, i64_min = (1 << 63) - 1, -(1 << 63)
        for c_expr, o_expr, c_on_left in ((self.args[1], self.args[0], False),
                                          (self.args[0], self.args[1], True)):
            if not (isinstance(c_expr, Constant) and
                    isinstance(c_expr.value, (int, float)) and
                    not isinstance(c_expr.value, bool)):
                continue
            v = c_expr.value
            if i64_min <= v <= i64_max:
                continue
            if o_expr.ft.eval_type not in (EvalType.INT, EvalType.DATETIME):
                continue
            op = self.op
            if c_on_left:   # const op col  ==  col flipped(op) const
                op = {Op.LT: Op.GT, Op.LE: Op.GE, Op.GT: Op.LT,
                      Op.GE: Op.LE}.get(op, op)
            above = v > i64_max        # else: below int64 min
            truth = {Op.LT: above, Op.LE: above, Op.GT: not above,
                     Op.GE: not above, Op.EQ: False, Op.NULLEQ: False,
                     Op.NE: True}[op]
            _, valid = o_expr.eval_xp(xp, cols, n)
            data = xp.full(n, 1 if truth else 0, dtype=np.int64)
            if op == Op.NULLEQ:
                return data, _ones(xp, n)
            return data, valid
        return None

    def _eval_in(self, xp, argv, n):
        d, v = argv[0]
        vals = self.extra  # list of python constants (already repr-converted)
        arg_ft = self.args[0].ft
        conv = []
        for c in vals:
            if arg_ft.tp == TypeCode.NEWDECIMAL:
                c = decimal_to_scaled(c, arg_ft.frac)
            conv.append(c)
        if arg_ft.eval_type == EvalType.STRING:
            if xp is not np:
                raise RuntimeError("string IN is host-only")
            if arg_ft.is_ci:
                from tidb_tpu_torch.sqltypes import collation_key, fold_column
                d = fold_column(d)
                conv = [collation_key(c) for c in conv]
            if arg_ft.collation == "binary":
                # UNHEX(col) IN ('A', ...): lift bytes for np.isin
                from tidb_tpu_torch.sqltypes import bytes_to_str
                d = _debinarize(d)
                conv = [bytes_to_str(c) if isinstance(c, (bytes, bytearray))
                        else c for c in conv]
            out = np.isin(d, np.array(conv, dtype=object))
            return out.astype(np.int64), v
        acc = xp.zeros(n, dtype=bool)
        for c in conv:
            acc = acc | (d == c)
        return acc.astype(np.int64) if xp is np else xp.asarray(acc, np.int64), v

    def _eval_control(self, xp, argv, n):
        op = self.op
        if op == Op.IF:
            (cd, cv), (ad, av), (bd, bv) = argv
            cond = cv & (cd != 0)
            ad, bd = _common_numeric(xp, self, [self.args[1], self.args[2]], [ad, bd])
            return xp.where(cond, ad, bd), xp.where(cond, av, bv)
        if op == Op.IFNULL:
            (ad, av), (bd, bv) = argv
            ad, bd = _common_numeric(xp, self, self.args, [ad, bd])
            return xp.where(av, ad, bd), av | bv
        if op == Op.COALESCE:
            datas = _common_numeric(xp, self, self.args, [a[0] for a in argv])
            out_d, out_v = datas[-1], argv[-1][1]
            for (_, av), ad in zip(reversed(argv[:-1]), reversed(datas[:-1])):
                out_d = xp.where(av, ad, out_d)
                out_v = av | out_v
            return out_d, out_v
        # CASE: [c1, v1, c2, v2, ..., else?]
        pairs = []
        i = 0
        while i + 1 < len(argv):
            pairs.append((argv[i], argv[i + 1], self.args[i + 1]))
            i += 2
        has_else = len(argv) % 2 == 1
        vexprs = [p[2] for p in pairs] + ([self.args[-1]] if has_else else [])
        vdatas = _common_numeric(xp, self, vexprs,
                                 [p[1][0] for p in pairs] +
                                 ([argv[-1][0]] if has_else else []))
        if has_else:
            out_d, out_v = vdatas[-1], argv[-1][1]
        else:
            out_d = xp.zeros(n, dtype=vdatas[0].dtype)
            out_v = xp.zeros(n, dtype=bool)
        for k in range(len(pairs) - 1, -1, -1):
            (cd, cv), (vd_, vv), _ = pairs[k]
            cond = cv & (cd != 0)
            out_d = xp.where(cond, vdatas[k], out_d)
            out_v = xp.where(cond, vv, out_v)
        return out_d, out_v

    # -- structure -----------------------------------------------------------

    def columns_used(self):
        s = set()
        for a in self.args:
            s |= a.columns_used()
        return s

    def map_columns(self, mapping):
        f = ScalarFunc.__new__(ScalarFunc)
        f.op = self.op
        f.args = [a.map_columns(mapping) for a in self.args]
        f.extra = self.extra
        f.ft = self.ft
        return f

    def is_device_safe(self):
        if self.op == Op.GENERIC:
            return False
        if self.op in _STRING_OPS or self.op == Op.CAST_STRING:
            return False
        if self.op == Op.IN and self.args[0].ft.eval_type == EvalType.STRING:
            return False
        return all(a.is_device_safe() for a in self.args)

    def __repr__(self):
        return f"{self.op.value}({', '.join(map(repr, self.args))})"

    def __hash__(self):
        return hash((self.op, tuple(hash(a) for a in self.args)))


def func(op: Op, *args, extra=None) -> ScalarFunc:
    return ScalarFunc(op, [_wrap(a) for a in args], extra=extra)


def and_all(exprs: Sequence[Expression]) -> Expression | None:
    exprs = list(exprs)
    if not exprs:
        return None
    out = exprs[0]
    for e in exprs[1:]:
        out = func(Op.AND, out, e)
    return out


# ---------------------------------------------------------------------------
# evaluation helpers (generic over xp = numpy | tnp)

def _is_f64(d) -> bool:
    """float64 lane test for numpy arrays and tensors alike (a torch dtype
    never compares equal to a numpy one)."""
    if isinstance(d, torch.Tensor):
        return d.dtype == torch.float64
    return d.dtype == np.float64


def _ones(xp, n):
    return xp.ones(n, dtype=bool)


def _and_valid(xp, valids, n):
    if not valids:
        return _ones(xp, n)
    out = valids[0]
    for v in valids[1:]:
        out = out & v
    return out


def _to_real(xp, ft: FieldType, d):
    """Convert a column's device repr to float64."""
    if ft.eval_type == EvalType.DECIMAL:
        return xp.asarray(d, dtype=np.float64) / (10.0 ** ft.frac)
    return xp.asarray(d, dtype=np.float64)


def _rescale(xp, d, from_frac: int, to_frac: int):
    if to_frac == from_frac:
        return d
    if to_frac > from_frac:
        return d * (10 ** (to_frac - from_frac))
    # downscale rounds half away from zero (MySQL decimal rounding)
    p = 10 ** (from_frac - to_frac)
    half = p // 2
    return xp.where(d >= 0, (d + half) // p, -((-d + half) // p))


def _common_numeric(xp, parent: "ScalarFunc", exprs, datas):
    """Bring operand arrays to the parent's result representation."""
    ft = parent.ft
    out = []
    for e, d in zip(exprs, datas):
        if d.dtype == np.dtype(object):
            out.append(d)
            continue
        if ft.eval_type == EvalType.REAL:
            out.append(_to_real(xp, e.ft, d))
        elif ft.eval_type == EvalType.DECIMAL:
            ef = e.ft.frac if e.ft.eval_type == EvalType.DECIMAL else 0
            if e.ft.eval_type == EvalType.REAL:
                out.append(xp.asarray(xp.round(d * (10 ** ft.frac)), dtype=np.int64))
            else:
                out.append(_rescale(xp, xp.asarray(d, dtype=np.int64), ef, ft.frac))
        else:
            out.append(xp.asarray(d, dtype=np.int64) if not _is_f64(d)
                       else d)
    return out


def _eval_logic(xp, op, argv, n):
    if op == Op.NOT:
        d, v = argv[0]
        return xp.where(d != 0, 0, 1).astype(np.int64) if xp is np else \
            xp.asarray(xp.where(d != 0, 0, 1), np.int64), v
    (ad, av), (bd, bv) = argv
    at = av & (ad != 0)   # definitely true
    af = av & (ad == 0)   # definitely false
    bt = bv & (bd != 0)
    bf = bv & (bd == 0)
    if op == Op.AND:
        # Kleene: false if either false; null if any null (and none false)
        res_false = af | bf
        res_true = at & bt
        valid = res_false | (av & bv)
        d = xp.where(res_true, 1, 0)
        return xp.asarray(d, np.int64), valid
    if op == Op.OR:
        res_true = at | bt
        res_false = af & bf
        valid = res_true | (av & bv)
        d = xp.where(res_true, 1, 0)
        return xp.asarray(d, np.int64), valid
    # XOR: null if any null
    d = xp.asarray((at ^ bt), np.int64)
    return d, av & bv


def _enum_ordinals(ft: FieldType, d):
    """ENUM object column -> int64 1-based member indexes (0 for the
    empty/invalid member). Identity for everything else."""
    if ft.tp != TypeCode.ENUM or \
            getattr(d, "dtype", None) != np.dtype(object):
        return d
    elems = [str(e).lower() for e in ft.elems]
    out = np.zeros(len(d), dtype=np.int64)
    for i, x in enumerate(d):
        if x is None or x == "":
            continue
        try:
            out[i] = elems.index(str(x).lower()) + 1
        except ValueError:
            pass
    return out


def _debinarize(arr):
    """Replace bytes elements of an object array with latin-1 strings
    (identity on code points 0-255, so byte ordering is preserved)."""
    if getattr(arr, "dtype", None) != np.dtype(object):
        return arr
    out = None
    for i, v in enumerate(arr):
        if isinstance(v, (bytes, bytearray)):
            if out is None:
                out = arr.copy()
            out[i] = bytes(v).decode("latin-1")
    return out if out is not None else arr


def _cmp_operands(xp, args, datas):
    """Bring two compare operands to a common numeric/string representation."""
    a, b = args[0].ft, args[1].ft
    da, db = datas
    if da.dtype == np.dtype(object) or db.dtype == np.dtype(object):
        ea, eb = a.eval_type, b.eval_type
        # ENUM vs number compares by member index (MySQL: c = 2 matches
        # the second member)
        def _num_side(ft_n, d_n):
            if ft_n.eval_type == EvalType.DECIMAL:
                return d_n.astype(np.float64) / (10.0 ** ft_n.frac)
            return d_n
        if a.tp == TypeCode.ENUM and eb != EvalType.STRING and \
                b.tp != TypeCode.ENUM:
            return _enum_ordinals(a, da), _num_side(b, db)
        if b.tp == TypeCode.ENUM and ea != EvalType.STRING and \
                a.tp != TypeCode.ENUM:
            return _num_side(a, da), _enum_ordinals(b, db)
        if EvalType.DECIMAL in (ea, eb) and \
                EvalType.STRING not in (ea, eb):
            # wide-decimal lane: python-int math, exact at any precision
            fa = a.frac if ea == EvalType.DECIMAL else 0
            fb = b.frac if eb == EvalType.DECIMAL else 0
            if EvalType.REAL in (ea, eb):
                ca = da.astype(np.float64) / (10.0 ** fa)
                cb = db.astype(np.float64) / (10.0 ** fb)
                return ca, cb
            f = max(fa, fb)

            def widen(d, fr):
                if fr == f:
                    return d.astype(object)
                return d.astype(object) * (10 ** (f - fr))
            return widen(da, fa), widen(db, fb)
        if a.is_ci or b.is_ci:
            # _ci collation: compare casefolded keys (MySQL resolves a
            # ci column vs a literal to the column's collation)
            from tidb_tpu_torch.sqltypes import fold_column
            if da.dtype == np.dtype(object):
                da = fold_column(da)
            if db.dtype == np.dtype(object):
                db = fold_column(db)
        # VARBINARY (e.g. UNHEX output) vs str: lift bytes to latin-1
        # str so python's '<' is total; latin-1 preserves byte order.
        # Gated on the binary collation marker so plain str columns
        # skip the per-element scan
        if a.collation == "binary" or b.collation == "binary":
            return _debinarize(da), _debinarize(db)
        return da, db
    ea, eb = a.eval_type, b.eval_type
    if EvalType.REAL in (ea, eb):
        return _to_real(xp, a, da), _to_real(xp, b, db)
    if EvalType.DECIMAL in (ea, eb):
        fa = a.frac if ea == EvalType.DECIMAL else 0
        fb = b.frac if eb == EvalType.DECIMAL else 0
        f = max(fa, fb)
        return _rescale(xp, da, fa, f), _rescale(xp, db, fb, f)
    return da, db


def _eval_cmp(xp, op, args, datas):
    da, db = _cmp_operands(xp, args, datas)
    if op in (Op.EQ, Op.NULLEQ):
        r = da == db
    elif op == Op.NE:
        r = da != db
    elif op == Op.LT:
        r = da < db
    elif op == Op.LE:
        r = da <= db
    elif op == Op.GT:
        r = da > db
    else:
        r = da >= db
    if r.dtype == np.dtype(object) or r.dtype == bool:
        return np.asarray(r, dtype=np.int64) if xp is np else xp.asarray(r, np.int64)
    return xp.asarray(r, np.int64)


def _eval_arith(xp, op, f: ScalarFunc, datas, valid):
    ft = f.ft
    if op == Op.UNARY_MINUS:
        return -datas[0], valid
    a, b = f.args[0].ft, f.args[1].ft
    da, db = datas
    if op == Op.DIV:
        da, db = _to_real(xp, a, da), _to_real(xp, b, db)
        valid = valid & (db != 0.0)   # MySQL: x/0 -> NULL
        safe = xp.where(db == 0.0, 1.0, db)
        return da / safe, valid
    if op == Op.INTDIV:
        if a.eval_type == EvalType.INT and b.eval_type == EvalType.INT:
            valid = valid & (db != 0)
            safe = xp.where(db == 0, 1, db)
            # MySQL DIV truncates toward zero; // floors. Exact int fixup.
            q = da // safe
            m = da - q * safe
            q = xp.where((m != 0) & ((da < 0) != (safe < 0)), q + 1, q)
            return q, valid
        da, db = _to_real(xp, a, da), _to_real(xp, b, db)
        valid = valid & (db != 0.0)
        safe = xp.where(db == 0.0, 1.0, db)
        return xp.asarray(xp.trunc(da / safe), np.int64), valid
    if op == Op.MOD:
        valid = valid & (db != 0)
        safe = xp.where(db == 0, 1, db)
        if ft.eval_type == EvalType.REAL:
            da, db = _to_real(xp, a, da), _to_real(xp, b, safe)
            return xp.asarray(da - db * xp.trunc(da / db)), valid
        if ft.eval_type == EvalType.DECIMAL:
            fa = a.frac if a.eval_type == EvalType.DECIMAL else 0
            fb = b.frac if b.eval_type == EvalType.DECIMAL else 0
            tf = max(fa, fb)
            da = _rescale(xp, xp.asarray(da, np.int64), fa, tf)
            safe = _rescale(xp, xp.asarray(safe, np.int64), fb, tf)
            safe = xp.where(safe == 0, 1, safe)
        # truncated (C-style) mod, exact int arithmetic: MySQL sign semantics
        m = da - (da // safe) * safe          # floored mod (sign of divisor)
        m = xp.where((m != 0) & ((m < 0) != (da < 0)), m - safe, m)
        return m, valid
    if ft.eval_type == EvalType.REAL:
        da, db = _to_real(xp, a, da), _to_real(xp, b, db)
        return (da + db if op == Op.PLUS else da - db if op == Op.MINUS else da * db), valid
    if ft.eval_type == EvalType.DECIMAL:
        fa = a.frac if a.eval_type == EvalType.DECIMAL else 0
        fb = b.frac if b.eval_type == EvalType.DECIMAL else 0

        def lane(d):
            # wide-decimal object lanes stay python ints (exact at any
            # precision); fixed lanes cast to int64 for the device path
            arr = np.asarray(d) if xp is np else d
            if xp is np and arr.dtype == np.dtype(object):
                return arr
            if ft.is_wide_decimal and xp is np:
                return arr.astype(object)   # result exceeds int64
            return xp.asarray(d, np.int64)
        if op == Op.MUL:
            r = lane(da) * lane(db)
            return _rescale(xp, r, fa + fb, ft.frac), valid
        tf = ft.frac
        da = _rescale(xp, lane(da), fa, tf)
        db = _rescale(xp, lane(db), fb, tf)
        return (da + db if op == Op.PLUS else da - db), valid
    return (da + db if op == Op.PLUS else da - db if op == Op.MINUS else da * db), valid


def _eval_math(xp, op, f: ScalarFunc, datas, valid):
    a = f.args[0].ft
    d = datas[0]
    if op == Op.ABS:
        return xp.abs(d), valid
    if op == Op.SIGN:
        return xp.asarray(xp.sign(_to_real(xp, a, d)), np.int64), valid
    if op in (Op.CEIL, Op.FLOOR):
        if a.eval_type == EvalType.INT:
            return d, valid
        r = _to_real(xp, a, d)
        r = xp.ceil(r) if op == Op.CEIL else xp.floor(r)
        return xp.asarray(r, np.int64), valid
    if op == Op.ROUND:
        nd = 0
        if len(f.args) > 1:
            if not isinstance(f.args[1], Constant):
                raise NotImplementedError("ROUND with non-constant digits")
            nd = int(f.args[1].value)
        if a.eval_type == EvalType.INT and nd >= 0:
            return d, valid
        if a.eval_type == EvalType.DECIMAL:
            # round scaled int at digit (frac - nd)
            drop = max(0, a.frac - nd)
            p = 10 ** drop
            half = p // 2
            r = xp.where(d >= 0, (d + half) // p, -((-d + half) // p)) * p
            return r, valid
        r = _to_real(xp, a, d)
        p = 10.0 ** nd
        return xp.round(r * p) / p, valid
    r = _to_real(xp, a, d)
    if op == Op.SQRT:
        valid = valid & (r >= 0)
        return xp.sqrt(xp.where(r < 0, 0.0, r)), valid
    if op == Op.EXP:
        return xp.exp(r), valid
    if op == Op.LN:
        valid = valid & (r > 0)
        return xp.log(xp.where(r <= 0, 1.0, r)), valid
    if op == Op.LOG2:
        valid = valid & (r > 0)
        return xp.log2(xp.where(r <= 0, 1.0, r)), valid
    if op == Op.POW:
        e = _to_real(xp, f.args[1].ft, datas[1])
        return xp.power(r, e), valid
    raise NotImplementedError(op)


_US_PER_DAY = 86_400_000_000


def _eval_time(xp, op, f: ScalarFunc, datas, valid):
    d = datas[0]
    if op in (Op.DATE_ADD_DAYS, Op.DATE_SUB_DAYS):
        days = xp.asarray(datas[1], np.int64)
        delta = days * _US_PER_DAY
        return (d + delta if op == Op.DATE_ADD_DAYS else d - delta), valid
    if op == Op.DATE_ADD_US:
        return xp.asarray(d, np.int64) + xp.asarray(datas[1], np.int64), \
            valid
    if op == Op.ADD_MONTHS:
        # calendar-exact month shift, day clamped into the target month
        # (Jan 31 + 1 month -> Feb 29/28), branch-free for the device
        months = xp.asarray(datas[1], np.int64)
        us = xp.asarray(d, np.int64)
        days = us // _US_PER_DAY
        rem_us = us - days * _US_PER_DAY
        y, m, dd = _civil_from_days(xp, days)
        tm = y * 12 + (m - 1) + months
        ny, nm = tm // 12, tm % 12 + 1
        one = xp.ones_like(dd)
        dim = _days_from_civil(xp, (tm + 1) // 12, (tm + 1) % 12 + 1,
                               one) - _days_from_civil(xp, ny, nm, one)
        nd = _days_from_civil(xp, ny, nm, xp.minimum(dd, dim))
        return nd * _US_PER_DAY + rem_us, valid
    if op == Op.DATEDIFF:
        a = xp.asarray(d, np.int64) // _US_PER_DAY
        b = xp.asarray(datas[1], np.int64) // _US_PER_DAY
        return a - b, valid
    # calendar field extraction: host path uses numpy datetime64; device path
    # uses the day-count algorithm (civil_from_days, Howard Hinnant) in int math
    days = xp.asarray(d, np.int64) // _US_PER_DAY
    rem_us = xp.asarray(d, np.int64) - days * _US_PER_DAY
    if op == Op.HOUR:
        return rem_us // 3_600_000_000, valid
    if op == Op.MINUTE:
        return (rem_us // 60_000_000) % 60, valid
    if op == Op.SECOND:
        return (rem_us // 1_000_000) % 60, valid
    y, m, dd = _civil_from_days(xp, days)
    if op == Op.YEAR:
        return y, valid
    if op == Op.MONTH:
        return m, valid
    return dd, valid


def _civil_from_days(xp, z):
    """days-since-epoch -> (year, month, day), branch-free int math.
    Algorithm: civil_from_days (public domain, H. Hinnant) — branch-free."""
    z = z + 719468
    era = xp.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = xp.where(mp < 10, mp + 3, mp - 9)
    y = xp.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(xp, y, m, d):
    """(year, month, day) -> days-since-epoch; inverse of
    _civil_from_days (days_from_civil, H. Hinnant), same int math."""
    y = y - (m <= 2)
    era = xp.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    doy = (153 * xp.where(m > 2, m - 3, m + 9) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


_I64_MAX, _I64_MIN = (1 << 63) - 1, -(1 << 63)


def _round_half(x: float) -> int:
    """MySQL numeric->int conversion: round half away from zero, clamped
    to the int64 domain. trunc-and-compare, NOT floor(x+0.5): adding 0.5
    double-rounds at representation boundaries (0.49999999999999994+0.5
    is exactly 1.0 in IEEE double)."""
    t = math.trunc(x)
    if abs(x - t) >= 0.5:
        t += 1 if x >= 0 else -1
    return min(max(t, _I64_MIN), _I64_MAX)


_I64_MAX_F = 9223372036854774784.0   # largest double strictly below 2^63


def _round_half_xp(xp, r):
    """Vectorized _round_half over a float array, saturating at the
    int64 bounds. float(2^63) cast to int64 is invalid (wraps to
    INT64_MIN), so clip to the largest sub-2^63 double first, then
    restore exact INT64_MAX for the values that were beyond it.
    float(-2^63) is exactly representable and casts fine."""
    t = xp.trunc(r)
    t = t + xp.where(xp.abs(r - t) >= 0.5, xp.sign(r), 0.0)
    out = xp.asarray(xp.clip(t, float(_I64_MIN), _I64_MAX_F), np.int64)
    return xp.where(t > _I64_MAX_F, np.int64(_I64_MAX), out)


def _obj_to_int(d, n) -> np.ndarray:
    """Object-array (string) operands to int64 via MySQL float coercion;
    non-numeric -> 0, out-of-range clamps."""
    out = np.zeros(n, dtype=np.int64)
    for i, x in enumerate(d):
        try:
            out[i] = _round_half(float(x))
        except (ValueError, TypeError, OverflowError):
            out[i] = 0
    return out


def _bit_int(xp, ft, d):
    """Bit-op operand as plain int64; fractional operands round first
    (ref: expression/builtin_op.go bitAndSig — MySQL rounds, not
    truncates, before bit operations)."""
    if d.dtype == np.dtype(object):
        return _obj_to_int(d, len(d))
    if ft.eval_type in (EvalType.REAL, EvalType.DECIMAL) or _is_f64(d):
        return _round_half_xp(xp, _to_real(xp, ft, d))
    return xp.asarray(d, np.int64)


def _eval_bit(xp, op, f: ScalarFunc, datas, valid):
    ints = [_bit_int(xp, e.ft, d) for e, d in zip(f.args, datas)]
    if op == Op.BIT_NEG:
        return ~ints[0], valid
    a, b = ints
    if op == Op.BIT_AND:
        return a & b, valid
    if op == Op.BIT_OR:
        return a | b, valid
    if op == Op.BIT_XOR:
        return a ^ b, valid
    # shifts act on the 64-bit word: a count outside [0, 64) yields 0
    in_range = (b >= 0) & (b < 64)
    sb = xp.where(in_range, b, 0)
    if op == Op.SHL:
        r = a << sb
    else:
        # logical (not arithmetic) right shift in two's complement:
        # mask off the sign bits the arithmetic shift smeared in.
        # 2^(64-s)-1 for s=1 wraps through int64 min to INT64_MAX,
        # which is exactly the 0x7ff..f mask wanted.
        sb1 = xp.where(sb == 0, 1, sb)
        mask = (xp.ones_like(sb1) << (64 - sb1)) - 1
        r = xp.where(sb == 0, a, (a >> sb1) & mask)
    zero = xp.zeros_like(r)
    return xp.where(in_range, r, zero), valid


def _eval_cast(xp, op, f: ScalarFunc, argv, n):
    (d, v) = argv[0]
    a = f.args[0].ft
    if op == Op.CAST_INT:
        if d.dtype == np.dtype(object):
            return _obj_to_int(d, n), v
        if a.eval_type == EvalType.INT:
            return d, v
        # CAST rounds half away from zero (int() would truncate)
        return _round_half_xp(xp, _to_real(xp, a, d)), v
    if op == Op.CAST_REAL:
        if d.dtype == np.dtype(object):
            out = np.zeros(n, dtype=np.float64)
            for i in range(n):
                try:
                    out[i] = float(d[i])
                except (ValueError, TypeError):
                    out[i] = 0.0
            return out, v
        return _to_real(xp, a, d), v
    if op == Op.CAST_DECIMAL:
        tft = f.ft
        if a.eval_type == EvalType.DECIMAL:
            return _rescale(xp, d, a.frac, tft.frac), v
        if a.eval_type == EvalType.REAL or _is_f64(d):
            return xp.asarray(xp.round(d * (10 ** tft.frac)), np.int64), v
        return xp.asarray(d, np.int64) * (10 ** tft.frac), v
    # CAST_STRING: host only
    if xp is not np:
        raise RuntimeError("cast to string is host-only")
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = str(d[i])
    return out, v


def _eval_string(f: ScalarFunc, argv, n):
    """Host-only string builtins over object arrays."""
    import re
    op = f.op
    datas = [a[0] for a in argv]
    valid = _and_valid(np, [a[1] for a in argv], n)

    def vec(fn, *arrs, dtype=object):
        out = np.empty(n, dtype=dtype)
        for i in range(n):
            out[i] = fn(*(a[i] for a in arrs)) if valid[i] else (0 if dtype != object else "")
        return out

    from tidb_tpu_torch.sqltypes import bytes_to_str as s

    if op == Op.CONCAT:
        return vec(lambda *xs: "".join(s(x) for x in xs), *datas), valid
    if op == Op.LENGTH:
        return vec(lambda x: len(s(x)), datas[0], dtype=np.int64), valid
    if op == Op.UPPER:
        return vec(lambda x: s(x).upper(), datas[0]), valid
    if op == Op.LOWER:
        return vec(lambda x: s(x).lower(), datas[0]), valid
    if op == Op.TRIM:
        return vec(lambda x: s(x).strip(), datas[0]), valid
    if op == Op.ASCII:
        return vec(lambda x: ord(s(x)[0]) if s(x) else 0, datas[0], dtype=np.int64), valid
    if op == Op.LEFT:
        return vec(lambda x, k: s(x)[:int(k)], datas[0], datas[1]), valid
    if op == Op.RIGHT:
        return vec(lambda x, k: s(x)[-int(k):] if int(k) > 0 else "", datas[0], datas[1]), valid
    if op == Op.SUBSTRING:
        if len(datas) == 2:
            return vec(lambda x, p: s(x)[int(p) - 1:] if int(p) > 0 else "",
                       datas[0], datas[1]), valid
        return vec(lambda x, p, l: s(x)[int(p) - 1:int(p) - 1 + int(l)] if int(p) > 0 else "",
                   datas[0], datas[1], datas[2]), valid
    if op == Op.REPLACE:
        return vec(lambda x, a, b: s(x).replace(s(a), s(b)), *datas[:3]), valid
    if op == Op.INSTR:
        return vec(lambda x, sub: s(x).find(s(sub)) + 1, datas[0], datas[1],
                   dtype=np.int64), valid
    if op == Op.LIKE:
        pat, esc = f.extra if isinstance(f.extra, tuple) \
            else (f.extra, "\\")
        # _ci collation on the matched column: case-insensitive LIKE
        flags = re.S | (re.I if f.args[0].ft.is_ci else 0)
        rx = re.compile(_like_to_regex(pat, esc), flags)
        return vec(lambda x: 1 if rx.fullmatch(s(x)) else 0, datas[0],
                   dtype=np.int64), valid
    raise NotImplementedError(op)


def _like_to_regex(pat: str, esc: str = "\\") -> str:
    """MySQL LIKE pattern -> regex (%, _ wildcards; `esc` escapes them,
    ESCAPE '' disables escaping). Ref: expression/builtin_like.go."""
    out = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if esc and c == esc and i + 1 < len(pat):
            out.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


import re  # noqa: E402  (used by _like_to_regex)
