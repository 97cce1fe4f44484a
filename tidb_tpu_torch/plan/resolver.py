"""Name resolution: AST expressions -> columnar expression trees.

Reference: TiDB's plan/expression_rewriter.go (AST -> Expression
with column resolution against the child plan's schema) and
plan/resolver.go name checks.
"""

from __future__ import annotations

import datetime as _dt
import decimal as _decimal
from dataclasses import dataclass, field

from tidb_tpu_torch import sqltypes as st
from tidb_tpu_torch.expression import (AggDesc, AggFunc, ColumnRef, Constant,
                                 Expression, Op, col, const, func)
from tidb_tpu_torch.parser import ast

__all__ = ["PlanSchema", "SchemaCol", "Resolver", "ResolveError"]


class ResolveError(Exception):
    pass


class ColumnAmbiguousError(ResolveError):
    """Ambiguity is a hard error even when an outer scope could resolve
    the name — never silently correlate an ambiguous column."""


# ---------------------------------------------------------------------------
# Outer-scope stack for correlated subqueries. While a subquery's plan is
# being built, the outer plan's schema sits on this stack; any name that
# fails to resolve locally is looked up outward and becomes a shared
# CorrelatedCol cell the apply executor binds per outer row (ref:
# expression_rewriter.go b.outerSchemas). Thread-local: each server
# connection plans on its own thread.


@dataclass
class OuterScope:
    schema: PlanSchema
    cells: dict = field(default_factory=dict)   # outer_idx -> CorrelatedCol


import threading as _threading

_scopes_tls = _threading.local()


def _outer_scopes() -> list:
    stack = getattr(_scopes_tls, "stack", None)
    if stack is None:
        stack = _scopes_tls.stack = []
    return stack


def reset_volatile() -> None:
    """Planner calls this before building; volatile folds (NOW(), ...)
    mark the flag so the resulting plan is never cached."""
    _scopes_tls.volatile = False


def mark_volatile() -> None:
    _scopes_tls.volatile = True


def was_volatile() -> bool:
    return getattr(_scopes_tls, "volatile", False)


class push_outer:
    """Context manager exposing an outer schema to subquery resolution."""

    def __init__(self, schema: PlanSchema):
        self.scope = OuterScope(schema)

    def __enter__(self) -> OuterScope:
        _outer_scopes().append(self.scope)
        return self.scope

    def __exit__(self, *exc):
        _outer_scopes().pop()
        return False


@dataclass
class SchemaCol:
    name: str                 # lower column/alias name
    table: str = ""           # lower table alias
    ft: st.FieldType = None
    col_id: int = 0           # ColumnInfo.id for datasource columns


@dataclass
class PlanSchema:
    cols: list[SchemaCol] = field(default_factory=list)

    def find(self, name: str, table: str = "") -> int:
        name = name.lower()
        table = table.lower()
        hits = [i for i, c in enumerate(self.cols)
                if c.name == name and (not table or c.table == table)]
        if not hits:
            raise ResolveError(f"Unknown column '{name}'")
        if len(hits) > 1:
            raise ColumnAmbiguousError(f"Column '{name}' is ambiguous")
        return hits[0]

    def merge(self, other: "PlanSchema") -> "PlanSchema":
        return PlanSchema(self.cols + other.cols)

    def __len__(self):
        return len(self.cols)


_FUNC_OPS = {
    "ABS": Op.ABS, "CEIL": Op.CEIL, "CEILING": Op.CEIL, "FLOOR": Op.FLOOR,
    "ROUND": Op.ROUND, "POW": Op.POW, "POWER": Op.POW, "SQRT": Op.SQRT,
    "EXP": Op.EXP, "LN": Op.LN, "LOG2": Op.LOG2, "SIGN": Op.SIGN,
    "CONCAT": Op.CONCAT, "LENGTH": Op.LENGTH, "UPPER": Op.UPPER,
    "UCASE": Op.UPPER, "LOWER": Op.LOWER, "LCASE": Op.LOWER,
    "TRIM": Op.TRIM, "LEFT": Op.LEFT, "RIGHT": Op.RIGHT,
    "SUBSTRING": Op.SUBSTRING, "SUBSTR": Op.SUBSTRING, "REPLACE": Op.REPLACE,
    "INSTR": Op.INSTR, "ASCII": Op.ASCII,
    "YEAR": Op.YEAR, "MONTH": Op.MONTH, "DAY": Op.DAY,
    "DAYOFMONTH": Op.DAY, "HOUR": Op.HOUR, "MINUTE": Op.MINUTE,
    "SECOND": Op.SECOND, "DATEDIFF": Op.DATEDIFF,
    "IF": Op.IF, "IFNULL": Op.IFNULL, "COALESCE": Op.COALESCE,
    "MID": Op.SUBSTRING,
}

_AGG_MAP = {"COUNT": AggFunc.COUNT, "SUM": AggFunc.SUM, "AVG": AggFunc.AVG,
            "MIN": AggFunc.MIN, "MAX": AggFunc.MAX,
            "BIT_AND": AggFunc.BIT_AND, "BIT_OR": AggFunc.BIT_OR,
            "BIT_XOR": AggFunc.BIT_XOR,
            "GROUP_CONCAT": AggFunc.GROUP_CONCAT}

def _row_eq(le: "ast.RowExpr", ri: "ast.RowExpr") -> ast.ExprNode:
    """(a,b) = (c,d)  ->  a=c AND b=d."""
    out = None
    for x, y in zip(le.items, ri.items):
        c = ast.BinaryOp("=", x, y)
        out = c if out is None else ast.BinaryOp("AND", out, c)
    return out


def _row_ord(op: str, le, ri, i: int) -> ast.ExprNode:
    """Lexicographic row ordering: (a1,a2) < (b1,b2) is
    a1<b1 OR (a1=b1 AND a2<b2); <=/>= stay weak only at the tail."""
    x, y = le.items[i], ri.items[i]
    if i == len(le.items) - 1:
        return ast.BinaryOp(op, x, y)
    strict = {"<=": "<", ">=": ">"}.get(op, op)
    return ast.BinaryOp(
        "OR", ast.BinaryOp(strict, x, y),
        ast.BinaryOp("AND", ast.BinaryOp("=", x, y),
                     _row_ord(op, le, ri, i + 1)))


def _has_correlated(x) -> bool:
    from tidb_tpu_torch.expression.core import CorrelatedCol
    if isinstance(x, CorrelatedCol):
        return True
    return any(_has_correlated(a) for a in getattr(x, "args", ()))


_BIN_OPS = {"+": Op.PLUS, "-": Op.MINUS, "*": Op.MUL, "/": Op.DIV,
            "DIV": Op.INTDIV, "%": Op.MOD, "MOD": Op.MOD,
            "=": Op.EQ, "<": Op.LT, "<=": Op.LE, ">": Op.GT, ">=": Op.GE,
            "<>": Op.NE, "!=": Op.NE, "<=>": Op.NULLEQ,
            "AND": Op.AND, "OR": Op.OR, "XOR": Op.XOR,
            "&": Op.BIT_AND, "|": Op.BIT_OR, "^": Op.BIT_XOR,
            "<<": Op.SHL, ">>": Op.SHR}


def _expr_key(e):
    """Structural identity of a resolved expression: column INDEXES
    (names are display-only and can collide across tables)."""
    if e is None:
        return None
    if isinstance(e, ColumnRef):
        return ("col", e.idx)
    if isinstance(e, Constant):
        return ("const", repr(e.value))
    args = getattr(e, "args", None)
    if args is not None:
        return (type(e).__name__, getattr(e, "op", None),
                tuple(_expr_key(a) for a in args))
    return repr(e)


class Resolver:
    """Resolves AST exprs against a PlanSchema. When `agg_collector` is set,
    AggregateCall nodes are collected as AggDescs and replaced by refs into
    the aggregation's output schema."""

    def __init__(self, schema: PlanSchema,
                 agg_collector: list[AggDesc] | None = None,
                 agg_base: int = 0):
        self.schema = schema
        self.aggs = agg_collector
        self.agg_base = agg_base  # index offset of agg outputs in out schema

    def resolve(self, e: ast.ExprNode) -> Expression:
        m = getattr(self, "_r_" + type(e).__name__, None)
        if m is None:
            raise ResolveError(f"unsupported expression {type(e).__name__}")
        return m(e)

    # -- leaves --------------------------------------------------------------

    def _r_Literal(self, e: ast.Literal) -> Expression:
        v = e.value
        if isinstance(v, str):
            # date-ish literals stay strings until compared with a time
            # column; the comparison coercion below handles it
            return const(v)
        return const(v)

    def _r_ColName(self, e: ast.ColName) -> Expression:
        try:
            idx = self.schema.find(e.name, e.table)
        except ColumnAmbiguousError:
            raise
        except ResolveError:
            for scope in reversed(_outer_scopes()):
                try:
                    oi = scope.schema.find(e.name, e.table)
                except ColumnAmbiguousError:
                    raise   # ambiguity is a hard error at EVERY scope
                except ResolveError:
                    continue
                cc = scope.cells.get(oi)
                if cc is None:
                    from tidb_tpu_torch.expression.core import CorrelatedCol
                    sc = scope.schema.cols[oi]
                    cc = CorrelatedCol(sc.ft, name=sc.name)
                    scope.cells[oi] = cc
                return cc
            raise
        sc = self.schema.cols[idx]
        return ColumnRef(idx, sc.ft, name=sc.name)

    def _r_VariableExpr(self, e: ast.VariableExpr) -> Expression:
        raise ResolveError("variables resolve in the session layer")

    # -- operators -----------------------------------------------------------

    def _coerce_time(self, a: Expression, b: Expression):
        """'2024-01-01' literals compared to DATETIME columns become
        epoch-micros constants (MySQL implicit date coercion)."""
        for x, y in ((a, b), (b, a)):
            if x.ft.eval_type == st.EvalType.DATETIME and \
                    isinstance(y, Constant) and isinstance(y.value, str):
                try:
                    micros = st.parse_datetime(y.value)
                except ValueError:
                    raise ResolveError(f"invalid date literal {y.value!r}")
                new = Constant(micros, x.ft)
                if y is b:
                    return a, new
                return new, b
        return a, b

    def _r_BinaryOp(self, e: ast.BinaryOp) -> Expression:
        if isinstance(e.left, ast.RowExpr) or \
                isinstance(e.right, ast.RowExpr):
            # (a,b) <cmp> (c,d): desugar to scalar logic (ref:
            # expression/expression.go row-expression handling); NULLs
            # propagate correctly through the Kleene AND/OR ops
            return self.resolve(self._desugar_row_cmp(e))
        op = _BIN_OPS.get(e.op)
        if op is None:
            raise ResolveError(f"unsupported operator {e.op}")
        a = self.resolve(e.left)
        b = self.resolve(e.right)
        a, b = self._coerce_time(a, b)
        a, b = self._coerce_enum_set(a, b)
        return func(op, a, b)

    @staticmethod
    def _normalize_enum_const(col_ft, value):
        """-> normalized member spelling, or the value unchanged."""
        from tidb_tpu_torch.sqltypes import TypeCode
        if col_ft.tp in (TypeCode.ENUM, TypeCode.SET) and \
                isinstance(value, str):
            from tidb_tpu_torch.table import _normalize_enum_set
            try:
                return _normalize_enum_set(value, col_ft)
            except Exception:   # noqa: BLE001 - unknown member
                return value
        return value

    @staticmethod
    def _coerce_enum_set(a: Expression, b: Expression):
        """A string constant compared against an ENUM/SET column
        normalizes to the member's stored spelling (writes accept
        members case-insensitively, so reads must too; an unknown
        member stays as-is and simply matches nothing)."""
        from tidb_tpu_torch.sqltypes import TypeCode

        def fix(col, const):
            if isinstance(const, Constant) and \
                    isinstance(const.value, str):
                norm = Resolver._normalize_enum_const(col.ft, const.value)
                if norm != const.value:
                    return Constant(norm, const.ft)
            return const

        return fix(b, a), fix(a, b)

    def _r_UnaryOp(self, e: ast.UnaryOp) -> Expression:
        a = self.resolve(e.operand)
        if e.op == "-":
            # fold over numeric literals: INTERVAL -1 MONTH and range
            # pruning both want a plain Constant, not a ScalarFunc
            if isinstance(a, Constant) and not isinstance(a.value, bool) \
                    and isinstance(a.value, (int, float, _decimal.Decimal)):
                return Constant(-a.value, a.ft)
            return func(Op.UNARY_MINUS, a)
        if e.op == "NOT":
            return func(Op.NOT, a)
        if e.op == "~":
            return func(Op.BIT_NEG, a)
        raise ResolveError(f"unsupported unary {e.op}")

    def _r_IsNullExpr(self, e: ast.IsNullExpr) -> Expression:
        f = func(Op.IS_NOT_NULL if e.negated else Op.IS_NULL,
                 self.resolve(e.expr))
        return f

    def _r_InExpr(self, e: ast.InExpr) -> Expression:
        if isinstance(e.items, ast.SubqueryExpr):
            raise ResolveError("IN (subquery) not yet supported")
        if isinstance(e.expr, ast.RowExpr):
            # (a,b) IN ((1,2),(3,4)): OR over per-row equality chains
            want = len(e.expr.items)
            ors = None
            for item in e.items:
                if not isinstance(item, ast.RowExpr) or \
                        len(item.items) != want:
                    raise ResolveError(
                        f"Operand should contain {want} column(s)")
                c = _row_eq(e.expr, item)
                ors = c if ors is None else ast.BinaryOp("OR", ors, c)
            if ors is None:
                raise ResolveError("IN list must not be empty")
            out = self.resolve(ors)
            return func(Op.NOT, out) if e.negated else out
        target = self.resolve(e.expr)
        vals = []
        for item in e.items:
            r = self.resolve(item)
            if not isinstance(r, Constant):
                # fall back to OR chain for non-constant items
                ors = None
                for item2 in e.items:
                    t2, r2 = self._coerce_time(target, self.resolve(item2))
                    _, r2 = self._coerce_enum_set(t2, r2)
                    cmp_ = func(Op.EQ, t2, r2)
                    ors = cmp_ if ors is None else func(Op.OR, ors, cmp_)
                return func(Op.NOT, ors) if e.negated else ors
            _, r = self._coerce_time(target, r)
            vals.append(self._normalize_enum_const(target.ft, r.value))
        out = func(Op.IN, target, extra=vals)
        return func(Op.NOT, out) if e.negated else out

    def _r_BetweenExpr(self, e: ast.BetweenExpr) -> Expression:
        x = self.resolve(e.expr)
        lo = self.resolve(e.low)
        hi = self.resolve(e.high)
        x1, lo = self._coerce_time(x, lo)
        x2, hi = self._coerce_time(x, hi)
        _, lo = self._coerce_enum_set(x1, lo)
        _, hi = self._coerce_enum_set(x2, hi)
        r = func(Op.AND, func(Op.GE, x1, lo), func(Op.LE, x2, hi))
        return func(Op.NOT, r) if e.negated else r

    def _r_LikeExpr(self, e: ast.LikeExpr) -> Expression:
        pat = self.resolve(e.pattern)
        if not isinstance(pat, Constant) or not isinstance(pat.value, str):
            raise ResolveError("LIKE pattern must be a string literal")
        out = func(Op.LIKE, self.resolve(e.expr),
                   extra=(pat.value, e.escape))
        return func(Op.NOT, out) if e.negated else out

    def _r_CaseExpr(self, e: ast.CaseExpr) -> Expression:
        args = []
        if e.operand is not None:
            op_expr = self.resolve(e.operand)
            for c, v in e.when_clauses:
                cc, rc = self._coerce_time(op_expr, self.resolve(c))
                args.append(func(Op.EQ, cc, rc))
                args.append(self.resolve(v))
        else:
            for c, v in e.when_clauses:
                args.append(self.resolve(c))
                args.append(self.resolve(v))
        if e.else_clause is not None:
            args.append(self.resolve(e.else_clause))
        return func(Op.CASE, *args)

    def _r_CastExpr(self, e: ast.CastExpr) -> Expression:
        a = self.resolve(e.expr)
        et = e.ft.eval_type
        if et == st.EvalType.INT:
            return func(Op.CAST_INT, a)
        if et == st.EvalType.REAL:
            return func(Op.CAST_REAL, a)
        if et == st.EvalType.DECIMAL:
            return func(Op.CAST_DECIMAL, a, extra=e.ft)
        if et == st.EvalType.DATETIME:
            if isinstance(a, Constant) and isinstance(a.value, str):
                return Constant(st.parse_datetime(a.value), e.ft)
            return a  # already micros
        return func(Op.CAST_STRING, a)

    def _r_FuncCall(self, e: ast.FuncCall) -> Expression:
        name = e.name.upper()
        if name in ("DATE_ADD", "DATE_SUB", "ADDDATE", "SUBDATE"):
            return self._date_arith(e, sub=name in ("DATE_SUB", "SUBDATE"))
        if name == "DATE":
            a = self.resolve(e.args[0])
            if isinstance(a, Constant) and isinstance(a.value, str):
                return Constant(st.parse_datetime(a.value),
                                st.new_date_field())
            return a
        if name == "NOW" or name == "CURRENT_TIMESTAMP":
            mark_volatile()   # folded at plan time: such plans never cache
            return Constant(st.datetime_to_micros(_dt.datetime.now()),
                            st.new_datetime_field())
        if name == "DATABASE":
            raise ResolveError("DATABASE() resolves in the session layer")
        if name == "ISNULL":
            if len(e.args) != 1:
                raise ResolveError("Incorrect parameter count for ISNULL")
            return func(Op.IS_NULL, self.resolve(e.args[0]))
        if name == "NULLIF":
            if len(e.args) != 2:
                raise ResolveError("Incorrect parameter count for NULLIF")
            # NULLIF(a,b) == CASE WHEN a=b THEN NULL ELSE a END
            a = self.resolve(e.args[0])
            b = self.resolve(e.args[1])
            return func(Op.CASE, func(Op.EQ, a, b),
                        Constant(None, a.ft), a)
        op = _FUNC_OPS.get(name)
        if op is None:
            from tidb_tpu_torch.expression.builtins import lookup
            spec = lookup(name)
            if spec is None:
                raise ResolveError(f"unsupported function {name}")
            if not (spec.min_args <= len(e.args) <= spec.max_args):
                raise ResolveError(
                    f"Incorrect parameter count for {name}")
            args = [self.resolve(a) for a in e.args]
            return func(Op.GENERIC, *args, extra=spec)
        args = [self.resolve(a) for a in e.args]
        return func(op, *args)

    def _date_arith(self, e: ast.FuncCall, sub: bool) -> Expression:
        base = self.resolve(e.args[0])
        if isinstance(base, Constant) and isinstance(base.value, str):
            base = Constant(st.parse_datetime(base.value),
                            st.new_datetime_field())
        iv = e.args[1]
        if isinstance(iv, ast.FuncCall) and iv.name == "INTERVAL":
            n = self.resolve(iv.args[0])
            unit = iv.args[1].value
        else:
            n = self.resolve(iv)
            unit = "DAY"
        if not isinstance(n, Constant) and not n.columns_used() and \
                not _has_correlated(n):
            # fold computed amounts (INTERVAL 1+1 DAY)
            import numpy as _np
            d, v = n.eval_xp(_np, [], 1)
            val = None if not v[0] else (
                d[0].item() if hasattr(d[0], "item") else d[0])
            if val is not None and \
                    n.ft.eval_type == st.EvalType.DECIMAL:
                # eval_xp yields the scaled int representation
                val = st.scaled_to_decimal(int(val), max(n.ft.frac, 0))
            n = Constant(val, n.ft)
        if not isinstance(n, Constant):
            raise ResolveError("INTERVAL amount must be constant")
        if n.value is None:
            return Constant(None, base.ft)   # NULL interval -> NULL
        v = n.value
        if isinstance(v, str):
            try:
                v = _decimal.Decimal(v.strip())
            except _decimal.InvalidOperation:
                raise ResolveError(f"incorrect INTERVAL amount {v!r}")
        if isinstance(v, (float, _decimal.Decimal)):
            dv = _decimal.Decimal(str(v))
            if not dv.is_finite() or abs(dv) > 10 ** 12:
                raise ResolveError(
                    f"incorrect INTERVAL amount {str(n.value)!r}")
            if unit == "SECOND" and dv != dv.to_integral_value():
                # MySQL: a fractional SECOND amount is seconds.micros
                total = int((dv * 1_000_000).quantize(
                    0, rounding=_decimal.ROUND_HALF_UP))
                total *= -1 if sub else 1
                if isinstance(base, Constant):
                    return Constant(None if base.value is None
                                    else base.value + total, base.ft)
                return func(Op.DATE_ADD_US, base, const(total))
            # other integer units round half-up
            v = dv.quantize(0, rounding=_decimal.ROUND_HALF_UP)
        amount = int(v) * (-1 if sub else 1)
        us_per = {"MICROSECOND": 1, "SECOND": 1_000_000,
                  "MINUTE": 60_000_000, "HOUR": 3_600_000_000,
                  "DAY": 86_400_000_000, "WEEK": 7 * 86_400_000_000}
        months_per = {"MONTH": 1, "QUARTER": 3, "YEAR": 12}
        if unit in us_per:
            total = amount * us_per[unit]
            if isinstance(base, Constant):
                return Constant(None if base.value is None
                                else base.value + total, base.ft)
            return func(Op.DATE_ADD_US, base, const(total))
        if unit not in months_per:
            raise ResolveError(f"unsupported INTERVAL unit {unit}")
        months = months_per[unit] * amount
        if isinstance(base, Constant):
            # fold for constants so index range pruning still sees a
            # plain comparison constant (the common TPC-H case)
            dt = st.micros_to_datetime(base.value)
            y = dt.year + (dt.month - 1 + months) // 12
            m = (dt.month - 1 + months) % 12 + 1
            try:
                nd = dt.replace(year=y, month=m)
            except ValueError:  # day beyond target month: clamp
                nxt_y, nxt_m = (y, m + 1) if m < 12 else (y + 1, 1)
                last = (_dt.date(nxt_y, nxt_m, 1) -
                        _dt.timedelta(days=1)).day
                nd = dt.replace(year=y, month=m, day=last)
            return Constant(st.datetime_to_micros(nd), base.ft)
        return func(Op.ADD_MONTHS, base, const(months))

    def _r_AggregateCall(self, e: ast.AggregateCall) -> Expression:
        if self.aggs is None:
            raise ResolveError(
                f"aggregate {e.name} not allowed in this clause")
        name = e.name.upper()
        fn = _AGG_MAP.get(name)
        if fn is None:
            raise ResolveError(f"unsupported aggregate {name}")
        arg = None
        if not e.star:
            if len(e.args) != 1:
                raise ResolveError(f"{name} takes one argument")
            arg = self.resolve(e.args[0])
        desc = AggDesc(fn, arg, distinct=e.distinct,
                       sep=getattr(e, "sep", ","))

        # reuse identical aggs — compared STRUCTURALLY (column indexes,
        # not display names: max(a.b) and max(b.b) both repr as max(b))
        def key(d):
            return (d.fn, d.distinct, d.sep, _expr_key(d.arg))
        for i, d in enumerate(self.aggs):
            if key(d) == key(desc):
                return ColumnRef(self.agg_base + i, d.result_ft)
        self.aggs.append(desc)
        return ColumnRef(self.agg_base + len(self.aggs) - 1, desc.result_ft)

    def _r_SubqueryExpr(self, e):
        raise ResolveError("scalar subqueries not yet supported")

    def _r_ExistsSubquery(self, e):
        raise ResolveError("EXISTS subqueries not yet supported")

    def _r_RowExpr(self, e):
        raise ResolveError(
            "row expression only valid in comparisons and IN")

    def _desugar_row_cmp(self, e: ast.BinaryOp) -> ast.ExprNode:
        le, ri = e.left, e.right
        if not (isinstance(le, ast.RowExpr) and
                isinstance(ri, ast.RowExpr)):
            n = len((le if isinstance(le, ast.RowExpr) else ri).items)
            raise ResolveError(f"Operand should contain {n} column(s)")
        if len(le.items) != len(ri.items):
            raise ResolveError(
                f"Operand should contain {len(le.items)} column(s)")
        if e.op == "=":
            return _row_eq(le, ri)
        if e.op in ("<>", "!="):
            return ast.UnaryOp("NOT", _row_eq(le, ri))
        if e.op in ("<", ">", "<=", ">="):
            return _row_ord(e.op, le, ri, 0)
        raise ResolveError(f"unsupported row operator {e.op}")

    def _r_DefaultExpr(self, e):
        raise ResolveError("DEFAULT only valid in INSERT values")

    def _r_ParamMarker(self, e):
        if not e.bound:
            raise ResolveError("unbound parameter marker (use EXECUTE "
                               "with USING, or the binary protocol)")
        return const(e.value)

    def _r_Star(self, e):
        raise ResolveError("* only valid in select list")
