"""Scan-range extraction from predicates over index prefix columns.

Reference: TiDB's util/ranger/ — `BuildRange` (ranger.go:387),
`Range` (types.go:28). Given the conjuncts of a WHERE clause and an index's
column list (as offsets into the reader schema), produce the list of
key ranges the scan must visit plus the score of how much of the predicate
the index consumed.

Simplifications vs the reference (documented, revisit with CBO):
* EQ/IN chains over the index prefix, then one interval on the next column
  (the reference's point-then-interval shape; ranger.go builds the same).
* All original conjuncts are retained as residual filters — rows inside
  the ranges still satisfy them, so correctness never depends on the
  detachment being exact (the reference splits accessConds/filterConds;
  we trade one redundant vectorized compare for simplicity).
* Constants are converted to the column's datum space only when exact
  (no silent rounding); inexact conversions leave the conjunct unused.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from tidb_tpu_torch import codec, tablecodec
from tidb_tpu_torch.expression import ColumnRef, Constant, Expression, Op, ScalarFunc
from tidb_tpu_torch.kv import KVRange
from tidb_tpu_torch.sqltypes import EvalType, FieldType

__all__ = ["DatumRange", "AccessPath", "detach_index_conditions",
           "detach_handle_conditions", "index_ranges_to_kv",
           "handle_ranges_to_kv", "MAX_RANGES"]

MAX_RANGES = 128  # cap the IN-list cross product; fall back to full scan


@dataclass
class DatumRange:
    """One scan range in datum space. `low`/`high` share a common prefix of
    point (EQ) values; the last element may differ (interval column).
    Open bounds are expressed by shorter lists + *_unbounded flags."""

    low: list = field(default_factory=list)
    high: list = field(default_factory=list)
    low_incl: bool = True
    high_incl: bool = True
    low_unbounded: bool = False    # no lower bound beyond the eq prefix
    high_unbounded: bool = False


@dataclass
class AccessPath:
    """Result of matching conjuncts against one index/handle column list."""

    ranges: list            # list[DatumRange]
    eq_count: int           # EQ/IN-consumed prefix columns
    has_interval: bool      # an interval condition on the next column
    consumed: list          # conjunct Expressions the ranges encode

    @property
    def score(self) -> tuple:
        return (self.eq_count, 1 if self.has_interval else 0)

    @property
    def useful(self) -> bool:
        return self.eq_count > 0 or self.has_interval


def _col_cmp_const(e: Expression, offset: int):
    """Match `col <op> const` / `const <op> col` on the given column offset.
    -> (op, const_value, const_ft) with op normalized to column-on-left,
    or None."""
    if not isinstance(e, ScalarFunc):
        return None
    flip = {Op.LT: Op.GT, Op.LE: Op.GE, Op.GT: Op.LT, Op.GE: Op.LE,
            Op.EQ: Op.EQ}
    if e.op in (Op.EQ, Op.LT, Op.LE, Op.GT, Op.GE) and len(e.args) == 2:
        a, b = e.args
        if isinstance(a, ColumnRef) and a.idx == offset and \
                isinstance(b, Constant) and b.value is not None:
            return e.op, b.value, b.ft
        if isinstance(b, ColumnRef) and b.idx == offset and \
                isinstance(a, Constant) and a.value is not None:
            return flip[e.op], a.value, a.ft
    if e.op == Op.IN and len(e.args) == 1 and \
            isinstance(e.extra, (list, tuple)) and e.extra:
        a = e.args[0]
        if isinstance(a, ColumnRef) and a.idx == offset and all(
                x is not None for x in e.extra):
            return Op.IN, list(e.extra), None
    if e.op == Op.IS_NULL and len(e.args) == 1:
        a = e.args[0]
        if isinstance(a, ColumnRef) and a.idx == offset:
            return Op.IS_NULL, None, None
    return None


def _exact_datum(v, ft: FieldType):
    """Convert a constant to the column's KV datum space, or None when the
    conversion is inexact (so range building must skip the conjunct).
    Returns (datum, cmp_bias): bias -1/+1 marks 'datum is strictly
    below/above the true constant' for inexact int bounds."""
    from tidb_tpu_torch.table import encode_datum_for_col
    if v is None:
        return None
    et = ft.eval_type
    _I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
    if et == EvalType.INT or et == EvalType.DATETIME:
        if isinstance(v, bool):
            return int(v), 0
        if isinstance(v, int):
            if not (_I64_MIN <= v <= _I64_MAX):
                return None      # un-encodable: leave to residual filter
            return v, 0
        if isinstance(v, float):
            import math
            if not (_I64_MIN <= v <= _I64_MAX):
                return None
            if float(v).is_integer():
                return int(v), 0
            return math.floor(v), -1   # floor(v) < v always
        if et == EvalType.DATETIME and isinstance(v, str):
            try:
                return encode_datum_for_col(v, ft), 0
            except Exception:  # noqa: BLE001
                return None
        return None
    if et == EvalType.REAL:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v), 0
        return None
    if et == EvalType.DECIMAL:
        # floor to the column's scale; bias -1 marks an inexact (rounded-
        # down) bound so interval code treats it like the int floor case
        import decimal as _d
        import math
        try:
            dv = _d.Decimal(str(v)) if not isinstance(v, _d.Decimal) else v
        except _d.InvalidOperation:
            return None
        scaled_exact = dv.scaleb(ft.frac)
        scaled = int(math.floor(scaled_exact))
        if not (_I64_MIN <= scaled <= _I64_MAX):
            return None
        return (ft.frac, scaled), 0 if scaled == scaled_exact else -1
    if et == EvalType.STRING:
        if isinstance(v, (str, bytes)):
            return v, 0
        return None
    return None


def detach_index_conditions(conjuncts: list, offsets: list[int],
                            fts: list[FieldType]) -> AccessPath:
    """Match conjuncts against index columns (schema `offsets`, in index
    order). Builds the point-prefix + final-interval range set."""
    points: list[list] = []     # per consumed prefix column: datum choices
    consumed: list = []
    eq_count = 0
    for off, ft in zip(offsets, fts):
        found = None
        for c in conjuncts:
            if c in consumed:
                continue
            m = _col_cmp_const(c, off)
            if m is None:
                continue
            op, v, _cft = m
            if op == Op.EQ:
                d = _exact_datum(v, ft)
                if d is None or d[1] != 0:
                    continue
                found = ([d[0]], c)
                break
            if op == Op.IS_NULL:
                found = ([None], c)
                break
            if op == Op.IN:
                ds = [_exact_datum(x, ft) for x in v]
                if any(d is None or d[1] != 0 for d in ds):
                    continue
                found = (sorted({d[0] for d in ds},
                                key=lambda x: codec.encode_datum(x)), c)
                break
        if found is None:
            break
        vals, cond = found
        points.append(vals)
        consumed.append(cond)
        eq_count += 1

    # interval on the next column
    low_v = high_v = None
    low_incl = high_incl = True
    has_interval = False
    if eq_count < len(offsets):
        off, ft = offsets[eq_count], fts[eq_count]
        for c in conjuncts:
            if c in consumed:
                continue
            m = _col_cmp_const(c, off)
            if m is None or m[0] in (Op.EQ, Op.IN, Op.IS_NULL):
                continue
            op, v, _cft = m
            d = _exact_datum(v, ft)
            if d is None:
                continue
            dv, bias = d
            if op in (Op.GT, Op.GE):
                # col > v: with floor bias (dv < v), col > dv is implied but
                # looser; keep exclusive-at-floor which stays correct
                incl = (op == Op.GE) and bias == 0
                cand = (dv, incl)
                if low_v is None or _bound_tighter_low(cand, (low_v, low_incl)):
                    low_v, low_incl = cand
                has_interval = True
                consumed.append(c)
            elif op in (Op.LT, Op.LE):
                # col < v with floor bias: col <= floor(v) — inclusive stays
                # correct (floor(v) < v)
                incl = (op == Op.LE) or bias != 0
                cand = (dv, incl)
                if high_v is None or _bound_tighter_high(cand, (high_v, high_incl)):
                    high_v, high_incl = cand
                has_interval = True
                consumed.append(c)

    n_ranges = 1
    for p in points:
        n_ranges *= len(p)
    if n_ranges > MAX_RANGES:
        return AccessPath(ranges=[], eq_count=0, has_interval=False,
                          consumed=[])

    ranges: list[DatumRange] = []
    for combo in itertools.product(*points) if points else [()]:
        prefix = list(combo)
        if has_interval:
            r = DatumRange(
                low=prefix + ([low_v] if low_v is not None else []),
                high=prefix + ([high_v] if high_v is not None else []),
                low_incl=low_incl, high_incl=high_incl,
                low_unbounded=low_v is None,
                high_unbounded=high_v is None)
            # empty interval (low > high) -> skip
            if low_v is not None and high_v is not None:
                kl = codec.encode_datum(low_v)
                kh = codec.encode_datum(high_v)
                if kl > kh or (kl == kh and not (low_incl and high_incl)):
                    continue
        else:
            r = DatumRange(low=prefix, high=list(prefix))
        ranges.append(r)
    # _ci index columns store casefolded keys (table/_index_values):
    # fold the range bounds to match
    if any(ft.is_ci for ft in fts):
        from tidb_tpu_torch.sqltypes import collation_key
        for r in ranges:
            for vals in (r.low, r.high):
                for i in range(min(len(vals), len(fts))):
                    if fts[i].is_ci and isinstance(vals[i], str):
                        vals[i] = collation_key(vals[i])
    return AccessPath(ranges=ranges, eq_count=eq_count,
                      has_interval=has_interval, consumed=consumed)


def _bound_tighter_low(cand, cur) -> bool:
    kc, kcur = codec.encode_datum(cand[0]), codec.encode_datum(cur[0])
    if kc != kcur:
        return kc > kcur
    return cur[1] and not cand[1]   # exclusive beats inclusive


def _bound_tighter_high(cand, cur) -> bool:
    kc, kcur = codec.encode_datum(cand[0]), codec.encode_datum(cur[0])
    if kc != kcur:
        return kc < kcur
    return cur[1] and not cand[1]


def detach_handle_conditions(conjuncts: list, offset: int) -> AccessPath:
    """Integer ranges over the pk-is-handle column."""
    from tidb_tpu_torch.sqltypes import new_int_field
    path = detach_index_conditions(conjuncts, [offset], [new_int_field()])
    return path


# -- range -> KV key materialization ----------------------------------------


def index_ranges_to_kv(table_id: int, index_id: int,
                       ranges: list[DatumRange]) -> list[KVRange]:
    prefix = tablecodec.index_prefix(table_id, index_id)
    out = []
    for r in ranges:
        if r.low == r.high and not r.low_unbounded and not r.high_unbounded \
                and len(r.low) == len(r.high) and r.low_incl and r.high_incl:
            p = prefix + codec.encode_key(r.low)
            out.append(KVRange(p, codec.prefix_next(p)))
            continue
        # low bound
        low = prefix + codec.encode_key(r.low)
        if r.low_unbounded:
            # skip NULLs: every non-NULL datum flag sorts after NIL (0x00)
            low = low + bytes([codec.NIL_FLAG + 1])
        elif not r.low_incl:
            low = codec.prefix_next(low)
        # high bound
        high = prefix + codec.encode_key(r.high)
        if r.high_unbounded or r.high_incl:
            high = codec.prefix_next(high)
        if low < high:
            out.append(KVRange(low, high))
    return out


def handle_ranges_to_kv(table_id: int, ranges: list[DatumRange]
                        ) -> list[KVRange] | None:
    """Record-key ranges from pk-is-handle DatumRanges. Returns None when a
    range bound is not an int (planner falls back to full scan)."""
    out = []
    for r in ranges:
        lo_v = r.low[0] if r.low else None
        hi_v = r.high[0] if r.high else None
        if (lo_v is not None and not isinstance(lo_v, int)) or \
                (hi_v is not None and not isinstance(hi_v, int)):
            return None
        if lo_v is None and not r.low_unbounded and r.low == r.high:
            # IS NULL point on a NOT NULL pk: empty
            continue
        lo = lo_v if lo_v is not None else -(1 << 63)
        if not r.low_incl and lo_v is not None:
            if lo == (1 << 63) - 1:
                continue
            lo += 1
        start = tablecodec.record_key(table_id, lo)
        if hi_v is None:
            end = codec.prefix_next(tablecodec.record_prefix(table_id))
        else:
            hi = hi_v
            if r.high_incl:
                if hi == (1 << 63) - 1:
                    end = codec.prefix_next(
                        tablecodec.record_prefix(table_id))
                else:
                    end = tablecodec.record_key(table_id, hi + 1)
            else:
                end = tablecodec.record_key(table_id, hi)
        if start < end:
            out.append(KVRange(start, end))
    out.sort(key=lambda r: r.start)
    return out
