"""Host (numpy/python) aggregation fallback.

Used when a pushed aggregate can't ride the device kernel: DISTINCT aggs,
string MIN/MAX, hash-collision or capacity fallback (ops/hashagg.py), and
tiny chunks where kernel launch overhead would dominate. Produces the same
GroupResult partial-state protocol, so the final merge path is identical.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch.chunk import Chunk
from tidb_tpu_torch.expression import AggDesc, AggFunc, Expression
from tidb_tpu_torch.ops.hashagg import GroupResult
from tidb_tpu_torch.ops.runtime import eval_filter_host

__all__ = ["host_hash_agg", "host_scalar_agg"]


def _eval_cols(exprs, chunk):
    out = []
    for e in exprs:
        d, v = e.eval(chunk)
        out.append((d, v))
    return out


def host_hash_agg(chunk: Chunk, filter_expr: Expression | None,
                  group_exprs: list[Expression],
                  aggs: list[AggDesc]) -> GroupResult:
    mask = eval_filter_host(filter_expr, chunk)
    if not any(a.distinct for a in aggs):
        return _host_agg_vectorized(chunk, mask, group_exprs, aggs)
    return _host_agg_rowloop(chunk, mask, group_exprs, aggs)


def _lex_key(d: np.ndarray, v: np.ndarray):
    """Sortable, NULL-safe lexsort lanes for one group column."""
    if d.dtype == np.dtype(object):
        # strings: convert to a fixed 'U' dtype once (C-speed compares)
        s = np.where(v, d, "")
        return [s.astype("U"), ~v]
    safe = np.where(v, d, d.dtype.type(0))
    return [safe, ~v]


def _host_agg_vectorized(chunk: Chunk, mask, group_exprs, aggs
                         ) -> GroupResult:
    """Sort-based group-by, fully vectorized (np.lexsort + ufunc.reduceat):
    the numpy mirror of the device segment-reduce kernel, and the measured
    CPU baseline of bench.py — kept honest by being a real columnar
    engine, not a per-row interpreter (the reference's chunk executor is
    compiled Go; a Python row loop would flatter the device numbers)."""
    live = np.flatnonzero(mask)
    nlive = len(live)
    gcols = [(d, v) for d, v in _eval_cols(group_exprs, chunk)]
    if nlive == 0:
        return GroupResult(keys=[], partials=[
            _states_to_lanes(a, []) for a in aggs],
            counts=np.zeros(0, dtype=np.int64))
    lanes = []
    for (d, v), e in zip(gcols, group_exprs):
        darr = np.asarray(d)[live]
        if e.ft.is_ci and darr.dtype == np.dtype(object):
            # _ci collation groups by the casefolded key; the surfaced
            # value stays the representative row's original variant
            from tidb_tpu_torch.sqltypes import fold_column
            darr = fold_column(darr)
        lanes.extend(_lex_key(darr, np.asarray(v)[live]))
    if lanes:
        order = np.lexsort(lanes[::-1])   # first col is primary
        sorted_lanes = [l[order] for l in lanes]
        new = np.zeros(nlive, dtype=bool)
        new[0] = True
        for l in sorted_lanes:
            new[1:] |= l[1:] != l[:-1]
    else:
        order = np.arange(nlive)
        new = np.zeros(nlive, dtype=bool)
        new[0] = True
    starts = np.flatnonzero(new)
    gid = np.cumsum(new) - 1
    ngroups = len(starts)
    rows = live[order]                    # original row index per position
    counts = np.add.reduceat(np.ones(nlive, dtype=np.int64), starts)

    # group keys from each segment's first row
    rep = rows[starts]
    keys_cols = []
    for d, v in gcols:
        dv, vv = np.asarray(d)[rep], np.asarray(v)[rep]
        keys_cols.append([None if not vv[i] else
                          (dv[i].item() if hasattr(dv[i], "item") else dv[i])
                          for i in range(ngroups)])
    keys = list(zip(*keys_cols)) if keys_cols else [()] * ngroups

    partials = []
    for a in aggs:
        partials.append(_agg_lanes_vectorized(a, chunk, rows, starts, gid,
                                              ngroups, counts))
    return GroupResult(keys=keys, partials=partials, counts=counts)


def _agg_lanes_vectorized(a: AggDesc, chunk, rows, starts, gid, ngroups,
                          counts):
    """One aggregate's partial lanes over sorted segments (layout matches
    _states_to_lanes / the device kernel's finalized lanes)."""
    fn = a.fn
    if a.arg is None:     # COUNT(*)
        return [counts.copy()]
    d, v = a.arg.eval(chunk)
    d, v = np.asarray(d)[rows], np.asarray(v)[rows]
    has = (np.maximum.reduceat(v.astype(np.int64), starts)
           if len(rows) else np.zeros(ngroups, dtype=np.int64))
    if fn == AggFunc.COUNT:
        return [np.add.reduceat(v.astype(np.int64), starts)]
    if fn in (AggFunc.SUM, AggFunc.AVG):
        if d.dtype == np.dtype(object):
            # decimal/object sums fall back per-group (rare path)
            sums = np.array([sum(_sum_num(x) for x, ok in
                                 zip(d[s:e], v[s:e]) if ok)
                             for s, e in _seg_bounds(starts, len(rows))],
                            dtype=object)
        else:
            zero = d.dtype.type(0)
            sums = np.add.reduceat(np.where(v, d, zero), starts)
        if fn == AggFunc.SUM:
            return [sums, has]
        return [sums, np.add.reduceat(v.astype(np.int64), starts)]
    if fn in (AggFunc.MIN, AggFunc.MAX):
        red = np.minimum if fn == AggFunc.MIN else np.maximum
        if d.dtype == np.dtype(object):
            pick = min if fn == AggFunc.MIN else max  # strings: python
            vals = []
            for s, e in _seg_bounds(starts, len(rows)):
                seg = [x for x, ok in zip(d[s:e], v[s:e]) if ok]
                vals.append(pick(seg) if seg else 0)
            arr = np.array(vals, dtype=object)
        elif d.dtype == np.float64:
            ident = np.inf if fn == AggFunc.MIN else -np.inf
            arr = red.reduceat(np.where(v, d, ident), starts)
            arr = np.where(has > 0, arr, 0.0)
        else:
            ident = np.iinfo(np.int64).max if fn == AggFunc.MIN \
                else np.iinfo(np.int64).min
            arr = red.reduceat(np.where(v, d, ident), starts)
            arr = np.where(has > 0, arr, 0)
        return [arr, has]
    if fn == AggFunc.GROUP_CONCAT:
        vals, hasv = [], []
        for s, e in _seg_bounds(starts, len(rows)):
            parts = [_display_str(x, a.arg.ft)
                     for x, ok in zip(d[s:e], v[s:e]) if ok]
            hasv.append(1 if parts else 0)
            vals.append(a.sep.join(parts) if parts else "")
        return [np.array(vals, dtype=object),
                np.array(hasv, dtype=np.int64)]
    if fn == AggFunc.FIRST_ROW:
        n = len(rows)
        pos = np.where(v, np.arange(n), n)
        first = np.minimum.reduceat(pos, starts) if n else \
            np.zeros(ngroups, dtype=np.int64)
        idx = np.clip(first, 0, max(n - 1, 0))
        vals = d[idx] if n else np.zeros(ngroups, dtype=np.int64)
        if vals.dtype != np.dtype(object):
            vals = np.where(has > 0, vals, 0)
        return [vals, has]
    raise NotImplementedError(fn)


def _display_str(v, ft) -> str:
    """Chunk-layer value -> its SQL display text (GROUP_CONCAT
    concatenates DISPLAY values, not internal encodings: scaled decimal
    ints and epoch-micros datetimes must format like SELECT would)."""
    from tidb_tpu_torch.sqltypes import (EvalType, format_datetime,
                                   scaled_to_decimal)
    et = ft.eval_type
    if et == EvalType.DECIMAL:
        return str(scaled_to_decimal(int(v), max(ft.frac, 0)))
    if et == EvalType.DATETIME:
        return format_datetime(int(v), ft.tp)
    if isinstance(v, float):
        return str(int(v)) if v == int(v) else str(v)
    if isinstance(v, bytes):
        return v.decode("utf8", "replace")
    return str(v)


_NUM_PREFIX = None


def _sum_num(x):
    """SUM coercion for object lanes: exact ints (decimal scaled /
    bignum) pass through; strings take MySQL's leading-numeric-prefix
    cast to double ('1ff' -> 1.0, 'x' -> 0)."""
    if isinstance(x, str):
        global _NUM_PREFIX
        if _NUM_PREFIX is None:
            import re
            _NUM_PREFIX = re.compile(
                r"\s*[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")
        m = _NUM_PREFIX.match(x)
        return float(m.group(0)) if m else 0.0
    return int(x)


def _seg_bounds(starts, n):
    ends = np.append(starts[1:], n)
    return zip(starts, ends)


def _host_agg_rowloop(chunk: Chunk, mask, group_exprs,
                      aggs: list[AggDesc]) -> GroupResult:
    """Row-at-a-time path for DISTINCT aggregates (set state per group)."""
    gcols = _eval_cols(group_exprs, chunk)
    acols = [(None, None) if a.arg is None else a.arg.eval(chunk)
             for a in aggs]

    groups: dict[tuple, int] = {}
    keys: list[tuple] = []
    states: list[list] = []     # per group: per agg: lanes
    counts: list[int] = []

    from tidb_tpu_torch.sqltypes import collation_key
    ci = [e.ft.is_ci for e in group_exprs]
    n = chunk.num_rows
    for i in range(n):
        if not mask[i]:
            continue
        key = tuple(
            None if not v[i] else (d[i].item() if hasattr(d[i], "item")
                                   else d[i])
            for d, v in gcols)
        # group under the collation key; surface the first-seen variant
        gkey = tuple(collation_key(x) if c and x is not None else x
                     for x, c in zip(key, ci))
        gi = groups.get(gkey)
        if gi is None:
            gi = len(keys)
            groups[gkey] = gi
            keys.append(key)
            counts.append(0)
            states.append([_init_state(a) for a in aggs])
        counts[gi] += 1
        for ai, a in enumerate(aggs):
            _update_state(a, states[gi][ai], acols[ai], i)

    partials = []
    for ai, a in enumerate(aggs):
        lanes = _states_to_lanes(a, [s[ai] for s in states])
        partials.append(lanes)
    return GroupResult(keys=keys, partials=partials,
                       counts=np.array(counts, dtype=np.int64))


def host_scalar_agg(chunk: Chunk, filter_expr: Expression | None,
                    aggs: list[AggDesc]) -> GroupResult:
    mask = eval_filter_host(filter_expr, chunk)
    if mask.any() and not any(a.distinct for a in aggs):
        # one all-rows segment through the vectorized group-by
        return _host_agg_vectorized(chunk, mask, [], aggs)
    acols = [(None, None) if a.arg is None else a.arg.eval(chunk)
             for a in aggs]
    states = [_init_state(a) for a in aggs]
    cnt = 0
    for i in range(chunk.num_rows):
        if not mask[i]:
            continue
        cnt += 1
        for ai, a in enumerate(aggs):
            _update_state(a, states[ai], acols[ai], i)
    partials = [_states_to_lanes(a, [states[ai]])
                for ai, a in enumerate(aggs)]
    return GroupResult(keys=[()], partials=partials,
                       counts=np.array([cnt], dtype=np.int64))


def _init_state(a: AggDesc):
    if a.distinct:
        return {"seen": set(), "sum": 0, "cnt": 0, "min": None, "max": None}
    return {"sum": 0, "cnt": 0, "min": None, "max": None, "first": None,
            "has": False}


def _update_state(a: AggDesc, st, col, i):
    fn = a.fn
    if a.arg is None:   # COUNT(*)
        st["cnt"] += 1
        return
    d, v = col
    if not v[i]:
        return
    val = d[i].item() if hasattr(d[i], "item") else d[i]
    if a.distinct:
        if val in st["seen"]:
            return
        st["seen"].add(val)
    st["has"] = True if "has" in st else None
    if fn in (AggFunc.SUM, AggFunc.AVG):
        st["sum"] += val
        st["cnt"] += 1
    elif fn == AggFunc.COUNT:
        st["cnt"] += 1
    elif fn == AggFunc.MIN:
        st["min"] = val if st["min"] is None else min(st["min"], val)
    elif fn == AggFunc.MAX:
        st["max"] = val if st["max"] is None else max(st["max"], val)
    elif fn == AggFunc.FIRST_ROW:
        if st.get("first") is None:
            st["first"] = val
    elif fn == AggFunc.GROUP_CONCAT:
        st.setdefault("parts", []).append(_display_str(val, a.arg.ft))
    else:
        raise NotImplementedError(fn)


def _states_to_lanes(a: AggDesc, sts: list[dict]):
    """Convert host states into the kernel's partial-lane layout so
    HashAggregator merges both identically."""
    fn = a.fn
    n = len(sts)
    if fn == AggFunc.COUNT:
        return [np.array([s["cnt"] for s in sts], dtype=np.int64)]
    if fn == AggFunc.SUM:
        dtype = np.float64 if any(isinstance(s["sum"], float) for s in sts) \
            else np.int64
        return [np.array([s["sum"] for s in sts], dtype=dtype),
                np.array([1 if s["cnt"] else 0 for s in sts],
                         dtype=np.int64)]
    if fn == AggFunc.AVG:
        dtype = np.float64 if any(isinstance(s["sum"], float) for s in sts) \
            else np.int64
        return [np.array([s["sum"] for s in sts], dtype=dtype),
                np.array([s["cnt"] for s in sts], dtype=np.int64)]
    if fn in (AggFunc.MIN, AggFunc.MAX):
        key = "min" if fn == AggFunc.MIN else "max"
        has = [0 if sts[i][key] is None else 1 for i in range(n)]
        vals = [sts[i][key] if has[i] else 0 for i in range(n)]
        arr = np.array(vals, dtype=object) \
            if any(isinstance(v, (str, bytes)) for v in vals) else \
            np.asarray(vals)
        return [arr, np.array(has, dtype=np.int64)]
    if fn == AggFunc.GROUP_CONCAT:
        has = [1 if s.get("parts") else 0 for s in sts]
        vals = [a.sep.join(s.get("parts", [])) for s in sts]
        return [np.array(vals, dtype=object),
                np.array(has, dtype=np.int64)]
    if fn == AggFunc.FIRST_ROW:
        has = [0 if s.get("first") is None else 1 for s in sts]
        vals = [s.get("first") if has[i] else 0
                for i, s in enumerate(sts)]
        arr = np.array(vals, dtype=object) \
            if any(isinstance(v, (str, bytes)) for v in vals) else \
            np.asarray(vals)
        return [arr, np.array(has, dtype=np.int64)]
    raise NotImplementedError(fn)
