"""Encoded execution: operate on dictionary codes end to end.

A copy of the JAX package's ops/encoded.py (numpy only; it never touches
the device). Varlen columns ride the device as their int64 dictionary
codes (what `runtime.device_put_chunk` ships), so:

* `translate_filter` rewrites a host-only string filter (EQ/NE/<=>/IN/
  IS [NOT] NULL over varlen columns, AND/OR combinations, device-safe
  subtrees passed through) into code space: each string constant is
  pre-encoded to its code in the SAME dictionary, so equality over codes
  is equality over values by construction (collation-folded dictionaries
  keep _ci semantics);
* `code_translation` re-keys one dictionary's codes into another's with a
  single vectorized gather: the join build/probe bridge when the two
  sides hold different dictionaries (sides sharing one dictionary, the
  memoized `dict_encode` of a column, skip even that);
* `encoded_lane` hands a join the pre-encoded lane of a bare varlen
  ColumnRef;
* `decode_codes` is the full-column late-materializer.

Anything outside this vocabulary returns None and the caller runs the
decoded path. The JAX package's lint registry of late-materialize sites
(`LATE_MATERIALIZE`) is not carried: the port has no lint yet.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch.chunk import dict_encode
from tidb_tpu_torch.expression.core import (ColumnRef, Constant, Op,
                                            ScalarFunc, func)
from tidb_tpu_torch.sqltypes import EvalType, TypeCode, new_int_field

__all__ = ["CodeColumnRef", "translate_filter", "code_translation",
           "encoded_lane", "decode_codes", "MISSING_CODE"]

# a code no live row ever carries (live codes >= 0, NULL is -1): an
# encoded constant absent from the dictionary compares equal to nothing
MISSING_CODE = -2

_CODE_FT = new_int_field()


class CodeColumnRef(ColumnRef):
    """A varlen column viewed as its int64 dictionary codes: the lane the
    device actually holds. Device-safe by construction: the inherited
    eval_xp reads cols[idx], which on the device path IS the code lane.
    Never evaluated on the host."""

    def __repr__(self):
        return f"codes({self.name or f'col#{self.idx}'})"

    def __hash__(self):
        return hash(("codecol", self.idx))

    def eval(self, chunk):
        # the host chunk holds VALUES in this lane, not codes: comparing
        # strings against an int code would silently drop every row
        raise RuntimeError("encoded filter evaluated on the host path")


class _Unsupported(Exception):
    """Filter node outside the encodable vocabulary."""


def _dict_key(v, ci: bool):
    if ci:
        from tidb_tpu_torch.sqltypes import collation_key
        return collation_key(v)
    return v


def _dict_map(values: list, ci: bool) -> dict:
    return {_dict_key(v, ci): c for c, v in enumerate(values)}


def _is_varlen_ref(e, chunk) -> bool:
    return (type(e) is ColumnRef and
            e.ft.eval_type == EvalType.STRING and
            e.ft.tp != TypeCode.JSON and
            e.idx < chunk.num_cols and
            not chunk.columns[e.idx].fixed_width)


def _code_const(values: list, ci: bool, const: Constant) -> Constant:
    """Pre-encode one string constant against the dictionary. NULL
    constants stay NULL; absent values get MISSING_CODE."""
    v = const.value
    if v is None:
        return Constant(None, _CODE_FT)
    if not isinstance(v, (str, bytes)):
        raise _Unsupported(f"non-string constant {v!r}")
    code = _dict_map_cached(values, ci).get(_dict_key(v, ci))
    return Constant(int(code) if code is not None else MISSING_CODE,
                    _CODE_FT)


# one-slot (values -> map) cache keyed by list identity: dictionaries are
# memoized per column, so repeated translations rebuild nothing
_map_cache: tuple = (None, False, None)


def _dict_map_cached(values: list, ci: bool) -> dict:
    global _map_cache
    vals, cci, m = _map_cache
    if vals is values and cci is ci and len(m) == len(values):
        return m
    m = _dict_map(values, ci)
    _map_cache = (values, ci, m)
    return m


def translate_filter(expr, chunk, dict_of=None):
    """Rewrite a host-only filter into code space. -> a device-safe
    Expression over dictionary codes, or None when any node falls
    outside the encodable vocabulary. `dict_of(col_idx) -> values list`
    overrides where dictionaries come from (default: the chunk's own
    memoized dict_encode, which is what `device_put_chunk` ships)."""
    if expr is None:
        return None
    if dict_of is None:
        def dict_of(j):
            return dict_encode(chunk.columns[j])[1]
    try:
        return _translate(expr, chunk, dict_of)
    except _Unsupported:
        return None


def _translate(e, chunk, dict_of):
    if e.is_device_safe():
        return e                    # mixed AND/OR trees pass through
    if not isinstance(e, ScalarFunc):
        raise _Unsupported(type(e).__name__)
    op = e.op
    if op in (Op.AND, Op.OR):
        return func(op, _translate(e.args[0], chunk, dict_of),
                    _translate(e.args[1], chunk, dict_of))
    if op in (Op.IS_NULL, Op.IS_NOT_NULL):
        a = e.args[0]
        if not _is_varlen_ref(a, chunk):
            raise _Unsupported(repr(a))
        return func(op, CodeColumnRef(a.idx, _CODE_FT, a.name))
    if op in (Op.EQ, Op.NE, Op.NULLEQ):
        a, b = e.args
        if _is_varlen_ref(a, chunk) and isinstance(b, Constant):
            ref, const = a, b
        elif _is_varlen_ref(b, chunk) and isinstance(a, Constant):
            ref, const = b, a
        else:
            raise _Unsupported(repr(e))
        values = dict_of(ref.idx)
        if values is None:
            raise _Unsupported(f"no dictionary for col#{ref.idx}")
        code_ref = CodeColumnRef(ref.idx, _CODE_FT, ref.name)
        ci = ref.ft.is_ci
        if ref is a:
            return func(op, code_ref, _code_const(values, ci, const))
        return func(op, _code_const(values, ci, const), code_ref)
    if op == Op.IN:
        a = e.args[0]
        if not _is_varlen_ref(a, chunk) or not isinstance(e.extra, list):
            raise _Unsupported(repr(e))
        values = dict_of(a.idx)
        if values is None:
            raise _Unsupported(f"no dictionary for col#{a.idx}")
        ci = a.ft.is_ci
        codes = []
        for v in e.extra:
            if not isinstance(v, (str, bytes)):
                raise _Unsupported(f"non-string IN item {v!r}")
            c = _dict_map_cached(values, ci).get(_dict_key(v, ci))
            codes.append(int(c) if c is not None else MISSING_CODE)
        return func(Op.IN, CodeColumnRef(a.idx, _CODE_FT, a.name),
                    extra=codes)
    raise _Unsupported(repr(e))


def encoded_lane(expr, chunk):
    """(codes, values) when `expr` is a bare varlen ColumnRef into
    `chunk` (the pre-encoded key lane a join consumes directly), else
    None. Two sides reading the same column share ONE dictionary object,
    which identity comparison detects."""
    if not _is_varlen_ref(expr, chunk):
        return None
    return dict_encode(chunk.columns[expr.idx])


def code_translation(src_values: list, dst_values: list, ci: bool,
                     dst_map: dict | None = None) -> np.ndarray:
    """Re-keying bridge between two dictionaries: an int64 array T with
    T[src_code] = the matching code in `dst_values`, or a unique negative
    no-match code (<= MISSING_CODE) when the value is absent, so rows stay
    live but match nothing. The last slot maps the NULL code (-1) to -1.
    `dst_map` lets a caller with a cached value->code map skip the
    O(|dst|) rebuild."""
    if dst_map is None:
        dst_map = _dict_map(dst_values, ci)
    t = np.empty(len(src_values) + 1, dtype=np.int64)
    for c, v in enumerate(src_values):
        hit = dst_map.get(_dict_key(v, ci))
        t[c] = hit if hit is not None else MISSING_CODE - c
    t[-1] = -1
    return t


def decode_codes(values: list, codes: np.ndarray) -> np.ndarray:
    """Gather dictionary values by code into an object array (NULL/-1 and
    no-match codes decode to None). Only at operator-output boundaries."""
    table = np.empty(len(values) + 1, dtype=object)
    for c, v in enumerate(values):
        table[c] = v
    table[-1] = None
    safe = np.where(codes >= 0, codes, len(values))
    return table[safe]
