"""Hash aggregation on the device: filter + group-by + partial agg.

The port of the JAX package's ops/hashagg.py. One dispatch evaluates the
filter, builds the group table, and reduces every aggregate lane, all as
torch work queued on the device's stream; `finalize` reads the whole
result back in one copy (the only sync) and runs the host tail.

    1. group table: direct code-indexed slots for dict-encoded string keys
       (TPC-H Q1's shape), a runtime choice between direct slots and the
       packed sort for bare int keys, the packed sort otherwise
    2. one segment reduction per (merge-op, dtype) over stacked lanes;
       every sum goes through ops/segsum (the hand-written kernel on CUDA)
    3. a second independent hash verifies per-group key agreement, so a
       64-bit collision is detected (caller falls back to the host path)

Deviations from the JAX package, forced by torch:
  * `lax.cond` in `_cond_group_table` becomes both branches plus a
    `torch.where` select on the device (no host `if` on a tensor);
  * no buffer donation (the `_jitd` twins) and no compile cache: torch
    runs the ops eagerly;
  * group ids stay int32 for the segment-sum kernel and widen to int64
    for torch's scatter ops;
  * torch's `>>` on int64 is arithmetic, so splitmix64's logical shifts
    are masked; int64 multiplies wrap exactly as uint64 ones do, so the
    hash is bit-identical to `_hash_keys(np, ...)` of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from tidb_tpu_torch.chunk import Chunk
from tidb_tpu_torch.expression import AggDesc, AggFunc, Expression
from tidb_tpu_torch.ops import runtime, segsum, tnp
from tidb_tpu_torch.sqltypes import EvalType

__all__ = ["AggSpec", "HashAggKernel", "ScalarAggKernel", "HashAggregator",
           "CapacityError", "CollisionError", "DeviceRejectError",
           "GroupResult", "finalize_group_result", "kernel_for",
           "group_partial", "host_hash_keys"]

AggSpec = AggDesc

_SENTINEL_MASKED = -(1 << 63)                  # all filtered-out rows
_FILL = (1 << 63) - 1                          # group-table padding
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _signed(u: int) -> int:
    """uint64 constant -> the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


# golden-ratio mixing constants (splitmix64, public domain)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)
_GOLD = _signed(0x9E3779B97F4A7C15)


class CapacityError(Exception):
    """More groups than the kernel's static capacity: re-plan with a larger
    capacity or fall back to the host path."""


class CollisionError(Exception):
    """Two distinct key tuples collided in 64-bit hash space (detected by
    the check hash); fall back to the host path."""


class DeviceRejectError(ValueError):
    """The plan is not device-safe BY DESIGN (string computation, host-
    only aggregate): the designed device->host fallback signal."""


def _srl(h, s: int):
    """Logical right shift of the uint64 bits held in an int64 tensor."""
    return (h >> s) & ((1 << (64 - s)) - 1)


def _splitmix(h):
    h = h + _GOLD
    h = (h ^ _srl(h, 30)) * _MIX1
    h = (h ^ _srl(h, 27)) * _MIX2
    return h ^ _srl(h, 31)


# lint: exempt[dtype-discipline] row hashes are int64 by contract: splitmix64 bit patterns, sentinel headroom at both int64 extremes (this helper feeds _hash_keys its 64-bit words)
def _key_bits(d):
    """Exact 64-bit pattern of a key lane (as int64): floats are bitcast,
    with -0.0 normalized to +0.0 first since SQL treats them as equal."""
    if d.dtype == torch.float64:
        d = torch.where(d == 0.0, torch.zeros_like(d), d)
        return d.view(torch.int64)
    return d.to(torch.int64)


# lint: exempt[dtype-discipline] row hashes are int64 by contract: splitmix64 bit patterns, sentinel headroom at both int64 extremes
def _hash_keys(key_cols, n, seed: int, device):
    """Combine (data, valid) key lanes into one int64 hash per row,
    bit-identical to the JAX package's `_hash_keys(np, ...)`. Validity
    mixes as its own lane, so NULL groups apart from every data value."""
    h = torch.full((n,), _signed(seed), dtype=torch.int64, device=device)
    for d, v in key_cols:
        u = _key_bits(d)
        h = _splitmix(h ^ torch.where(v, u, 0))
        h = _splitmix(h ^ v.to(torch.int64))
    # reserve the sentinel values for masked/fill
    h = torch.where(h == _SENTINEL_MASKED, -(1 << 63) + 1, h)
    return torch.where(h == _FILL, (1 << 63) - 2, h)


_U_GOLD, _U_MIX1, _U_MIX2 = (np.uint64(c % (1 << 64))
                             for c in (_GOLD, _MIX1, _MIX2))


def _host_splitmix(h: np.ndarray) -> np.ndarray:
    h = h + _U_GOLD
    h = (h ^ (h >> np.uint64(30))) * _U_MIX1
    h = (h ^ (h >> np.uint64(27))) * _U_MIX2
    return h ^ (h >> np.uint64(31))


def host_hash_keys(key_cols, n: int, seed: int) -> np.ndarray:
    """Numpy twin of `_hash_keys` for host-side routing (the hybrid join's
    partitions, `host_match_pairs`): uint64 arithmetic, bit-identical to
    the torch version and to the JAX package's `_hash_keys(np, ...)`."""
    h = np.full(n, np.uint64(seed % (1 << 64)), dtype=np.uint64)
    for d, v in key_cols:
        d = np.asarray(d)
        if d.dtype == np.float64:
            u = np.where(d == 0.0, 0.0, d).view(np.uint64)
        else:
            u = d.astype(np.uint64)
        v = np.asarray(v, dtype=bool)
        h = _host_splitmix(h ^ np.where(v, u, np.uint64(0)))
        h = _host_splitmix(h ^ v.astype(np.uint64))
    out = h.view(np.int64)
    out = np.where(out == _SENTINEL_MASKED, np.int64(-(1 << 63) + 1), out)
    return np.where(out == _FILL, np.int64((1 << 63) - 2), out)


def _direct_group_mode(group_exprs) -> bool:
    """True when every group key is a dict-encoded string ColumnRef: the
    device sees small dense int64 codes, so group slots are indexed
    directly (no sort, no hash, no collision possible). TPC-H Q1's
    shape (group by returnflag, linestatus)."""
    from tidb_tpu_torch.expression.core import ColumnRef
    from tidb_tpu_torch.sqltypes import TypeCode
    if not group_exprs:
        return False
    return all(isinstance(g, ColumnRef) and
               g.ft.eval_type == EvalType.STRING and
               g.ft.tp != TypeCode.JSON
               for g in group_exprs)


# lint: exempt[dtype-discipline] group codes carry exact int64 key values (scaled decimals / epoch-micros exceed float range)
def _direct_group_table(xp, group_exprs, cols, n, mask, C):
    """Direct-indexed group table -> (uniq[C], inv[n] int32, tot).
    Strides come from data maxima. Slot C-1 is the masked-rows slot;
    combined codes clamp to C-2 and `tot` overshoots C when clamping
    occurred, so the capacity escalation re-plans as in the hash mode.
    uniq holds the combined code per live slot."""
    combined = None
    for g in group_exprs:
        d, v = g.eval_xp(xp, cols, n)
        code = torch.where(v, d.to(torch.int64) + 1, 0)
        code = torch.where(mask, code, 0)
        if combined is None:
            combined = code
        else:
            combined = combined * (torch.amax(code) + 1) + code
    tot = torch.amax(torch.where(mask, combined, -1)) + 2
    slot = torch.clamp(combined, max=C - 2)
    inv = torch.where(mask, slot, C - 1)
    uniq = torch.full((C,), _FILL, dtype=torch.int64, device=mask.device)
    uniq.scatter_(0, inv, torch.where(mask, slot, _SENTINEL_MASKED))
    return uniq, inv.to(torch.int32), tot


def _cond_direct_mode(group_exprs) -> bool:
    """True when every group key is a bare ColumnRef of INT, dict-string,
    DATETIME or DURATION kind — the shape where a runtime range check can
    pick direct code-indexed slots over the packed sort."""
    from tidb_tpu_torch.expression.core import ColumnRef
    from tidb_tpu_torch.sqltypes import TypeCode
    if not group_exprs:
        return False
    for g in group_exprs:
        if not isinstance(g, ColumnRef) or g.ft.tp == TypeCode.JSON:
            return False
        if g.ft.eval_type not in (EvalType.INT, EvalType.STRING,
                                  EvalType.DATETIME,
                                  EvalType.DURATION):
            return False
    return True


# lint: exempt[dtype-discipline] exact int64 key codes + float64 span product (span overflow check must not round at 2^53)
def _cond_group_table(xp, group_exprs, cols, n, mask, h, C,
                      direct_limit=None):
    """Runtime-selected group table: if the keys' (min..max) span product
    fits the capacity, index slots directly by normalized codes; otherwise
    the packed-sort table over the precomputed hash `h`. The JAX package
    picks with lax.cond; here both branches run and a device-side select
    picks, so the choice never syncs with the host. `direct_limit` caps
    the direct branch below the capacity (tidb_tpu_direct_agg_slots)."""
    codes, spans, span_fs = [], [], []
    for g in group_exprs:
        d, v = g.eval_xp(xp, cols, n)
        d = d.to(torch.int64)
        live = mask & v
        lo = torch.amin(torch.where(live, d, _I64_MAX))
        hi_raw = torch.amax(torch.where(live, d, _I64_MIN))
        # NULL -> 0; live values -> 1.. (saturate when no live rows)
        code = torch.where(live, torch.clamp(d - lo, min=0) + 1, 0)
        codes.append(code)
        spans.append(torch.amax(code) + 1)
        # the smallness decision uses raw min/max in float64: the int64
        # code math wraps when the raw span exceeds 2^63
        span_fs.append(torch.clamp(
            hi_raw.to(torch.float64) - lo.to(torch.float64) + 2.0, min=1.0))
    span_prod = torch.prod(torch.stack(span_fs))
    bound = C - 2 if direct_limit is None else min(C - 2, direct_limit)
    small = span_prod <= float(bound)

    combined = codes[0]
    for c, s in zip(codes[1:], spans[1:]):
        combined = combined * s + c
    d_tot = torch.amax(torch.where(mask, combined, -1)) + 2
    # unlike lax.cond, the direct branch runs even when not selected, and
    # then its int64 code math may have wrapped negative: clamp into the
    # table so its scatter stays in bounds (a selected branch never wraps)
    d_inv = torch.where(mask, torch.clamp(combined, 0, C - 2), C - 1)
    # slot identity is the key-tuple hash, not the dense code (the hash
    # mode's merge contract)
    d_uniq = torch.full((C,), _FILL, dtype=torch.int64, device=mask.device)
    d_uniq.scatter_(0, d_inv, torch.where(mask, h, _SENTINEL_MASKED))

    h_uniq, h_inv, h_tot = _group_table(h, n, C, mask=mask)
    return (torch.where(small, d_uniq, h_uniq),
            torch.where(small, d_inv.to(torch.int32), h_inv),
            torch.where(small, d_tot, h_tot))


# lint: exempt[dtype-discipline] packed sort rides the int64 hash lanes (row index bit-packed into the low hash bits)
def _group_table(x, m, C, mask=None):
    """Dense group-id table from one PACKED sort: the hash is quantized to
    (64 - ceil_log2(m)) bits, the element index rides the freed low bits,
    and ONE sort yields uniq, inverse and the true distinct count.
    Quantization merging two hashes is caught by the caller's dual-hash
    check, like a full collision. The bottom and top quanta are reserved
    so real hashes never alias _SENTINEL_MASKED or _FILL.

    -> (uniq[C] ascending with _FILL padding, inv[m] int32, tot)."""
    bits = max(1, int(m - 1).bit_length()) if m > 1 else 1
    Q = 1 << bits
    low = Q - 1
    qfill = (_FILL >> bits) << bits
    hq = (x >> bits) << bits
    hq = torch.where(hq == _SENTINEL_MASKED, _SENTINEL_MASKED + Q, hq)
    hq = torch.where(hq == qfill, qfill - Q, hq)
    hq = torch.where(x == _FILL, qfill, hq)
    hq = torch.where(x == _SENTINEL_MASKED, _SENTINEL_MASKED, hq)
    if mask is not None:
        hq = torch.where(mask, hq, _SENTINEL_MASKED)
    packed = hq | torch.arange(m, dtype=torch.int64, device=x.device)
    s, _ = torch.sort(packed)
    sh = (s >> bits) << bits
    row = s & low
    newg = torch.ones(m, dtype=torch.bool, device=x.device)
    newg[1:] = sh[1:] != sh[:-1]
    sid = torch.cumsum(newg, 0) - 1
    tot = sid[-1] + 1
    sidc = torch.clamp(sid, max=C - 1)
    inv = torch.zeros(m, dtype=torch.int64, device=x.device)
    inv.scatter_(0, row, sidc)
    uniq = torch.full((C,), _FILL, dtype=torch.int64, device=x.device)
    uniq.scatter_(0, sidc, sh)
    uniq = torch.where(uniq == qfill, _FILL, uniq)
    return uniq, inv.to(torch.int32), tot


def _identity(op: str, dtype: torch.dtype):
    """Empty-segment value of jax.ops.segment_min/max for `dtype`."""
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _segment_minmax(x, inv64, C, op):
    """jax.ops.segment_min/max: an empty segment keeps the identity."""
    out = torch.full((C,) + tuple(x.shape[1:]), _identity(op, x.dtype),
                     dtype=x.dtype, device=x.device)
    idx = inv64 if x.dim() == 1 else inv64[:, None].expand_as(x)
    return out.scatter_reduce_(0, idx, x, "amin" if op == "min" else "amax",
                               include_self=True)


class _SegBatch:
    """Batches segment reductions: every requested lane with the same
    (merge-op, dtype) reduces in ONE segment op over stacked [n, k] data.
    dtype-separated stacking keeps int64 lanes exact.

    Sum lanes may carry a `valid` mask: all sums of one dtype go to
    ops/segsum in one stacked call with a per-lane mask (lanes without a
    mask get an all-true one), so the mask is applied inside the kernel
    and no masked copy of the values is written. For Q1 that is one call
    over 12 int64 lanes."""

    def __init__(self, inv, capacity: int):
        self.inv = inv                  # int32 [n]
        self.capacity = capacity
        self._reqs: list = []           # (op, array[n], valid[n] | None)
        self._out: list | None = None

    def add(self, x, op: str, valid=None) -> int:
        self._reqs.append((op, x, valid))
        return len(self._reqs) - 1

    # lint: exempt[dtype-discipline] scatter_reduce (the MIN/MAX segment path) takes int64 index tensors: the segment ids widen once per batch
    def run(self) -> None:
        out: list = [None] * len(self._reqs)
        groups: dict = {}
        for i, (op, x, valid) in enumerate(self._reqs):
            groups.setdefault((op, x.dtype), []).append((i, x, valid))
        inv64 = None
        for (op, _dt), reqs in groups.items():
            if op == "sum":
                xs = torch.stack([x for _i, x, _v in reqs], dim=1)
                valid = None
                if any(v is not None for _i, _x, v in reqs):
                    ones = None
                    ms = []
                    for _i, x, v in reqs:
                        if v is None:
                            if ones is None:
                                ones = torch.ones_like(x, dtype=torch.bool)
                            v = ones
                        ms.append(v)
                    valid = torch.stack(ms, dim=1)
                r = segsum.segment_sum(xs, self.inv, self.capacity,
                                       valid=valid)
            else:
                if inv64 is None:
                    inv64 = self.inv.to(torch.int64)
                xs = torch.stack([x for _i, x, _v in reqs], dim=1)
                r = _segment_minmax(xs, inv64, self.capacity, op)
            for j, (i, _x, _v) in enumerate(reqs):
                out[i] = r[:, j]
        self._out = out

    def get(self, i: int):
        return self._out[i]


# lint: exempt[dtype-discipline] int64 sum lanes: decimal sums exceed 2^53, float64 promotion would corrupt them
def _agg_requests(xp, agg: AggDesc, cols, n, mask, batch: _SegBatch,
                  arange=None, offs=None, row_ids=None):
    """Phase 1 of an aggregate's partial-state lanes: enqueue the per-row
    inputs on `batch`, return assemble(get) -> [(array[capacity],
    merge_op)] for after batch.run(). With `offs` (a plane shard's
    global row offset) FIRST_ROW indices are globalized for the
    cross-shard merge; `row_ids` (the original probe row of each
    compacted row, ops/meshjoin.py) replaces the row identity."""
    fn = agg.fn
    if agg.arg is not None:
        d, v = agg.arg.eval_xp(xp, cols, n)
        live = mask & v
    else:
        d, live = None, mask
    live_i = live.to(torch.int64)

    if fn == AggFunc.COUNT:
        i0 = batch.add(live_i, "sum")
        return lambda g: [(g(i0), "sum")]
    if fn == AggFunc.SUM:
        # the mask rides the request: applied inside the segment-sum
        i0 = batch.add(d, "sum", valid=live)
        i1 = batch.add(live_i, "max")
        return lambda g: [(g(i0), "sum"), (g(i1), "max")]
    if fn == AggFunc.AVG:
        i0 = batch.add(d, "sum", valid=live)
        i1 = batch.add(live_i, "sum")
        return lambda g: [(g(i0), "sum"), (g(i1), "sum")]
    if fn == AggFunc.MIN:
        ident = float("inf") if d.dtype == torch.float64 else _I64_MAX
        i0 = batch.add(xp.where(live, d, ident), "min")
        i1 = batch.add(live_i, "max")
        return lambda g: [(g(i0), "min"), (g(i1), "max")]
    if fn == AggFunc.MAX:
        ident = float("-inf") if d.dtype == torch.float64 else _I64_MIN
        i0 = batch.add(xp.where(live, d, ident), "max")
        i1 = batch.add(live_i, "max")
        return lambda g: [(g(i0), "max"), (g(i1), "max")]
    if fn == AggFunc.FIRST_ROW:
        if row_ids is not None:
            i0 = batch.add(torch.where(live, row_ids, _I64_MAX), "min")
            i1 = batch.add(live_i, "max")
            return lambda g: [(g(i0), "min"), (g(i1), "max")]
        if arange is None:
            arange = xp.arange(n)
        i0 = batch.add(torch.where(live, arange, n), "min")
        i1 = batch.add(live_i, "max")
        if offs is None:
            return lambda g: [(g(i0), "min"), (g(i1), "max")]

        def assemble(g):
            first = torch.where(g(i1) > 0, offs + g(i0), _I64_MAX)
            return [(first, "min"), (g(i1), "max")]
        return assemble
    raise NotImplementedError(f"device agg {fn}")


def _validate_device_exprs(filter_expr, group_exprs, aggs) -> None:
    """Device kernels see dict-encoded int64 codes for varlen columns, so a
    string column may appear ONLY as a bare group-key ColumnRef (or a
    FIRST_ROW argument, gathered on the host)."""
    from tidb_tpu_torch.expression import ColumnRef
    if filter_expr is not None and not filter_expr.is_device_safe():
        raise DeviceRejectError("filter expression is not device-safe; "
                                "planner must split string predicates to "
                                "the host path")
    for g in group_exprs:
        if not g.is_device_safe() and not isinstance(g, ColumnRef):
            raise DeviceRejectError(f"group expr {g!r} computes over a "
                                    "varlen column; pre-project it on the "
                                    "host")
    for a in aggs:
        if a.fn == AggFunc.GROUP_CONCAT:
            raise DeviceRejectError("GROUP_CONCAT aggregates on the host")
        if a.arg is not None and not a.arg.is_device_safe():
            if not (a.fn == AggFunc.FIRST_ROW and
                    isinstance(a.arg, ColumnRef)):
                raise DeviceRejectError(
                    f"agg arg {a.arg!r} is not device-safe")


def _columns_used(filter_expr, group_exprs, aggs) -> set:
    used: set = set()
    if filter_expr is not None:
        used |= filter_expr.columns_used()
    for g in group_exprs:
        used |= g.columns_used()
    for a in aggs:
        if a.arg is not None:
            used |= a.arg.columns_used()
    return used


@dataclass
class GroupResult:
    """Partial aggregation result of one chunk."""

    keys: list[tuple]            # group key tuples (host python values)
    partials: list[np.ndarray]   # per agg: [lanes][num_groups] arrays
    counts: np.ndarray           # rows per group


def finalize_group_result(chunk: Chunk, group_exprs, aggs, gidx: np.ndarray,
                          rep_rows: np.ndarray, lanes_per_agg,
                          counts: np.ndarray) -> GroupResult:
    """Shared host tail of the device kernels: recover exact group-key
    values from representative rows (strings included), materialize
    FIRST_ROW values, and package a GroupResult."""
    sub = chunk.take(rep_rows)
    key_cols = []
    n = len(gidx)
    for g in group_exprs:
        d, v = g.eval(sub)
        # tolist() gives each numpy scalar's .item() (an object array's
        # elements as they are), in one pass
        vals = d[:n].tolist() if isinstance(d, np.ndarray) else \
            [(d[i].item() if hasattr(d[i], "item") else d[i])
             for i in range(n)]
        key_cols.append([x if ok else None
                         for x, ok in zip(vals, np.asarray(v)[:n].tolist())])
    keys = list(zip(*key_cols)) if key_cols else [()] * len(gidx)
    partials = []
    for a, ls in zip(aggs, lanes_per_agg):
        if a.fn == AggFunc.FIRST_ROW:
            idx = ls[0]
            hasv = ls[1] > 0
            safe_idx = np.where(hasv, idx, 0).astype(np.int64)
            d, _v = a.arg.eval(chunk.take(safe_idx))
            vals = np.where(hasv, d, 0) if d.dtype != object else d
            ls = [vals, hasv.astype(np.int64)]
        partials.append(ls)
    return GroupResult(keys=keys, partials=partials, counts=counts)


# lint: exempt[dtype-discipline] int64 slot init: group slots hold exact key codes and decimal sums
def group_partial(xp, group_exprs, aggs, cols, n, mask, capacity,
                  force_hash: bool = False, direct_limit=None):
    """Group table (direct-indexed / runtime-selected / packed-sort per
    the group-key shape), one batched reduction per (merge-op, dtype),
    dual-hash collision check. -> (uniq, nuniq, collided, counts, rep,
    lanes), all tensors on the device."""
    device = mask.device
    if not force_hash and _direct_group_mode(group_exprs):
        uniq, inv, nuniq = _direct_group_table(
            xp, group_exprs, cols, n, mask, capacity)
        h2 = torch.zeros(n, dtype=torch.int64, device=device)
    elif not force_hash and _cond_direct_mode(group_exprs):
        key_cols = [g.eval_xp(xp, cols, n) for g in group_exprs]
        h = _hash_keys(key_cols, n, 0x517CC1B727220A95, device)
        h2 = _hash_keys(key_cols, n, 0x2545F4914F6CDD1D, device)
        uniq, inv, nuniq = _cond_group_table(
            xp, group_exprs, cols, n, mask, h, capacity,
            direct_limit=direct_limit)
    else:
        key_cols = [g.eval_xp(xp, cols, n) for g in group_exprs]
        h = _hash_keys(key_cols, n, 0x517CC1B727220A95, device)
        h2 = _hash_keys(key_cols, n, 0x2545F4914F6CDD1D, device)
        uniq, inv, nuniq = _group_table(h, n, capacity, mask=mask)
    mask_i = mask.to(torch.int64)
    arange = torch.arange(n, dtype=torch.int64, device=device)
    b = _SegBatch(inv, capacity)
    i_cmin = b.add(torch.where(mask, h2, _I64_MAX), "min")
    i_cmax = b.add(torch.where(mask, h2, _I64_MIN), "max")
    i_live = b.add(mask_i, "max")
    i_cnt = b.add(mask_i, "sum")
    i_rep = b.add(torch.where(mask, arange, n), "min")
    assembles = [_agg_requests(xp, a, cols, n, mask, b, arange=arange)
                 for a in aggs]
    b.run()
    # collision check: within each group, the check hash must agree
    collided = torch.any((b.get(i_live) > 0) &
                         (b.get(i_cmin) != b.get(i_cmax)))
    counts = b.get(i_cnt)
    rep = b.get(i_rep)
    lanes = [[l for l, _op in assemble(b.get)] for assemble in assembles]
    return uniq, nuniq, collided, counts, rep, lanes


# -- one readback per dispatch ----------------------------------------------


# lint: exempt[dtype-discipline] the one readback buffer is 8-byte words: bool and int lanes widen so every lane shares one int64 packing and one copy back
def _pack(tree):
    """Flatten a result tree of tensors into ONE int64 device buffer
    (float64 lanes by bit view, bools and scalars widened), so finalize
    pays one device->host copy. -> (buffer, layout)."""
    flat, layout = [], []

    def walk(t):
        if isinstance(t, (list, tuple)):
            return [walk(x) for x in t]
        t = t.reshape(-1)
        if t.dtype == torch.float64:
            kind, t = "f8", t.view(torch.int64)
        elif t.dtype == torch.bool:
            kind, t = "b1", t.to(torch.int64)
        else:
            kind, t = "i8", t.to(torch.int64)
        flat.append(t)
        layout.append((kind, t.numel()))
        return len(layout) - 1

    shape = walk(tree)
    return torch.cat(flat), (shape, layout)


def _unpack(host: np.ndarray, spec):
    shape, layout = spec
    arrays, off = [], 0
    for kind, size in layout:
        a = host[off:off + size]
        off += size
        arrays.append(a.view(np.float64) if kind == "f8" else
                      a.astype(bool) if kind == "b1" else a)

    def build(s):
        return [build(x) for x in s] if isinstance(s, list) else arrays[s]
    return build(shape)


def _readback(pending):
    buf, spec = pending
    return _unpack(buf.cpu().numpy(), spec)


class HashAggKernel:
    """Filter + group + partial agg over one chunk schema, on one device.

    group_exprs must be device-safe (strings dict-encoded upstream by
    runtime.device_put_chunk; their ColumnRefs then see int64 codes)."""

    def __init__(self, filter_expr: Expression | None,
                 group_exprs: Sequence[Expression],
                 aggs: Sequence[AggDesc], capacity: int = 4096,
                 force_hash: bool = False, direct_limit: int | None = None,
                 device=None):
        """`force_hash` degrades the direct-indexed group table to the
        packed-sort hash path (set by kernel_for when a capacity
        escalation crosses tidb_tpu_direct_agg_slots); `direct_limit`
        caps the runtime-selected direct branch the same way."""
        self.device = runtime.resolve_device(device)
        self.filter_expr = filter_expr
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self.capacity = capacity
        self.force_hash = force_hash
        self.direct_limit = direct_limit
        _validate_device_exprs(filter_expr, self.group_exprs, self.aggs)
        self.used = _columns_used(filter_expr, self.group_exprs, self.aggs)

    def _kernel(self, cols, nrows):
        n = next(c for c in cols if c is not None)[0].shape[0]
        xp = tnp.on(self.device)
        mask = runtime.filter_mask_xp(xp, self.filter_expr, cols, n)
        mask = mask & (torch.arange(n, device=self.device) < nrows)
        return group_partial(xp, self.group_exprs, self.aggs, cols, n,
                             mask, self.capacity,
                             force_hash=self.force_hash,
                             direct_limit=self.direct_limit)

    def scratch_nbytes(self, chunk: Chunk) -> int:
        """Device bytes a dispatch stages BEYOND the input columns: the
        group-table and lane scratch at the kernel's static capacity —
        the share a fused dispatch over an HBM-cache-resident block
        still pays (the input bytes stay on the cache's own ledger).
        The JAX package's count."""
        return self.capacity * 8 * (5 + 2 * len(self.aggs))

    def dispatch_nbytes(self, chunk: Chunk) -> int:
        """Device bytes one dispatch stages, sized from shapes at
        dispatch time: the padded input columns (varlen ships as int64
        dict codes, every lane carries bool validity) plus the scratch.
        The JAX package's count: it ships every column, where the port
        ships the used ones, so this bills the reference's footprint."""
        from tidb_tpu_torch import memtrack
        n = runtime.bucket_size(max(chunk.num_rows, 1))
        return memtrack.device_put_bytes(chunk, n) + \
            self.scratch_nbytes(chunk)

    def dispatch(self, chunk: Chunk, dev_cols=None):
        """Pad + transfer + enqueue WITHOUT a host sync: the pipeline's
        overlap point. With dev_cols (device-resident padded columns) the
        upload is skipped. -> opaque pending token."""
        cols = dev_cols
        if cols is None:
            cols, _dicts = runtime.device_put_chunk(chunk, self.device,
                                                    used=self.used)
        return _pack(self._kernel(cols, chunk.num_rows))

    def finalize(self, chunk: Chunk, pending) -> GroupResult:
        """Blocking half: one device->host copy of the whole result, then
        the host tail."""
        uniq, nuniq, collided, counts, rep, lanes = _readback(pending)
        nuniq = int(nuniq[0])
        # capacity before collision: overflow groups clamp into the last
        # slot, which then trips the collision check spuriously
        if nuniq > self.capacity:
            err = CapacityError(f"distinct groups {nuniq} > capacity "
                                f"{self.capacity}")
            err.needed = nuniq    # executors re-plan with 2x this
            raise err
        if bool(collided[0]):
            raise CollisionError("group key hash collision")
        live = (counts > 0) & (uniq != _SENTINEL_MASKED) & (uniq != _FILL)
        gidx = np.flatnonzero(live)
        lanes_at = [[l[gidx] for l in ls] for ls in lanes]
        return finalize_group_result(chunk, self.group_exprs, self.aggs,
                                     gidx, rep[gidx], lanes_at, counts[gidx])

    def __call__(self, chunk: Chunk, dev_cols=None) -> GroupResult:
        return self.finalize(chunk, self.dispatch(chunk, dev_cols=dev_cols))


class ScalarAggKernel:
    """No-group aggregation: one partial state row per chunk."""

    def __init__(self, filter_expr: Expression | None,
                 aggs: Sequence[AggDesc], device=None):
        self.device = runtime.resolve_device(device)
        self.filter_expr = filter_expr
        self.aggs = list(aggs)
        _validate_device_exprs(filter_expr, [], self.aggs)
        self.used = _columns_used(filter_expr, [], self.aggs)

    # lint: exempt[dtype-discipline] int64 COUNT lane: exact even past 2^53 rows, matches the agg-state stacking dtype
    def _kernel(self, cols, nrows):
        n = next(c for c in cols if c is not None)[0].shape[0]
        xp = tnp.on(self.device)
        mask = runtime.filter_mask_xp(xp, self.filter_expr, cols, n)
        mask = mask & (torch.arange(n, device=self.device) < nrows)
        inv = torch.zeros(n, dtype=torch.int32, device=self.device)
        b = _SegBatch(inv, 1)
        i_cnt = b.add(mask.to(torch.int64), "sum")
        assembles = [_agg_requests(xp, a, cols, n, mask, b)
                     for a in self.aggs]
        b.run()
        lanes = [[l for l, _op in assemble(b.get)] for assemble in assembles]
        return b.get(i_cnt), lanes

    def scratch_nbytes(self, chunk: Chunk) -> int:
        """See HashAggKernel.scratch_nbytes (one state row, no table)."""
        return 16 * len(self.aggs)

    def dispatch_nbytes(self, chunk: Chunk) -> int:
        """See HashAggKernel.dispatch_nbytes (one state row, no table)."""
        from tidb_tpu_torch import memtrack
        n = runtime.bucket_size(max(chunk.num_rows, 1))
        return memtrack.device_put_bytes(chunk, n) + \
            self.scratch_nbytes(chunk)

    def dispatch(self, chunk: Chunk, dev_cols=None):
        cols = dev_cols
        if cols is None:
            # a scalar agg that reads no column still needs the row count
            used = self.used or {0}
            cols, _ = runtime.device_put_chunk(chunk, self.device, used=used)
        return _pack(self._kernel(cols, chunk.num_rows))

    def finalize(self, chunk: Chunk, pending) -> GroupResult:
        count, lanes = _readback(pending)
        partials = []
        for a, ls in zip(self.aggs, lanes):
            if a.fn == AggFunc.FIRST_ROW:
                idx = ls[0]
                hasv = ls[1] > 0
                if hasv[0] and chunk.num_rows > 0:
                    d, _v = a.arg.eval(chunk.take(np.array([int(idx[0])])))
                    val = d[0]
                else:
                    val = 0
                ls = [np.array([val]), hasv.astype(np.int64)]
            partials.append(ls)
        return GroupResult(keys=[()], partials=partials, counts=count)

    def __call__(self, chunk: Chunk, dev_cols=None) -> GroupResult:
        return self.finalize(chunk, self.dispatch(chunk, dev_cols=dev_cols))


# -- process-wide kernel cache ----------------------------------------------

# keyed on (plan fingerprint, capacity, degrade flags, device): re-created
# plan objects for the same plan shape share one kernel object
_KERNELS = runtime.FingerprintCache(256)


def kernel_for(filter_expr, group_exprs, aggs, capacity: int = 4096,
               device=None):
    """HashAggKernel/ScalarAggKernel with process-wide reuse keyed on the
    structural plan fingerprint + capacity. Raises DeviceRejectError like
    the constructors when the exprs are not device-safe.

    Degrade-to-hash boundary (tidb_tpu_direct_agg_slots): a direct-mode
    group-by whose capacity escalation crosses the bound is rebuilt on
    the packed-sort hash path, so the direct-indexed table stays a
    fixed-size array; wide-span int keys clamp the runtime-selected
    direct branch the same way."""
    from tidb_tpu_torch import config
    device = runtime.resolve_device(device)
    direct_limit = config.direct_agg_slots()
    force_hash = bool(group_exprs) and capacity > direct_limit and \
        _direct_group_mode(group_exprs)

    from tidb_tpu_torch import devplane, profiler
    family = "hashagg" if group_exprs else "scalaragg"
    made = []

    def make():
        made.append(1)
        if group_exprs:
            return HashAggKernel(filter_expr, group_exprs, aggs,
                                 capacity=capacity, force_hash=force_hash,
                                 direct_limit=direct_limit, device=device)
        return ScalarAggKernel(filter_expr, aggs, device=device)

    fp = runtime.plan_fingerprint(filter_expr, group_exprs, aggs)
    if fp is None:
        k = make()
        prof = profiler.profile(family, None)
        profiler.note_construct(prof, reuse=False)
        k._profile = prof
        return k
    key = (fp, capacity if group_exprs else 0, force_hash,
           direct_limit if group_exprs else 0, str(device),
           devplane.mesh_fingerprint(process=True))
    k = _KERNELS.get_or_create(key, make)
    # profile rows key on the same identity as the cache slot; a cache
    # miss (`made` fired) is one construction
    prof = profiler.profile(family, f"{fp}|{key[1]}|{key[2]}|{key[3]}")
    profiler.note_construct(prof, reuse=not made)
    k._profile = prof
    return k


def _finalizer(agg):
    """cur (an aggregate's merged lanes) -> its final value: AVG
    finalized; SUM/AVG of decimals stay scaled ints."""
    fn = agg.fn
    if fn == AggFunc.COUNT:
        return lambda cur: int(cur[0])
    if fn in (AggFunc.SUM, AggFunc.MIN, AggFunc.MAX, AggFunc.FIRST_ROW,
              AggFunc.GROUP_CONCAT):
        # `not cur[1]` is `cur[1] == 0` for the has/count lane's ints and
        # floats, without building a numpy bool per group
        return lambda cur: None if not cur[1] else cur[0]
    if fn == AggFunc.AVG:
        if agg.result_ft.eval_type == EvalType.DECIMAL:
            extra = agg.result_ft.frac - agg.arg.ft.frac

            def avg(cur):
                if cur[1] == 0:
                    return None
                # scaled-int avg in EXACT integer arithmetic (half-up;
                # float division corrupts wide decimals)
                num = int(cur[0]) * (10 ** extra)
                den = int(cur[1])
                q, r = divmod(abs(num), den)
                if 2 * r >= den:
                    q += 1
                return q if num >= 0 else -q
            return avg
        return lambda cur: None if cur[1] == 0 else \
            float(cur[0]) / float(cur[1])

    def unknown(cur):
        raise NotImplementedError(fn)
    return unknown


class HashAggregator:
    """Stateful final aggregator: merges chunk partials on the host and
    finalizes per-group values (the reference's partial/final split)."""

    def __init__(self, aggs: Sequence[AggDesc], group_meta=None):
        """group_meta: the group-key expressions OR FieldTypes, in key
        order (anything with an .ft, or an ft itself)."""
        self.aggs = list(aggs)
        self._state: dict[tuple, list] = {}
        self._orig: dict[tuple, tuple] = {}
        self._ci = [getattr(g, "ft", g).is_ci for g in group_meta] \
            if group_meta else None
        self._any_ci = bool(self._ci) and any(self._ci)

    def approx_bytes(self) -> int:
        """Rough host footprint of the merged state (dict slots, key
        tuples and per-agg lane scalars at CPython object costs): the
        number memtrack bounds under tidb_tpu_mem_quota_query. It scales
        with the live group count, not the input."""
        n = len(self._state)
        if n == 0:
            return 0
        st = next(iter(self._state.values()))
        lanes = sum(len(ls) for ls in st)
        key = next(iter(self._orig.values()))
        return n * (96 + 56 * len(key) + 48 * lanes)

    def _group_key(self, key: tuple) -> tuple:
        if not self._any_ci:
            return key
        from tidb_tpu_torch.sqltypes import collation_key
        return tuple(collation_key(x) if c and x is not None else x
                     for x, c in zip(key, self._ci))

    def update(self, res: GroupResult) -> None:
        keys = res.keys
        gkeys = [self._group_key(k) for k in keys] if self._any_ci \
            else keys
        # each lane as a list of its elements (the same scalars indexing
        # gives, without a per-element array index)
        cols = [[list(lane) for lane in ls] for ls in res.partials]
        state, orig = self._state, self._orig
        fns = list(enumerate(a.fn for a in self.aggs))
        for gi, gkey in enumerate(gkeys):
            st = state.get(gkey)
            if st is None:
                state[gkey] = [[lane[gi] for lane in c] for c in cols]
                orig[gkey] = keys[gi]
                continue
            for ai, fn in fns:
                lanes = cols[ai]
                cur = st[ai]
                if fn == AggFunc.SUM:
                    cur[0] += lanes[0][gi]
                    has = lanes[1][gi]
                    if has > cur[1]:        # max(cur[1], has)
                        cur[1] = has
                elif fn == AggFunc.COUNT:
                    cur[0] += lanes[0][gi]
                elif fn == AggFunc.AVG:
                    cur[0] += lanes[0][gi]
                    cur[1] = cur[1] + lanes[1][gi]
                elif fn == AggFunc.MIN:
                    if lanes[1][gi] > 0:
                        cur[0] = min(cur[0], lanes[0][gi]) if cur[1] > 0 \
                            else lanes[0][gi]
                        cur[1] = 1
                elif fn == AggFunc.MAX:
                    if lanes[1][gi] > 0:
                        cur[0] = max(cur[0], lanes[0][gi]) if cur[1] > 0 \
                            else lanes[0][gi]
                        cur[1] = 1
                elif fn == AggFunc.FIRST_ROW:
                    if cur[1] == 0 and lanes[1][gi] > 0:
                        cur[0], cur[1] = lanes[0][gi], 1
                elif fn == AggFunc.GROUP_CONCAT:
                    if lanes[1][gi] > 0:
                        if cur[1] > 0:
                            cur[0] = cur[0] + self.aggs[ai].sep + \
                                lanes[0][gi]
                        else:
                            cur[0], cur[1] = lanes[0][gi], 1

    def results(self) -> list[tuple[tuple, list]]:
        """-> [(key, [final agg values])] with AVG finalized; SUM/AVG of
        decimals stay scaled ints (callers format via the agg result_ft)."""
        out = []
        items = self._state.items()
        if any(None in k for k in self._state):
            items = sorted(items, key=lambda kv: tuple(
                (x is None, x) for x in kv[0]))
        else:
            # no NULL key: (False, x) tuples order as the keys do
            items = sorted(items, key=lambda kv: kv[0])
        finals = [_finalizer(agg) for agg in self.aggs]
        orig = self._orig
        for key, st in items:
            out.append((orig.get(key, key),
                        [f(cur) for f, cur in zip(finals, st)]))
        return out
