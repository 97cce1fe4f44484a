"""Device runtime helpers: padding, transfer, the dispatch-ahead pipeline,
plan fingerprints.

Chunks are padded to bucketed sizes (powers of two), and padding rows
carry valid=False so every kernel treats them as NULLs that match no
filter and join no group. Transfers pack one superchunk's columns into a
single pinned host buffer and copy it with one non-blocking copy, so the
host prepares superchunk k+1 while the device still runs superchunk k:
the CUDA stream's order is the dispatch-ahead queue, and the only sync
is the readback in a kernel's finalize.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque

import numpy as np
import torch

from tidb_tpu_torch.chunk import Chunk, dict_encode
from tidb_tpu_torch.expression import Expression

__all__ = ["bucket_size", "pad_column", "put_lanes", "device_put_chunk",
           "resolve_device", "eval_filter_host", "filter_mask_xp",
           "shard_put",
           "note_put", "put_bytes",
           "MIN_BUCKET", "Superchunk", "superchunk_batches",
           "pipeline_map", "FingerprintCache", "plan_fingerprint"]

MIN_BUCKET = 1024

# host->device bytes staged by put_lanes and the device cache's patch
# copies, process-wide (read around a run to see what it moved)
_put_mu = threading.Lock()
_put_bytes = [0]


def note_put(nbytes: int) -> None:
    with _put_mu:
        _put_bytes[0] += nbytes


def put_bytes() -> int:
    """Host->device bytes staged so far in this process."""
    with _put_mu:
        return _put_bytes[0]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Never falls back to the CPU by itself."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run on the host")
    return device


class Superchunk:
    """One coalesced batch: a chunk re-assembled from `sources` storage
    chunks, destined for a single padded-bucket device dispatch.
    `sources` counts the chunks that contributed rows to this batch (a
    chunk spanning a coalesce boundary counts in each superchunk it
    touches). The fill ratio (rows over the padded bucket) is the share
    of device work spent on live rows, which EXPLAIN ANALYZE shows."""

    __slots__ = ("chunk", "sources")

    def __init__(self, chunk: Chunk, sources: int):
        self.chunk = chunk
        self.sources = sources

    @property
    def num_rows(self) -> int:
        return self.chunk.num_rows

    @property
    def bucket(self) -> int:
        return bucket_size(self.chunk.num_rows)

    @property
    def fill(self) -> float:
        return self.chunk.num_rows / self.bucket


def superchunk_batches(chunks, limit: int, tracker=None):
    """Coalesce a chunk stream into ~limit-row Superchunks: device
    dispatches stay large while host memory stays O(limit). Oversize
    chunks are sliced; 0-row chunks fold away. A chunk that is exactly
    one superchunk passes through as the same object (`Superchunk.chunk`),
    so its device memo (device_put_chunk) serves the next run over it.

    `tracker` (a memtrack.MemTracker) accounts the assembly buffer: bytes
    are held while chunks wait in it and credited back when the
    superchunk is yielded (ownership passes to the consumer)."""
    from tidb_tpu_torch import memtrack
    limit = max(int(limit), 1)    # a 0/negative sysvar must not hang
    buf, total, srcs, staged = [], 0, 0, 0

    def emit():
        nonlocal staged
        big = Chunk.concat_all(buf)
        if tracker is not None and staged:
            tracker.release(host=staged)
            staged = 0
        return Superchunk(big, srcs) if big is not None else None

    try:
        for c in chunks:
            if c.num_rows == 0:
                continue
            srcs += 1
            start = 0
            while start < c.num_rows:
                take = min(c.num_rows - start, limit - total)
                piece = c if (start == 0 and take == c.num_rows) \
                    else c.slice(start, start + take)
                buf.append(piece)
                if tracker is not None:
                    b = memtrack.chunk_bytes(piece)
                    tracker.consume(host=b)
                    staged += b
                total += take
                start += take
                if total >= limit:
                    sc = emit()
                    if sc is not None:
                        yield sc
                    buf, total, srcs = [], 0, \
                        1 if start < c.num_rows else 0
        if buf:
            sc = emit()
            if sc is not None:
                yield sc
    finally:
        # abandoned or raised mid-assembly: what still sits in the
        # buffer was never handed to a consumer
        if tracker is not None and staged:
            tracker.release(host=staged)


def pipeline_map(items, dispatch, finalize, depth: int, tracker=None,
                 cost=None, profile=None):
    """Depth-N dispatch-ahead map over an item stream: up to `depth`
    dispatched items are in flight before the oldest is finalized, so
    item k+1's host-side prep (padding, packing, the non-blocking copy)
    and its kernel launches queue behind item k's device work. Results
    come back in item order.

    dispatch(item) -> token must only ENQUEUE work. finalize(item, token)
    is the one blocking point (the readback at the operator output
    boundary). A consumer that stops early still finalizes every
    dispatched token, so no device work is left unread.

    With `tracker` and `cost` set, each in-flight item holds cost(item)
    host bytes on the tracker from its dispatch until its finalize
    returns: the depth-N window is the memory the pipeline pins.

    `depth` is this STATEMENT's window; the server-wide window belongs
    to the device scheduler (sched.py): every dispatch takes a global
    slot first, held until its finalize returns, granted round-robin
    across concurrent statements. Under contention the pipeline drains
    its own oldest in-flight token before asking again, and past the
    scheduler's bypass valve the dispatch proceeds unscheduled, so the
    global window can throttle but never hang a statement. Each finalize
    runs under the dispatch watchdog; the enqueue and the readback bill
    the tenant meter as device (or host-fallback) time; a device fault
    at dispatch feeds the device-health tracker and propagates.

    With `profile` set (a profiler.KernelProfile), each device token's
    enqueue interval records as one dispatch and its blocking readback
    as busy-ns on that profile row."""
    import time as _time

    from tidb_tpu_torch import memtrack, meter, profiler, sched, trace
    from tidb_tpu_torch.util import failpoint
    scheduler = sched.device_scheduler()
    depth = max(int(depth), 1)
    pending: deque = deque()
    track = tracker is not None and cost is not None

    def _token_kind(tok) -> str:
        # host-path items: None (the common convention) or an explicit
        # ("host", ...) token — everything else enqueued device work
        if tok is None or (isinstance(tok, tuple) and tok and
                           isinstance(tok[0], str) and tok[0] == "host"):
            return "host"
        return "device"

    def pop_finalize():
        prev, seq, tok, held, slot = pending.popleft()
        kind = _token_kind(tok)
        try:
            # the watchdog bounds the blocking readback: past
            # tidb_tpu_dispatch_timeout_ms the statement cancels with
            # the retryable device-fault error, and the finally below
            # drains the slot and the staged bytes as on any error
            with sched.finalize_watch("pipeline-finalize"):
                failpoint.eval("device/finalize")
                with meter.busy_section(kind), \
                        trace.span("finalize", superchunk=seq,
                                   host=int(kind == "host")):
                    t0p = _time.perf_counter_ns()
                    out = finalize(prev, tok)
                    if profile is not None and kind == "device":
                        profiler.note_busy(
                            profile, _time.perf_counter_ns() - t0p)
                    return out
        finally:
            scheduler.release(slot)
            if held:
                tracker.release(host=held)

    def acquire_slot(bypass: bool):
        # the global round-robin slot wait, traced per attempt and billed
        # to the tenant's slot-wait ledger
        t0 = _time.perf_counter_ns()
        try:
            with trace.span("sched.slot"):
                return scheduler.acquire_or_bypass() if bypass \
                    else scheduler.acquire()
        finally:
            meter.note_slot_wait(_time.perf_counter_ns() - t0)

    seq = -1
    try:
        for it in items:
            seq += 1
            # a killed statement stops before its next dispatch (the
            # pipeline may run on a coprocessor pool worker)
            memtrack.check_interrupted()
            while len(pending) >= depth:
                yield pop_finalize()
            slot = acquire_slot(False)
            while slot is None and pending:
                yield pop_finalize()
                slot = acquire_slot(False)
            if slot is None:
                slot = acquire_slot(True)
            held = cost(it) if track else 0
            if held:
                tracker.consume(host=held)
            try:
                failpoint.eval("device/dispatch")
                # the enqueue interval meters as device time for device
                # tokens, host-fallback time for host-path items — the
                # kind is only known once dispatch() returns
                busy = meter.busy_section()
                t0p = _time.perf_counter_ns()
                with busy, trace.span("dispatch", superchunk=seq):
                    tok = dispatch(it)
                    busy.kind = _token_kind(tok)
                if profile is not None and busy.kind == "device":
                    profiler.note_dispatch(
                        profile, _time.perf_counter_ns() - t0p)
            except BaseException as e:
                # executor-plane device faults feed the same health
                # tracker as the coprocessor's sites; the fault itself
                # propagates (the retry/degrade chain lives there)
                if isinstance(e, failpoint.DeviceFaultError) and not \
                        isinstance(e, failpoint.DispatchTimeoutError):
                    sched.device_health().note_fault()
                scheduler.release(slot)
                if held:
                    tracker.release(host=held)
                raise
            if tok is None:
                # host-path item: nothing went to the device — hand the
                # slot back now instead of across its (host) finalize
                scheduler.release(slot)
                slot = None
            pending.append((it, seq, tok, held, slot))
        while pending:
            yield pop_finalize()
    finally:
        # a consumer that stops early abandons dispatched tokens: each is
        # finalized (result discarded) so its slot, its held host bytes
        # and the device bytes its dispatch charged are released
        while pending:
            prev, _seq, tok, held, slot = pending.popleft()
            try:
                with meter.busy_section(_token_kind(tok)):
                    finalize(prev, tok)
            except Exception:
                pass    # abandoned: the result is discarded either way
            finally:
                scheduler.release(slot)
                if held:
                    tracker.release(host=held)


def bucket_size(n: int) -> int:
    """Next power of two >= n (min MIN_BUCKET): the static shape bucket."""
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return b


# lint: exempt[memtrack-alloc] callers bill padded superchunk staging at dispatch (superchunk_batches tracker)
def pad_column(data: np.ndarray, valid: np.ndarray, size: int):
    n = len(data)
    if n == size:
        return data, valid
    pd = np.zeros(size, dtype=data.dtype)
    pd[:n] = data
    pv = np.zeros(size, dtype=bool)
    pv[:n] = valid
    return pd, pv


def _host_lanes(chunk: Chunk, used):
    """-> ({j: (data, valid)} numpy lanes for the columns in `used`,
    dicts): varlen columns ship as their int64 dictionary codes."""
    lanes, dicts = {}, {}
    for j, c in enumerate(chunk.columns):
        if used is not None and j not in used:
            continue
        if c.fixed_width:
            data, valid = c.data, c.valid
        else:
            codes, values = dict_encode(c)
            dicts[j] = values
            data, valid = codes, c.valid & (codes >= 0)
        lanes[j] = (np.ascontiguousarray(data), np.asarray(valid))
    return lanes, dicts


def put_lanes(lanes, n: int, size: int, device) -> list:
    """[(data, valid)] numpy lanes of `n` rows -> the same lanes as tensors
    on `device`, padded to `size` rows (padding is 0 / invalid). On CUDA
    the lanes are packed into ONE pinned host buffer (data lanes first,
    8-byte aligned, then the validity bytes) and copied with one
    non-blocking copy; the device views slice that one buffer."""
    device = resolve_device(device)
    dtypes = [np.asarray(d).dtype for d, _v in lanes]
    for i, dt in enumerate(dtypes):
        if dt.itemsize != 8:
            raise TypeError(f"lane {i}: {dt} is not an 8-byte lane")
    k = len(lanes)
    data_bytes = 8 * size * k
    host = torch.empty(data_bytes + size * k, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    # lint: exempt[device-sync] `host` is the pinned HOST staging buffer: .numpy() views its bytes, no device copy
    hb = host.numpy()
    for i, (d, v) in enumerate(lanes):
        dv = hb[8 * size * i:8 * size * (i + 1)].view(dtypes[i])
        dv[:n] = d[:n]
        dv[n:] = 0
        vv = hb[data_bytes + size * i:data_bytes + size * (i + 1)].view(bool)
        vv[:n] = v[:n]
        vv[n:] = False
    buf = host.to(device, non_blocking=True) if device.type == "cuda" \
        else host
    note_put(host.numel())
    out = []
    for i, dt in enumerate(dtypes):
        tdt = torch.int64 if dt == np.int64 else torch.float64
        out.append((buf[8 * size * i:8 * size * (i + 1)].view(tdt),
                    buf[data_bytes + size * i:
                        data_bytes + size * (i + 1)].view(torch.bool)))
    return out


def device_put_chunk(chunk: Chunk, device=None, size: int | None = None,
                     memo: bool = True, used=None, to_device: bool = True):
    """-> (cols, dicts): cols[j] is (data, valid) tensors on `device`,
    padded to a bucketed size, for every column j in `used` (None for the
    others; used=None ships every column); varlen columns are
    dict-encoded and their dictionaries returned in `dicts[j]`. The lanes
    travel in one pinned buffer and one copy (`put_lanes`).

    With to_device=False the lanes stay numpy (unpadded, contiguous) so
    the caller can shard them over the plane itself (`shard_put`: one
    transfer per shard, no copy to a single device first).

    The transfer is memoized on the chunk (keyed by device, padded size and
    column set): a chunk presented again keeps its columns resident and
    pays zero host->device bytes. Callers must treat chunks as
    immutable. memo=False skips the memo."""
    if not to_device:
        lanes, dicts = _host_lanes(chunk, used)
        return [lanes.get(j) for j in range(len(chunk.columns))], dicts
    device = resolve_device(device)
    size = size or bucket_size(chunk.num_rows)
    used_key = None if used is None else tuple(sorted(used))
    key = (str(device), size, used_key)
    if memo:
        hit = dev_cache_get(chunk, key)
        if hit is not None:
            return hit
    lanes, dicts = _host_lanes(chunk, used)
    order = sorted(lanes)
    cols: list = [None] * len(chunk.columns)
    for j, lane in zip(order, put_lanes([lanes[j] for j in order],
                                        chunk.num_rows, size, device)):
        cols[j] = lane
    out = (cols, dicts)
    if memo:
        dev_cache_put(chunk, key, out)
    return out


def shard_put(lanes, n: int, ln: int, mesh) -> list:
    """Numpy lanes of `n` rows (device_put_chunk's to_device=False form,
    None for unshipped columns) -> per-shard column lists for a
    ``("batch",)`` plane: shard i holds rows [i*ln, (i+1)*ln) on its
    device, padded to `ln` (padding invalid), each shard's lanes in one
    pinned buffer and one copy (`put_lanes`)."""
    order = [j for j, lane in enumerate(lanes) if lane is not None]
    shards = []
    for i, dev in enumerate(mesh.devices.flat):
        lo = min(i * ln, n)
        hi = min(lo + ln, n)
        part = [(d[lo:hi], v[lo:hi]) for d, v in
                (lanes[j] for j in order)]
        cols: list = [None] * len(lanes)
        if order:
            for j, lane in zip(order, put_lanes(part, hi - lo, ln, dev)):
                cols[j] = lane
        shards.append(cols)
    return shards


# a chunk may be consumed under two column sets (or devices), or by a
# plane path (the ('shard', generation, size, used) key); a tiny
# per-chunk LRU lets both memos coexist instead of evicting each other
_DEV_CACHE_SLOTS = 2


def dev_cache_get(chunk, key):
    cache = getattr(chunk, "_dev_cache", None)
    if isinstance(cache, OrderedDict):
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
        return hit
    return None


def dev_cache_put(chunk, key, value) -> None:
    cache = getattr(chunk, "_dev_cache", None)
    if not isinstance(cache, OrderedDict):
        cache = OrderedDict()
        chunk._dev_cache = cache
    while len(cache) >= _DEV_CACHE_SLOTS:
        cache.popitem(last=False)
    cache[key] = value


def eval_filter_host(expr: Expression | None, chunk: Chunk) -> np.ndarray:
    """Host-path filter: bool mask over rows (NULL -> False).
    Mirror of the device mask used inside kernels."""
    if expr is None:
        return np.ones(chunk.num_rows, dtype=bool)
    d, v = expr.eval(chunk)
    return v & (d != 0)


def filter_mask_xp(xp, expr: Expression | None, cols, n):
    """Device-path filter mask."""
    if expr is None:
        return xp.ones(n, dtype=bool)
    d, v = expr.eval_xp(xp, cols, n)
    return v & (d != 0)


# -- plan fingerprints (kernel-cache keys) ----------------------------------


class FingerprintCache:
    """Thread-safe LRU keyed by plan fingerprint: a hit refreshes the
    entry; the factory runs outside the lock and a racing duplicate is
    discarded in favor of the first insert."""

    def __init__(self, capacity: int = 64):
        self._cap = capacity
        self._d: OrderedDict = OrderedDict()
        self._mu = threading.Lock()

    def get_or_create(self, key, factory):
        with self._mu:
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
                return hit
        obj = factory()
        with self._mu:
            cur = self._d.setdefault(key, obj)
            self._d.move_to_end(key)
            while len(self._d) > self._cap:
                old = next(iter(self._d))
                if old == key:      # never evict the entry just touched
                    break
                self._d.pop(old)
            return cur


class _Unfingerprintable(Exception):
    """Expression tree contains a node whose device behavior cannot be
    captured structurally."""


def _ft_fp(ft) -> str:
    if ft is None:
        return "?"
    return (f"{ft.tp}:{getattr(ft, 'flen', 0)}:{getattr(ft, 'frac', 0)}:"
            f"{int(bool(getattr(ft, 'is_ci', False)))}:"
            f"{int(bool(getattr(ft, 'is_wide_decimal', False)))}")


def _extra_fp(extra) -> str:
    """ScalarFunc.extra carries eval-relevant payload (IN value lists,
    LIKE patterns, cast target types) that MUST distinguish kernels."""
    if extra is None:
        return ""
    if hasattr(extra, "tp"):          # a FieldType (cast target)
        return _ft_fp(extra)
    if isinstance(extra, (list, tuple)):
        return repr([repr(x) for x in extra])
    if isinstance(extra, (str, bytes, int, float, bool)):
        return repr(extra)
    raise _Unfingerprintable(type(extra).__name__)


def _expr_fp(e) -> str:
    from tidb_tpu_torch.expression.core import ColumnRef, Constant, ScalarFunc
    if e is None:
        return "~"
    ft = _ft_fp(getattr(e, "ft", None))
    if isinstance(e, ColumnRef):
        return f"c{e.idx}|{ft}"
    if isinstance(e, Constant):
        return f"k{e.value!r}|{ft}"
    if isinstance(e, ScalarFunc):
        args = ",".join(_expr_fp(a) for a in e.args)
        return f"f{e.op.value}({args})|x{_extra_fp(e.extra)}|{ft}"
    raise _Unfingerprintable(type(e).__name__)


def plan_fingerprint(filter_expr, group_exprs, aggs) -> str | None:
    """Structural identity of a pushed (filter, group-by, agg) subplan —
    the process-wide kernel-cache key; the same string as the JAX
    package's for the same plan. None when any node falls outside the
    structural vocabulary (the caller then builds an uncached kernel)."""
    try:
        parts = [_expr_fp(filter_expr),
                 ";".join(_expr_fp(g) for g in group_exprs)]
        for a in aggs:
            parts.append(f"{a.fn.value}|{int(bool(a.distinct))}|"
                         f"{_expr_fp(a.arg)}|{a.sep!r}")
        return "#".join(parts)
    except _Unfingerprintable:
        return None
