"""Streaming coprocessor: bounded-memory framed partial responses.

The port's copy of the JAX package's store/stream.py: the in-process
half (the storage-side producer and the client's credit-window queue).
The out-of-process wire path it mentions (store/wire.py, remote.py) is
not ported yet.

Reference: the CmdCopStream mode of TiDB's store/tikv/
coprocessor.go:547-555 (handleCopStreamResult: incremental per-range
responses, stream re-created from the last returned range on region
errors) and mocktikv/cop_handler_dag.go's chunked DAG execution. The
materialized path (store/copr.py cop_handler) returns one response list
per region — a large region costs unbounded memory on both sides. This
module is the storage half of the streaming path:

  * `region_stream` executes the pushed-down scan/selection/partial-agg
    PER FRAME: raw KV rows accumulate until the response-size cap
    (tidb_tpu_copr_stream_frame_bytes), then decode + execute + yield one
    `StreamFrame`. An aggregating subplan yields per-frame PARTIAL
    aggregates the client merges incrementally (the "partial partial
    aggregates" shape — see PAPERS.md).
  * Every frame carries the contiguous key range it covers; frame i+1
    starts exactly where frame i ended, so a consumer that acked frame i
    can resume a dead stream at `frame.range.end` with no duplicate or
    missing row (store/copr.py `_run_task_stream`).
  * The final frame has `last=True` and `range.end` = the region-clamped
    scan end, telling the client where this region's coverage stops (the
    cursor for crossing into the next region).

Flow control lives one layer up: in-process consumption pulls the
generator lazily (perfect backpressure); the parallel fan-out buffers
frames in a `BoundedFrameQueue` sized to the credit window; the
out-of-process wire path uses the credit protocol of store/wire.py
(client grants N outstanding frames, the server blocks past the window
— store/remote.py).

Cache integration (the reason tidb_tpu_copr_stream can default on): a
stream over a cache-eligible range (no LIMIT, chunk cache enabled)
consults the SAME columnar cache hierarchy as the materialized handler
(store/copr.exec_cached_cop). A resident range serves as ONE final
frame straight from the decoded (and, for fused agg plans, the
HBM-device-resident) block — resume-safe, since nothing is acked until
that frame lands and a re-issue re-reads the same block. A COLD stream
keeps the bounded frame-by-frame contract for the client, and
additionally captures its decoded batches to fill the chunk cache at
stream end, so the next read — streamed or materialized — is hot.
Over-budget accumulations abort the fill: scans too large for a cache
entry stream exactly as before.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field

from tidb_tpu_torch import config, metrics
from tidb_tpu_torch.kv import CopRequest, KVRange
from tidb_tpu_torch.util import failpoint

__all__ = ["StreamFrame", "region_stream", "cop_stream_handler",
           "BoundedFrameQueue", "stream_stats", "reset_stream_stats"]

# rows per engine-scan call while filling a frame; small enough that a
# frame overshoots its byte cap by at most one row, large enough to
# amortize the engine's lock
SCAN_SUB_BATCH = 1024


@dataclass
class StreamFrame:
    """One framed partial response (wire struct id 25, store/wire.py).

    `chunk` is the pushed subplan's result over exactly the raw rows in
    `range` (None when the frame only advances coverage); `range` is the
    contiguous scanned span — the resume boundary, NOT the result rows'
    keys (a filter may have dropped every row in it)."""

    chunk: object | None
    range: KVRange
    last: bool = False


# -- observability -----------------------------------------------------------

_stats_lock = threading.Lock()


def _fresh_stats() -> dict:
    return {"streams": 0, "frames": 0, "bytes": 0, "frame_bytes_max": 0,
            "credit_stalls": 0, "resumes": 0, "peak_buffered": 0}


_STATS = _fresh_stats()         # guarded-by: _stats_lock


def reset_stream_stats() -> None:
    with _stats_lock:
        _STATS.clear()
        _STATS.update(_fresh_stats())


def stream_stats() -> dict:
    with _stats_lock:
        return dict(_STATS)


def _note(key: str, inc: int = 1) -> None:
    with _stats_lock:
        _STATS[key] += inc


def _note_max(key: str, value: int) -> None:
    with _stats_lock:
        if value > _STATS[key]:
            _STATS[key] = value


def note_resume() -> None:
    """A client re-issued a stream from its last acked boundary."""
    _note("resumes")
    metrics.counter(metrics.COP_STREAM_RESUMES)


def note_credit_stall() -> None:
    """A producer blocked on an exhausted credit window (backpressure
    engaged — the bound worked, this is not an error)."""
    _note("credit_stalls")
    metrics.counter(metrics.COP_STREAM_CREDIT_STALLS)


# -- storage side ------------------------------------------------------------

# Over-cap memo: result sizes of cached frames _cached_frame REFUSED
# (result > client frame cap). The refusal itself costs a full fused
# dispatch whose result is thrown away — remembering the size lets the
# next warm stream over the same (cache key, data version) skip
# straight to the framed raw scan. The data version in the key
# invalidates naturally on write/DDL; stale tuples age out by LRU.
_OVERCAP_CAP = 256
_overcap_lock = threading.Lock()
# (cache key, dv) -> result bytes
_overcap: OrderedDict = OrderedDict()   # guarded-by: _overcap_lock


def _overcap_get(key, dv) -> int | None:
    with _overcap_lock:
        n = _overcap.get((key, dv))
        if n is not None:
            _overcap.move_to_end((key, dv))
        return n


def _overcap_put(key, dv, nbytes: int) -> None:
    with _overcap_lock:
        _overcap[(key, dv)] = nbytes
        _overcap.move_to_end((key, dv))
        while len(_overcap) > _OVERCAP_CAP:
            _overcap.popitem(last=False)


def _cached_frame(storage, region, req: CopRequest, plan, s: bytes,
                  e: bytes, frame_bytes: int, key, dv) -> \
        StreamFrame | None:
    """Serve one region's stream from the columnar cache hierarchy: the
    shared cached-path executor (filter memo, fused HBM agg dispatch)
    runs once and its response ships as ONE final frame covering the
    whole clamped range. Returns None — the caller streams framed from
    the raw scan instead — when the RESULT would bust the client's
    frame cap: agg partials are usually tiny, but a high-cardinality
    GROUP BY partial approaches the block size, and shipping it as one
    unbounded frame would break the streamed constant-client-memory
    contract. Resume-safe: a consumer that dies mid-frame acked
    nothing, and the re-issued stream re-reads the same resident
    block."""
    from tidb_tpu_torch import memtrack
    from tidb_tpu_torch.store.copr import exec_cached_cop

    responses = exec_cached_cop(storage, region, plan, s, e, req)
    chunk = responses[0].chunk if responses else None
    # agg partials ship as GroupResult, not Chunk — result_bytes sizes
    # both, so a high-cardinality partial cannot dodge the cap check
    nbytes = memtrack.result_bytes(chunk) if chunk is not None else 0
    if nbytes > frame_bytes:
        _overcap_put(key, dv, nbytes)
        return None
    _note("frames")
    _note("bytes", nbytes)
    _note_max("frame_bytes_max", nbytes)
    metrics.counter(metrics.COP_STREAM_FRAMES)
    metrics.counter(metrics.COP_STREAM_BYTES, inc=nbytes)
    return StreamFrame(chunk, KVRange(s, e), last=True)


def region_stream(storage, region, req: CopRequest, frame_bytes: int):
    """Yield StreamFrames for one region's share of `req`.

    Raw (key, value) rows accumulate until the next row would push the
    frame past `frame_bytes`; the pushed subplan then runs over exactly
    that batch. A single row larger than the cap still ships alone — the
    cap bounds buffering, it cannot split a row. Cache-eligible ranges
    consult and fill the columnar caches (module docstring)."""
    from tidb_tpu_torch.store.copr import (clamp_range, decode_cop_batch,
                                           exec_cop_plan, use_cached_path)

    plan = req.plan
    # ONE clamp shared with the materialized handler: cache keys embed
    # (s, e), so both surfaces must clamp identically to share entries
    s, e = clamp_range(region, req.ranges[0])
    _note("streams")

    fill_key = fill_dv = None
    fill_parts: list | None = None
    fill_handles: list | None = None
    fill_bytes = fill_billed = 0
    resident = None
    if use_cached_path(storage, plan):
        from tidb_tpu_torch.store.chunk_cache import ChunkCache
        cache = storage.chunk_cache
        key = ChunkCache.key(region, plan, s, e)
        dv = storage.engine.data_version
        resident = cache.peek(key, dv, req.start_ts)
        known = _overcap_get(key, dv)
        if resident is not None and (plan.is_agg or
                                     resident <= frame_bytes) and \
                (known is None or known <= frame_bytes):
            # hot range whose response respects the client's frame cap
            # (agg partials are usually tiny; a raw block only
            # qualifies when it fits one frame): serve straight from
            # residency. peek, so the real lookup inside
            # exec_cached_cop does the hit counting exactly once. A
            # bigger raw block — or an agg partial that turns out to
            # bust the cap (None below, size memoized so the next warm
            # stream skips the wasted dispatch) — streams framed from
            # the raw scan instead: one frame per range is the resume
            # unit, so a resident block can never be split across
            # frames.
            frame = _cached_frame(storage, region, req, plan, s, e,
                                  frame_bytes, key, dv)
            if frame is not None:
                yield frame
                return
        # cold: stream frames exactly as before (the client's memory
        # bound), capturing decoded batches for an end-of-stream fill
        # under the same MVCC conditions as the materialized filler
        # (store/copr._cached_range_chunk). Already-resident ranges
        # (over-cap raw blocks) skip the re-capture.
        if resident is None and not storage.engine._locked_keys and \
                req.start_ts >= storage.engine.max_commit_ts:
            fill_key, fill_dv, fill_parts = key, dv, []
            from tidb_tpu_torch.store.copr import _delta_store_of
            if _delta_store_of(storage) is not None and \
                    plan.index is None:
                # capture row handles alongside: stream-filled entries
                # then patch forward as base⋈delta (store/delta.py)
                # exactly like materialized fills
                fill_handles = []

    remaining = plan.limit if not plan.is_agg else None
    pend: list[tuple[bytes, bytes]] = []
    pend_bytes = 0
    frame_start = s
    cur = s
    done = False

    def emit(boundary: bytes, last: bool) -> StreamFrame:
        nonlocal pend, pend_bytes, frame_start, remaining, \
            fill_parts, fill_handles, fill_bytes, fill_billed
        # injectable frame fault BEFORE the frame materializes: an
        # un-emitted frame was never acked, so the client resume from
        # its last acked range boundary loses no rows (fires on both
        # the in-process shim path and the remote transport)
        failpoint.eval("copr/stream-frame", region.id)
        chunk = None
        if pend:
            dec = decode_cop_batch(plan, pend)
            if fill_handles is not None and fill_parts is not None:
                from tidb_tpu_torch.store.delta import record_handles
                fill_handles.append(record_handles(
                    [k for k, _v in pend]))
            if fill_parts is not None:
                from tidb_tpu_torch import memtrack
                part = memtrack.chunk_bytes(dec)
                # the capture is real statement memory until it is
                # handed to the cache: bill it, so quotas see a cold
                # cacheable stream exactly like the materialized read
                # path's whole-range buffering (a QuotaExceeded raised
                # here cancels the statement before the buffer grows).
                # fill_billed grows BEFORE consume: the charge lands on
                # the ledgers before the quota check raises, so the
                # finally below must release it too
                fill_billed += part
                memtrack.consume(plan, host=part)
                fill_parts.append(dec)
                fill_bytes += part
                if fill_bytes > storage.chunk_cache.max_bytes:
                    # outgrew the cache: this scan is exactly what
                    # streaming exists for — abort the fill (and give
                    # the dropped buffer back to the ledger now)
                    fill_parts = None
                    memtrack.release(plan, host=fill_billed)
                    fill_billed = 0
            resp = exec_cop_plan(plan, dec, device=storage.device)
            chunk = resp.chunk
            if remaining is not None:
                remaining -= chunk.num_rows
        frame = StreamFrame(chunk, KVRange(frame_start, boundary), last)
        nbytes = pend_bytes
        pend, pend_bytes, frame_start = [], 0, boundary
        _note("frames")
        _note("bytes", nbytes)
        _note_max("frame_bytes_max", nbytes)
        metrics.counter(metrics.COP_STREAM_FRAMES)
        metrics.counter(metrics.COP_STREAM_BYTES, inc=nbytes)
        return frame

    try:
        while not done:
            batch = storage.engine.scan(cur, e, SCAN_SUB_BATCH,
                                        req.start_ts, req.isolation,
                                        desc=False)
            if not batch:
                break
            for k, v in batch:
                row_bytes = len(k) + len(v) + 16   # ~ per-row overhead
                if pend and pend_bytes + row_bytes > frame_bytes:
                    yield emit(k, last=False)
                    if remaining is not None and remaining <= 0:
                        done = True
                        break
                pend.append((k, v))
                pend_bytes += row_bytes
            cur = batch[-1][0] + b"\x00"
            if not done and remaining is not None and pend:
                # a pushed-down LIMIT stops per scan sub-batch, like the
                # materialized handler — never buffer a whole byte-cap
                # frame of rows a LIMIT 7 will throw away
                yield emit(cur, last=False)
                if remaining <= 0:
                    done = True
            if len(batch) < SCAN_SUB_BATCH:
                break        # range exhausted: skip the empty re-probe
        yield emit(e, last=True)
        if fill_parts is not None:
            # the whole range streamed under fill-eligible conditions:
            # the next reader (streamed or materialized) is hot. An
            # abandoned generator never reaches here — no partial-range
            # fills.
            from tidb_tpu_torch.chunk import Chunk
            from tidb_tpu_torch.store.copr import decode_cop_batch as _dec
            whole = Chunk.concat_all(fill_parts) if fill_parts else None
            if whole is None:
                whole = _dec(plan, [])
            if fill_handles is not None:
                import numpy as _np
                whole._scan_handles = _np.concatenate(fill_handles) \
                    if fill_handles else _np.zeros(0, dtype=_np.int64)
            storage.chunk_cache.put(fill_key, fill_dv, req.start_ts,
                                    whole)
    finally:
        # capture handed to the cache (or dropped, or the generator
        # abandoned/cancelled mid-stream): it is no longer statement
        # memory either way
        if fill_billed:
            from tidb_tpu_torch import memtrack
            memtrack.release(plan, host=fill_billed)


def cop_stream_handler(storage):
    """Handler closure installed into the RPC shim (the streaming
    counterpart of store/copr.cop_handler): (region, req) -> generator
    of StreamFrames. The frame cap comes FROM THE CLIENT with each
    request (the session's sysvar — out of process, the server's own
    config must not override the client's memory bound); the server
    sysvar is only the fallback for callers that don't send one."""

    def handle(region, req: CopRequest, frame_bytes=None):
        return region_stream(storage, region, req,
                             frame_bytes or
                             config.copr_stream_frame_bytes())

    return handle


# -- client-side bounded buffering -------------------------------------------

class BoundedFrameQueue:
    """Credit-window buffer between producer threads and one consumer:
    the in-process analogue of the wire protocol's credit flow control.
    Capacity = credit window; a put past it blocks (counted as a credit
    stall — the producer is being backpressured, not buffered)."""

    _DONE = object()

    def __init__(self, credit: int, stop: threading.Event):
        import queue
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, credit))
        self._stop = stop
        self._queue_mod = queue

    def put(self, item) -> bool:
        """-> False when the consumer has gone away (stop producing)."""
        stalled = False
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                _note_max("peak_buffered", self._q.qsize())
                return True
            except self._queue_mod.Full:
                if not stalled:
                    stalled = True
                    note_credit_stall()
        return False

    def put_done(self) -> None:
        # sentinel bypasses the stall accounting but not the bound
        while not self._stop.is_set():
            try:
                self._q.put(self._DONE, timeout=0.05)
                return
            except self._queue_mod.Full:
                pass

    def drain(self, producers: int):
        """Yield items until `producers` DONE sentinels arrived.
        Exceptions put by producers re-raise in the consumer."""
        finished = 0
        while finished < producers:
            item = self._q.get()
            if item is self._DONE:
                finished += 1
            elif isinstance(item, BaseException):
                raise item
            else:
                yield item
