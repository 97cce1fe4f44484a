"""Coprocessor: pushed-subplan execution near the data + client fan-out.

The port's copy of the JAX package's store/copr.py (after the
reference's store/tikv/coprocessor.go client — buildCopTasks, the
worker pool, per-task retry — and mocktikv/cop_handler_dag.go on the
storage side). Storage-side compute is the port's operator library
(ops/): the partial aggregation runs as a device dispatch next to the
data, fused over an HBM-resident block when the device cache holds one
(store/device_cache.py), with the host numpy path as the fallback.

The control flow is the reference's: the encoded attempt for a string
filter, then the decoded retry; a capacity or collision miss goes to
ops/hybrid.agg_retry; every fallback counts under its reason. Each
dispatch runs under the device plane as in the reference: a scheduler
slot (sched.device_slot) with the dispatch watchdog, the chip scope
(devplane.chip_scope), the statement's device ledger, the runtime-stats
device section and the kernel-profile section (profiler.py). A device
fault retries once through the store Backoffer, then latches the
statement onto the host path (`fault`); three consecutive faults
quarantine the device (sched.DeviceHealth), and until its re-probe every
task is served on the host (`quarantine`). Host work bills the tenant
meter (meter.py), which rides into every pool and stream worker with
the sysvar overlay, the tracker and the stats collector. The kernels
run on the storage's device (`storage.device`). One deviation: a fault
that quarantines the device is not retried (the reference retries it,
and the retry re-fills the HBM block the quarantine just shed).
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tidb_tpu_torch import (config, devplane, kv, memtrack, meter,
                            profiler, runtime_stats, sched, trace)
from tidb_tpu_torch.kv import (CopRequest, CopResponse, KVRange,
                               NotLeaderError, RegionError, ServerBusyError,
                               KeyLockedError)
from tidb_tpu_torch.mockstore.cluster import Region
from tidb_tpu_torch.ops.hashagg import (CapacityError, CollisionError,
                                        DeviceRejectError)
from tidb_tpu_torch.ops.hostagg import host_hash_agg, host_scalar_agg
from tidb_tpu_torch.ops.runtime import bucket_size, eval_filter_host
from tidb_tpu_torch.plan.physical import CopPlan
from tidb_tpu_torch.store.backoff import (BO_REGION_MISS, BO_RPC,
                                          BO_SERVER_BUSY, BO_TXN_LOCK,
                                          BackoffExhausted, Backoffer,
                                          COP_MAX_BACKOFF)
from tidb_tpu_torch.table import index_kvrows_to_chunk, kvrows_to_chunk
from tidb_tpu_torch.util import failpoint
from tidb_tpu_torch.util.failpoint import DeviceFaultError

__all__ = ["CopClient", "cop_handler", "decode_cop_batch",
           "exec_cop_plan", "exec_cached_cop", "use_cached_path"]

# fan-out width lives in the tidb_tpu_cop_concurrency sysvar (config.py)

# storage-side scan batching; large batches amortize device dispatch
COP_SCAN_BATCH = 65536

_kernel_lock = threading.Lock()
_memo_lock = threading.Lock()


def _plan_filter_memoizable(plan: CopPlan) -> bool:
    """A filter result may be memoized only when its predicates hold no
    correlated cells — ApplyExec rebinds those per outer row while
    reusing the SAME plan object, so a memo would freeze row 1's answer.
    Computed once and cached on the plan."""
    cached = getattr(plan, "_filter_memoizable", None)
    if cached is not None:
        return cached
    from tidb_tpu_torch.expression.core import CorrelatedCol, ScalarFunc

    def correlated(e) -> bool:
        if e is None:
            return False
        if isinstance(e, CorrelatedCol):
            return True
        if isinstance(e, ScalarFunc):
            return any(correlated(a) for a in e.args)
        return False

    ok = not correlated(plan.filter) and not correlated(plan.host_filter)
    plan._filter_memoizable = ok
    return ok


def _agg_kernels(plan: CopPlan, device):
    """Kernel cached on the plan object per device (one kernel per
    pushed subplan, reused across regions and chunks), resolved through
    the process-wide fingerprint cache so a re-created plan reuses it."""
    from tidb_tpu_torch.ops.hashagg import kernel_for
    key = str(device)
    with _kernel_lock:
        ks = getattr(plan, "_kernels", None)
        if ks is None:
            ks = plan._kernels = {}
        k = ks.get(key)
        if k is None:
            k = ks[key] = kernel_for(plan.filter, plan.group_exprs or [],
                                     plan.aggs, device=device)
    return k


def decode_cop_batch(plan: CopPlan, batch):
    """Raw (key, value) rows -> decoded chunk for `plan` (row or index
    encoding). Shared by the materialized handler below and the framed
    producer in store/stream.py."""
    if plan.index is not None:
        return index_kvrows_to_chunk(plan.table, plan.index, plan.cols,
                                     batch, handle_col=plan.handle_col)
    return kvrows_to_chunk(plan.table, plan.cols, batch,
                           with_handle_col=plan.handle_col)


def _resolve_block(plan: CopPlan, chunk, dev_ref):
    """The HBM-resident DeviceBlock for this chunk, or None. Shared by
    the decoded and the encoded-filter dispatch paths."""
    if dev_ref is None or not config.fused_scan_enabled():
        return None
    dcache, dkey, dv, read_ts, fill_ts, pend_fn = dev_ref
    block = dcache.get_or_fill(dkey, dv, read_ts, chunk, fill_ts,
                               pend_fn=pend_fn)
    if block is not None and block.nrows == chunk.num_rows:
        return block
    return None


class _BlockOrder:
    """A host chunk seen in a patched block's row order. A kernel's
    finalize reads host rows by DEVICE position (each group's
    representative row, FIRST_ROW values); after a patch the block's
    positions no longer match the host chunk's handle order, so take()
    maps them through the block's position index."""

    def __init__(self, chunk, perm):
        self.chunk = chunk
        self.perm = perm

    @property
    def num_rows(self) -> int:
        return self.chunk.num_rows

    def take(self, idx):
        return self.chunk.take(self.perm[np.asarray(idx, dtype=np.int64)])


def _block_rows(chunk, block):
    """The host rows a dispatch over `block` finalizes against: `chunk`
    itself for a freshly filled block (same row order), a _BlockOrder
    view for a patched one, or None when the block's handles do not
    match the chunk's (the caller then uploads the chunk instead).

    The JAX package finalizes against the host chunk as it is, so after
    a patch a group whose representative row moved takes another row's
    key (a fault of the reference, listed in ROADMAP.md §C)."""
    if not block.patched:
        return chunk
    memo = block.host_rows
    if memo is not None and memo[0] is chunk:
        return memo[1]
    mh = getattr(chunk, "_scan_handles", None)
    dh = block.handles
    if mh is None or dh is None or len(mh) != len(dh):
        return None
    perm = np.searchsorted(mh, dh)
    if len(mh) and not np.array_equal(mh[np.minimum(perm, len(mh) - 1)],
                                      dh):
        return None
    rows = _BlockOrder(chunk, perm)
    block.host_rows = (chunk, rows)
    return rows


def _agg_mode(plan: CopPlan, k) -> str:
    """The encoding-mode note for a successful device agg dispatch —
    derived from the kernel ACTUALLY selected: one degraded past
    tidb_tpu_direct_agg_slots (force_hash) must not keep reporting
    direct-agg."""
    from tidb_tpu_torch.ops.hashagg import _direct_group_mode
    return "direct-agg" if plan.group_exprs and \
        not getattr(k, "force_hash", False) and \
        _direct_group_mode(plan.group_exprs) else "encoded"


class _PlanFallbacks:
    """The `stats` of ops/hybrid's retry chain: its per-partition host
    fallbacks count against the plan, as the reference's chain counts
    them (runtime_stats.note_fallback)."""

    def __init__(self, plan):
        self.plan = plan

    def note_fallback(self, reason: str) -> None:
        runtime_stats.note_fallback(self.plan, reason)


def _dispatch_finalize(plan, k, chunk, block, nbytes, moved, device):
    """One device dispatch and its readback — fused over `block`'s
    resident columns when one is given — under a scheduler slot and the
    dispatch watchdog, the chip scope, the statement's device ledger
    holding `nbytes` across both (the pool worker's tracker routes the
    charge to the issuing reader's node), the runtime-stats device
    section and the kernel-profile section (success-only, as in the
    reference: a capacity miss's wall must not bill the profile row the
    retry bills again)."""
    dev_cols = None
    decoded = memtrack.chunk_bytes(chunk)
    if block is not None:
        dev_cols = block.cols
        chunk = _block_rows(chunk, block)
    failpoint.eval("device/dispatch")
    with sched.device_slot() as slot, \
            devplane.chip_scope(slot.chip, device), \
            memtrack.device_scope(plan, nbytes), \
            runtime_stats.device_section(plan, errors=False,
                                         device=device), \
            profiler.dispatch_section(
                profiler.profile_of(k), nbytes=nbytes, encoded=moved,
                decoded=decoded, plan=plan):
        with trace.span("dispatch", rows=chunk.num_rows, chip=slot.chip):
            pending = k.dispatch(chunk, dev_cols=dev_cols)
        # the sync path's blocking readback seam: inside the
        # watchdog-guarded slot, so an armed delay here exercises the
        # timeout -> retryable-cancel path
        failpoint.eval("device/finalize")
        with trace.span("finalize"):
            return k.finalize(chunk, pending)


def _encoded_agg(plan: CopPlan, chunk, sources: int, dev_ref,
                 device) -> CopResponse | None:
    """Device partial agg with the host-only string filter translated
    into CODE space (ops/encoded.py): the chunk's dict columns are
    compared against pre-encoded constant codes inside the kernel, so
    the fused HBM dispatch stays available and the host never rewrites
    the chunk. Returns None to run the decoded path instead — counted
    as tidb_tpu_device_fallback_total{reason="encoding"} when the
    filter is not encodable (a capacity/collision miss returns None
    silently: the decoded retry owns that bookkeeping, and the encoded
    filter must never reach a host evaluator)."""
    from tidb_tpu_torch.expression.core import Op, func
    from tidb_tpu_torch.ops import encoded
    from tidb_tpu_torch.ops.hashagg import kernel_for
    # translatability gate BEFORE touching the device cache: an
    # untranslatable filter must not fill HBM with blocks this query
    # can never consume
    enc = encoded.translate_filter(plan.host_filter, chunk)
    if enc is None:
        runtime_stats.note_fallback(plan, "encoding")
        return None
    block = _resolve_block(plan, chunk, dev_ref)
    if block is not None and _block_rows(chunk, block) is None:
        block = None
    if block is not None:
        # re-encode the constants against the dictionaries the resident
        # code lanes were actually built with — delta patches extend
        # them past the chunk's own memoized encode
        enc = encoded.translate_filter(
            plan.host_filter, chunk,
            dict_of=lambda j, _b=block: _b.dicts.get(j))
        if enc is None:     # block lost a dictionary: decoded path
            runtime_stats.note_fallback(plan, "encoding")
            return None
    eff = enc if plan.filter is None else func(Op.AND, plan.filter, enc)
    try:
        k = kernel_for(eff, plan.group_exprs or [], plan.aggs,
                       device=device)
    except (DeviceRejectError, NotImplementedError, ValueError):
        runtime_stats.note_fallback(plan, "encoding")
        return None
    try:
        if block is not None:
            nbytes = k.scratch_nbytes(chunk)
            moved = block.nbytes
        else:
            moved = memtrack.device_put_bytes(chunk)
            nbytes = k.dispatch_nbytes(chunk)
        res = _dispatch_finalize(plan, k, chunk, block, nbytes, moved,
                                 device)
        sched.device_health().note_ok()
    except failpoint.DispatchTimeoutError:
        raise       # statement already cancel-latched by the watchdog
    except DeviceFaultError:
        # device-plane fault: the decoded retry below owns the
        # retry/degrade bookkeeping — just record the fault here
        sched.device_health().note_fault()
        return None
    except (CapacityError, CollisionError, DeviceRejectError,
            NotImplementedError):
        # the decoded retry re-runs with the ORIGINAL filter tree (the
        # code-space one is device-only) and records its own outcome
        return None
    mode = _agg_mode(plan, k)
    runtime_stats.note_encoding(plan, mode)
    runtime_stats.note_mode(
        plan, "direct" if mode == "direct-agg" else "hash")
    runtime_stats.note_bytes_touched(memtrack.chunk_bytes(chunk), moved)
    if config.superchunk_rows():
        runtime_stats.note_superchunk(
            plan, chunk.num_rows, bucket_size(max(chunk.num_rows, 1)),
            sources)
    return CopResponse(chunk=res)


def exec_cop_plan(plan: CopPlan, chunk, sources: int = 1,
                  dev_ref=None, device=None) -> CopResponse:
    """Run the pushed subplan over one region's decoded chunk on `device`
    (CUDA unless the caller asks for another). `sources` is how many
    storage scan batches were coalesced into `chunk` (superchunk
    accounting).

    `dev_ref` — a (device_cache, key, data_version, read_ts, fill_ts,
    pend_fn) tuple from _cached_range_chunk — marks `chunk` as an
    HBM-cacheable region block: a device agg dispatch then runs FUSED
    from the cached device-resident columns (scan->filter->partial-agg
    in one dispatch, zero host->device bytes on a hit). fill_ts None =
    consult only, never fill (the MVCC fill conditions did not hold);
    pend_fn lets the HBM cache fold staged row deltas into the resident
    block on the device (store/delta.py)."""
    from tidb_tpu_torch.ops.runtime import resolve_device
    device = resolve_device(device)
    # one health-gate evaluation per call, shared by the encoded and
    # decoded device attempts: the quarantine probe admission is a
    # consumable token, and the fault/quarantine fallback must count
    # once per logical dispatch, not once per attempted path
    health_ok = None

    def _health_gate() -> bool:
        nonlocal health_ok
        if health_ok is None:
            if sched.statement_degraded():
                # a retried device fault already latched this
                # statement onto the host path
                runtime_stats.note_fallback(plan, "fault")
                health_ok = False
            elif not sched.device_health().available():
                # device quarantined after repeated faults; the host
                # path serves until the re-probe readmits it
                runtime_stats.note_fallback(plan, "quarantine")
                health_ok = False
            else:
                health_ok = True
        return health_ok

    if plan.host_filter is not None:
        if (plan.is_agg and config.encoded_exec_enabled() and
                config.device_enabled() and
                chunk.num_rows >= config.device_min_rows() and
                _health_gate()):
            resp = _encoded_agg(plan, chunk, sources, dev_ref, device)
            if resp is not None:
                return resp
        # decoded path: the host filter rewrites the chunk, so the raw
        # cached block no longer matches it — the fused path only
        # covers device-complete (or code-translated) predicates
        dev_ref = None
        mask = eval_filter_host(plan.host_filter, chunk)
        chunk = chunk.filter(mask)
        if plan.is_agg:
            runtime_stats.note_encoding(plan, "decoded")
    if plan.is_agg:
        use_device = config.device_enabled() and \
            chunk.num_rows >= config.device_min_rows() and \
            _health_gate()
        retried = False
        while use_device:
            try:
                k = _agg_kernels(plan, device)
                block = _resolve_block(plan, chunk, dev_ref)
                if block is not None and _block_rows(chunk, block) is None:
                    block = None
                if block is not None:
                    # the input columns stay on the cache's own
                    # ledger; the statement pays only kernel scratch
                    nbytes = k.scratch_nbytes(chunk)
                    moved = block.nbytes
                else:
                    moved = memtrack.device_put_bytes(chunk)
                    nbytes = k.dispatch_nbytes(chunk)
                res = _dispatch_finalize(plan, k, chunk, block, nbytes,
                                         moved, device)
                sched.device_health().note_ok()
                if plan.host_filter is None:
                    runtime_stats.note_encoding(plan, _agg_mode(plan, k))
                runtime_stats.note_mode(
                    plan, "direct" if _agg_mode(plan, k) == "direct-agg"
                    else "hash")
                runtime_stats.note_bytes_touched(
                    memtrack.chunk_bytes(chunk), moved)
                if config.superchunk_rows():
                    runtime_stats.note_superchunk(
                        plan, chunk.num_rows,
                        bucket_size(max(chunk.num_rows, 1)), sources)
                return CopResponse(chunk=res)
            except failpoint.DispatchTimeoutError:
                # the watchdog already cancel-latched the statement:
                # retrying is futile, the cancel must surface
                raise
            except DeviceFaultError as e:
                # device-plane fault (injected or real — HBM fill,
                # dispatch): retry ONCE through the store Backoffer,
                # then degrade this statement to the host path and let
                # the quarantine logic decide whether the device keeps
                # taking other statements' work
                health = sched.device_health()
                health.note_fault()
                # a fault that just quarantined the device is not
                # retried: the retry would refill the HBM block the
                # quarantine shed (the JAX package retries it)
                if not retried and not health.snapshot()["quarantined"]:
                    retried = True
                    trace.event("device.retry")
                    try:
                        Backoffer(2_000).backoff(BO_RPC, e)
                    except BackoffExhausted:
                        pass
                    continue
                sched.degrade_statement()
                runtime_stats.note_fallback(plan, "fault")
                profiler.note_kernel_fallback(profiler.profile_of(k),
                                              "fault")
                break
            except (CapacityError, CollisionError) as e:
                if plan.group_exprs:
                    # capacity/collision miss: escalate once, then retry
                    # per radix partition (ops/hybrid.py) — the device
                    # is abandoned per PARTITION, never per operator
                    from tidb_tpu_torch.ops.hybrid import agg_retry
                    profiler.note_escalation(profiler.profile_of(k))
                    runtime_stats.note_mode(plan, "hybrid")
                    return CopResponse(chunk=agg_retry(
                        chunk, plan.filter, plan.group_exprs, plan.aggs,
                        e, stats=_PlanFallbacks(plan), device=device))
                reason = "collision" if isinstance(e, CollisionError) \
                    else "capacity"
                runtime_stats.note_fallback(plan, reason)
                profiler.note_kernel_fallback(profiler.profile_of(k),
                                              reason)
                break
            except (DeviceRejectError, NotImplementedError):
                # designed rejection (not device-safe). A bare
                # ValueError is NOT caught here: a real kernel bug must
                # surface, not masquerade as a capacity miss
                runtime_stats.note_fallback(plan, "unsupported")
                break
        runtime_stats.note_encoding(plan, "decoded")
        runtime_stats.note_mode(plan, "host")
        # host-path agg time is its own attribution phase: on the trace
        # AND on the tenant's host-fallback ledger (meter.py)
        with meter.busy_section("host"), \
                trace.span("host.fallback", rows=chunk.num_rows):
            if plan.group_exprs:
                return CopResponse(chunk=host_hash_agg(
                    chunk, plan.filter, plan.group_exprs, plan.aggs))
            return CopResponse(chunk=host_scalar_agg(
                chunk, plan.filter, plan.aggs))
    if plan.filter is not None:
        mask = eval_filter_host(plan.filter, chunk)
        chunk = chunk.filter(mask)
    return CopResponse(chunk=chunk)


def _delta_store_of(storage):
    """The storage's delta store when capture is active, else None."""
    dstore = getattr(storage, "delta_store", None)
    if dstore is None or not dstore.enabled():
        return None
    return dstore


def _dev_pending_fn(dstore, plan: CopPlan, s: bytes, e: bytes):
    """Closure the HBM cache calls to fetch (and plan-layout decode)
    the staged delta window for ITS entry's fill_ts — the device block
    may lag or lead the host entry, so the window is per-consumer."""
    from tidb_tpu_torch.store import delta as deltamod

    def pend_fn(lo_ts: int, hi_ts: int):
        pend = dstore.pending(plan.table.id, s, e, lo_ts, hi_ts)
        if pend is None or pend is deltamod.STALE:
            return pend
        if pend.decoded is None:
            pend.decoded = decode_cop_batch(plan, pend.upsert_rows)
        return pend

    return pend_fn


def _cached_range_chunk(storage, region: Region, plan: CopPlan, s: bytes,
                        e: bytes, req: CopRequest):
    """Whole-range decoded chunk with host-cache lookup/fill, served as
    base ⋈ delta under OLTP writes (store/delta.py).
    -> (chunk, dev_ref): dev_ref parameterizes the HBM device cache
    (store/device_cache.py) for a fused dispatch over the same block —
    (cache, key, data_version, read_ts, fill_ts, pend_fn), with fill_ts
    None when the MVCC fill conditions did not hold (consult-only) and
    fill_ts the DELTA WATERMARK when the served chunk is a base⋈delta
    merge."""
    from tidb_tpu_torch.store import delta as deltamod
    from tidb_tpu_torch.store.chunk_cache import ChunkCache
    cache = storage.chunk_cache
    key = ChunkCache.key(region, plan, s, e)
    # resolve the delta store BEFORE sampling the version: the consult
    # has a side effect — flipping tidb_tpu_delta_store off flushes the
    # staged journal and bumps data_version once (DeltaStore.enabled),
    # and sampling first would serve the pre-flush base at the old
    # version
    dstore = _delta_store_of(storage)
    # sample the version BEFORE scanning: a structural write landing
    # mid-scan bumps past it, so the filled entry can never serve stale
    # data (row commits landing mid-scan get commit_ts > start_ts and
    # ride the delta journal instead). A pending lock anywhere also
    # vetoes caching: lock visibility is per-reader-ts, so a fill that
    # legally skipped a newer txn's lock would hide the KeyLockedError
    # a newer reader must hit.
    dv = storage.engine.data_version
    # serve-time lock veto — the delta path's replacement for the
    # prewrite version bump: a pending lock this reader must observe
    # forces the real scan below (which raises KeyLockedError for
    # resolution exactly as an uncached read would) while every cache
    # entry SURVIVES the write
    locked = dstore is not None and \
        storage.engine.locked_in_range(s, e, req.start_ts)
    cacheable = not storage.engine._locked_keys
    fill_ts = None
    hit = None if locked else cache.lookup(key, dv, req.start_ts)
    if hit is not None and dstore is not None:
        if plan.index is not None:
            # index layouts can't be patched from row deltas: an
            # index-key commit since the fill drops the entry (both
            # tiers) so it re-fills at a newer snapshot — other tables
            # and record scans stay untouched
            if dstore.index_stale(plan.table.id, hit[0], req.start_ts):
                cache.drop(key, if_chunk=hit[1])
                dc0 = getattr(storage, "device_cache", None)
                if dc0 is not None:
                    from tidb_tpu_torch.store.device_cache import DeviceCache
                    dc0.drop(DeviceCache.key(region, plan, s, e))
                hit = None
        else:
            pend = dstore.pending(plan.table.id, s, e, hit[0],
                                  req.start_ts)
            if pend is deltamod.STALE:
                # journal truncated under the entry: re-scan
                cache.drop(key, if_chunk=hit[1])
                hit = None
            elif pend is not None:
                with trace.span("delta.fold", rows=hit[1].num_rows):
                    merged = dstore.patch_chunk(cache, key, plan,
                                                hit[1], pend)
                if merged is None:
                    cache.drop(key, if_chunk=hit[1])
                    hit = None
                else:
                    from tidb_tpu_torch import metrics
                    metrics.counter(metrics.CACHE_DELTA_SERVES)
                    hit = (pend.watermark, merged)
    if hit is not None:
        # the host entry's OWN fill snapshot (or delta watermark)
        # bounds the device entry: both caches share one validity
        # window per the freshness contract
        fill_ts, chunk = hit
    else:
        parts = []
        hparts = []
        want_handles = dstore is not None and plan.index is None
        cur = s
        while True:
            batch = storage.engine.scan(cur, e, COP_SCAN_BATCH,
                                        req.start_ts, req.isolation,
                                        desc=False)
            if not batch:
                break
            parts.append(decode_cop_batch(plan, batch))
            if want_handles:
                hparts.append(deltamod.record_handles(
                    [k for k, _v in batch]))
            if len(batch) < COP_SCAN_BATCH:
                break
            cur = batch[-1][0] + b"\x00"
        from tidb_tpu_torch.chunk import Chunk
        chunk = Chunk.concat_all(parts) if parts else \
            decode_cop_batch(plan, [])
        if want_handles:
            import numpy as _np
            chunk._scan_handles = _np.concatenate(hparts) if hparts \
                else _np.zeros(0, dtype=_np.int64)
            dstore.note_base_rows(plan.table.id, chunk.num_rows)
        # cache only fills whose snapshot covers every commit: an older
        # snapshot's view is valid for ITS ts but must not become the
        # cached truth for newer readers (see MVCCStore.max_commit_ts)
        if cacheable and req.start_ts >= storage.engine.max_commit_ts:
            fill_ts = req.start_ts
            cache.put(key, dv, fill_ts, chunk)
    dev_ref = None
    dcache = getattr(storage, "device_cache", None)
    if dcache is not None and plan.is_agg and plan.host_filter is None \
            and not locked and dcache.enabled():
        from tidb_tpu_torch.store.device_cache import DeviceCache
        pend_fn = None
        if dstore is not None and plan.index is None:
            pend_fn = _dev_pending_fn(dstore, plan, s, e)
        dev_ref = (dcache, DeviceCache.key(region, plan, s, e), dv,
                   req.start_ts, fill_ts, pend_fn)
    return chunk, dev_ref


def exec_cached_cop(storage, region: Region, plan: CopPlan, s: bytes,
                    e: bytes, req: CopRequest) -> list[CopResponse]:
    """One region task served through the columnar caches: whole-range
    decoded chunk (host chunk cache), HBM-resident block for fused agg
    dispatch (device cache), memoized filter results. Shared by the
    materialized handler and the streaming producer, so COP_STREAM
    reads hit exactly the same cache hierarchy."""
    chunk, dev_ref = _cached_range_chunk(storage, region, plan, s, e, req)
    if chunk.num_rows == 0:
        return []
    if not plan.is_agg and (plan.filter is not None or
                            plan.host_filter is not None) and \
            _plan_filter_memoizable(plan):
        # FILTER-only plans memoize their result on the cached
        # raw chunk: repeated hot scans then return the SAME
        # filtered chunk object, so every downstream device
        # memo (shard transfers, build tables) keeps hitting —
        # re-filtering per execution silently re-uploaded whole
        # probe tables. Agg plans stay uncached so the host and
        # device paths both really compute (the bench contract).
        with _memo_lock:
            memo = getattr(chunk, "_cop_filter_memo", None)
            if memo is None:
                memo = chunk._cop_filter_memo = OrderedDict()
            hit = memo.get(id(plan))
            if hit is not None:
                memo.move_to_end(id(plan))
                return [hit[1]]
        resp = exec_cop_plan(plan, chunk, device=storage.device)
        from tidb_tpu_torch.store.chunk_cache import ChunkCache, _chunk_bytes
        with _memo_lock:
            if id(plan) not in memo:
                # entry pins plan, so the id cannot be recycled
                memo[id(plan)] = (plan, resp)
                while len(memo) > 8:
                    memo.popitem(last=False)
                # memoized results count toward the raw entry's
                # cache budget (evicting the raw chunk drops
                # them all)
                storage.chunk_cache.add_cost(
                    ChunkCache.key(region, plan, s, e),
                    _chunk_bytes(resp.chunk))
        return [resp]
    return [exec_cop_plan(plan, chunk, dev_ref=dev_ref,
                          device=storage.device)]


def use_cached_path(storage, plan: CopPlan) -> bool:
    """True when a region task is served through the columnar caches
    (whole-range, no LIMIT short-circuit)."""
    return (plan.limit is None and config.chunk_cache_enabled()
            and getattr(storage, "chunk_cache", None) is not None)


def clamp_range(region: Region, rng: KVRange) -> tuple[bytes, bytes]:
    """Clamp one request range to a region's bounds. Cache keys embed
    this (s, e), so the materialized handler and the streaming producer
    (store/stream.py) MUST share this one clamp — diverging copies
    would silently stop their cache entries from serving each other."""
    s = max(rng.start, region.start)
    if region.end and rng.end:
        e = min(rng.end, region.end)
    else:
        e = region.end or rng.end   # either bound may be open (falsy)
    return s, e


def cop_handler(storage):
    """Builds the storage-side handler closure installed into the RPC shim.
    Executes scan+filter+partial-agg for one region (cop_handler_dag.go's
    role). Unlimited scans are served through the storage node's columnar
    chunk cache (store/chunk_cache.py — the TiFlash-columnar-replica
    analogue): the KV scan + row decode runs once per engine state, and
    repeated analytical reads go straight from decoded columns to the
    device kernel — or, when the HBM device cache holds the block
    (store/device_cache.py), straight from device-resident columns."""

    _decode = decode_cop_batch

    def handle(region: Region, req: CopRequest) -> list[CopResponse]:
        plan: CopPlan = req.plan
        rng: KVRange = req.ranges[0]   # client sends one range per task
        s, e = clamp_range(region, rng)
        if use_cached_path(storage, plan):
            return exec_cached_cop(storage, region, plan, s, e, req)
        out = []
        cur = s
        remaining = plan.limit
        # agg subplans coalesce scan batches into ~superchunk_rows
        # superchunks before the kernel sees them: one partial-agg
        # dispatch per superchunk instead of per 64k-row scan batch.
        # Non-agg plans keep the per-batch loop — the limit
        # short-circuit below must stay chunk-at-a-time.
        sc_limit = config.superchunk_rows() if plan.is_agg else 0
        parts: list = []
        acc = 0
        staged = 0     # host bytes of the superchunk assembly buffer

        def flush_parts() -> None:
            nonlocal acc, staged
            from tidb_tpu_torch.chunk import Chunk
            if not parts:
                return
            big = Chunk.concat_all(parts)
            n_src = len(parts)
            parts.clear()
            acc = 0
            if staged:
                memtrack.release(plan, host=staged)
                staged = 0
            if big is not None:
                out.append(exec_cop_plan(plan, big, sources=n_src,
                                         device=storage.device))

        try:
            while True:
                batch = storage.engine.scan(cur, e, COP_SCAN_BATCH,
                                            req.start_ts,
                                            req.isolation, desc=False)
                if not batch:
                    break
                if sc_limit:
                    dec = _decode(plan, batch)
                    parts.append(dec)
                    b = memtrack.chunk_bytes(dec)
                    memtrack.consume(plan, host=b)
                    staged += b
                    acc += dec.num_rows
                    if acc >= sc_limit:
                        flush_parts()
                else:
                    resp = exec_cop_plan(plan, _decode(plan, batch),
                                         device=storage.device)
                    out.append(resp)
                    if remaining is not None and not plan.is_agg:
                        remaining -= resp.chunk.num_rows
                        if remaining <= 0:
                            break
                if len(batch) < COP_SCAN_BATCH:
                    break
                cur = batch[-1][0] + b"\x00"
            if sc_limit:
                flush_parts()
        finally:
            # a raise mid-assembly (decode error, quota cancel from a
            # sibling worker) must not strand the staging bytes on the
            # reader's ledger until statement detach
            if staged:
                memtrack.release(plan, host=staged)
                staged = 0
        return out

    return handle


class CopClient(kv.Client):
    """Region fan-out with a worker pool (copIterator, coprocessor.go:342)."""

    def __init__(self, storage):
        self.storage = storage
        self.cache = storage.region_cache
        self.shim = storage.shim
        # remote shims execute the coprocessor in the storage process and
        # have no installable handler surface
        if getattr(self.shim, "_cop_handler", "remote") is None:
            self.shim.install_cop_handler(cop_handler(storage))
        if getattr(self.shim, "_cop_stream_handler", "remote") is None:
            from tidb_tpu_torch.store.stream import cop_stream_handler
            self.shim.install_cop_stream_handler(cop_stream_handler(storage))

    def send(self, req: CopRequest):
        """Yields CopResponses; unordered unless req.keep_order."""
        self.storage.check_visibility(req.start_ts)
        tasks = self.cache.split_ranges_by_region(req.ranges)
        if not tasks:
            return
        from tidb_tpu_torch import metrics
        metrics.counter(metrics.COP_TASKS, inc=len(tasks))
        coll = runtime_stats.current()
        if coll is not None:
            # send() is driven on the session thread (first next()):
            # attribute the fan-out width to the issuing reader node
            coll.note_cop_tasks(req.plan, len(tasks))
        concurrency = min(req.concurrency or config.cop_concurrency(),
                          len(tasks))
        if config.copr_stream_enabled() and \
                getattr(self.shim, "coprocessor_stream", None) is not None:
            yield from self._send_streaming(req, tasks, concurrency)
            return
        # the session's sysvar overlay is thread-local: capture it here
        # and re-install inside every pool worker so per-session knobs
        # (device on/off, cache) apply uniformly across the fan-out —
        # the runtime-stats collector, the memory tracker AND the
        # statement trace ride along the same way, so storage-side
        # device kernels attribute their time, bytes and spans to the
        # reader node that issued them
        overlay = config.current_overlay()
        mem_root = memtrack.current()
        res_meter = meter.current()
        tspan = trace.propagate()
        # consumer-gone signal, checked between tasks: teardown signals
        # it and then JOINS the pool (the copIterator.Close
        # finished-channel + wg.Wait() discipline) — a statement never
        # leaves detached workers holding scheduler slots or ledger
        # bytes past its own unwind, which is exactly what the
        # ledger_hygiene drain checks assert right after an error
        stop = threading.Event()

        def run_task(rq, rng):
            if stop.is_set():
                return []
            with config.session_overlay(overlay), \
                    runtime_stats.collecting(coll), \
                    memtrack.tracking(mem_root), \
                    meter.metering(res_meter), \
                    trace.attached(tspan):
                with trace.span("copr.task"):
                    return list(self._run_task(rq, rng))
        if concurrency <= 1 or len(tasks) == 1:
            for loc, rng in tasks:
                with trace.span("copr.task"):
                    out = self._run_task(req, rng)
                yield from out
            return
        results: "queue.Queue" = queue.Queue()
        done = object()

        def worker(task_list):
            try:
                with config.session_overlay(overlay), \
                        runtime_stats.collecting(coll), \
                        memtrack.tracking(mem_root), \
                        meter.metering(res_meter), \
                        trace.attached(tspan):
                    for _loc, rng in task_list:
                        if stop.is_set():   # consumer gone: stop at the
                            break           # next task boundary
                        with trace.span("copr.task"):
                            out = self._run_task(req, rng)
                        for resp in out:
                            results.put(resp)
                results.put(done)
            except Exception as exc:  # noqa: BLE001
                results.put(exc)

        if req.keep_order:
            # ordered at FULL concurrency: tasks run in parallel, results
            # drain strictly in task (range) order — the per-task
            # response-channel design of coprocessor.go:342-457. A
            # sliding window of `concurrency` in-flight tasks bounds both
            # memory and wasted work when the consumer stops early.
            from collections import deque
            pool = ThreadPoolExecutor(max_workers=concurrency,
                                      thread_name_prefix="cop-ord")
            try:
                it = iter(tasks)
                window: deque = deque()
                for _ in range(concurrency):
                    nxt = next(it, None)
                    if nxt is None:
                        break
                    window.append(pool.submit(run_task, req, nxt[1]))
                while window:
                    f = window.popleft()
                    nxt = next(it, None)
                    if nxt is not None:
                        window.append(pool.submit(run_task, req,
                                                  nxt[1]))
                    yield from f.result()
            finally:
                # signal, drop queued tasks, then WAIT: in-flight tasks
                # finish their current dispatch and release their slots
                # before the statement's unwind completes
                stop.set()
                pool.shutdown(wait=True, cancel_futures=True)
            return
        buckets = [tasks[i::concurrency] for i in range(concurrency)]
        pool = ThreadPoolExecutor(max_workers=concurrency,
                                  thread_name_prefix="cop")
        for b in buckets:
            pool.submit(worker, b)
        finished = 0
        try:
            while finished < concurrency:
                item = results.get()
                if item is done:
                    finished += 1
                elif isinstance(item, Exception):
                    raise item
                else:
                    yield item
        finally:
            # `results` is unbounded so no producer can block on a put;
            # the stop flag bounds the join at one in-flight task per
            # worker
            stop.set()
            pool.shutdown(wait=True)

    def _run_task(self, req: CopRequest, rng: KVRange):
        """One region task with retry (handleTask, coprocessor.go:507):
        region errors re-split the range; locks resolve."""
        # a killed statement stops here, on the pool worker, at its
        # next task (the worker carries the statement's memtrack root)
        memtrack.check_interrupted()
        bo = Backoffer(COP_MAX_BACKOFF)
        while True:
            loc = self.cache.locate(rng.start)
            sub = CopRequest(tp=req.tp, ranges=[rng], plan=req.plan,
                             start_ts=req.start_ts,
                             concurrency=1, isolation=req.isolation)
            try:
                return self.shim.coprocessor(loc.ctx, sub)
            except NotLeaderError as e:
                self.cache.on_not_leader(e)
                bo.backoff(BO_REGION_MISS, e)
            except RegionError as e:
                self.cache.invalidate(loc.region.id)
                bo.backoff(BO_REGION_MISS, e)
                # range may now span regions: re-split and recurse
                out = []
                for _l, sub_rng in self.cache.split_ranges_by_region([rng]):
                    out.extend(self._run_task(req, sub_rng))
                return out
            except ServerBusyError as e:
                bo.backoff(BO_SERVER_BUSY, e)
            except KeyLockedError as e:
                if not self.storage.resolver.resolve(bo, [e.lock]):
                    bo.backoff(BO_TXN_LOCK, e)

    # -- streaming path (tidb_tpu_copr_stream=1; ref: CmdCopStream,
    # coprocessor.go:547-555 + handleCopStreamResult resume) ---------------

    def _send_streaming(self, req: CopRequest, tasks, concurrency: int):
        """Framed partial responses, never a materialized per-region
        list. Concurrency 1 (or one task) runs tasks sequentially with
        ONE lazy in-flight stream — range order is frame order and the
        client buffers nothing. KeepOrder at full concurrency runs a
        sliding window of `concurrency` streams whose frames drain
        strictly in task (range) order from per-task credit-sized
        queues — the streaming analogue of the materialized path's
        per-task response channels (coprocessor.go:342-457), bounded by
        concurrency x credit frames instead of whole response lists.
        The unordered fan-out runs tasks in a pool draining into ONE
        BoundedFrameQueue sized to the credit window, so producers
        block (credit stall) instead of buffering when the consumer is
        slow."""
        from tidb_tpu_torch.store.stream import BoundedFrameQueue

        credit = config.copr_stream_credit()
        # per-QUERY span tags come from client-side counters (one dict
        # per task, summed here) — the module-level stream stats are
        # process-cumulative and would cross-pollute concurrent sessions
        counters: list[dict] = []

        def new_counter() -> dict:
            c = {"frames": 0, "resumes": 0}
            counters.append(c)
            return c

        def annotate_totals() -> None:
            trace.annotate(
                cop_stream_frames=sum(c["frames"] for c in counters),
                cop_stream_resumes=sum(c["resumes"] for c in counters))

        if concurrency <= 1 or len(tasks) == 1:
            for _loc, rng in tasks:
                yield from self._run_task_stream(req, rng, new_counter())
            annotate_totals()
            return
        if req.keep_order:
            yield from self._send_streaming_ordered(
                req, tasks, concurrency, credit, new_counter)
            annotate_totals()
            return
        stop = threading.Event()
        q = BoundedFrameQueue(credit, stop)
        overlay = config.current_overlay()
        coll = runtime_stats.current()
        mem_root = memtrack.current()
        res_meter = meter.current()
        tspan = trace.propagate()
        buckets = [tasks[i::concurrency] for i in range(concurrency)]

        def worker(task_list):
            try:
                with config.session_overlay(overlay), \
                        runtime_stats.collecting(coll), \
                        memtrack.tracking(mem_root), \
                        meter.metering(res_meter), \
                        trace.attached(tspan), \
                        trace.span("copr.stream", tasks=len(task_list)):
                    for _loc, rng in task_list:
                        if stop.is_set():
                            return           # consumer gone
                        for resp in self._run_task_stream(
                                req, rng, new_counter()):
                            if not q.put(resp):
                                return       # consumer gone
                q.put_done()
            except Exception as exc:  # noqa: BLE001 — re-raised by consumer
                q.put(exc)
                q.put_done()

        pool = ThreadPoolExecutor(max_workers=concurrency,
                                  thread_name_prefix="cop-stream")
        for b in buckets:
            pool.submit(worker, b)
        try:
            yield from q.drain(len(buckets))
            annotate_totals()
        finally:
            # stop, then JOIN: q.put polls the stop event every 50ms so
            # blocked producers exit promptly, and a producer mid-frame
            # finishes its current device step and releases its slot
            # before the statement's unwind completes — no detached
            # worker outlives the statement (ledger/slot hygiene)
            stop.set()
            pool.shutdown(wait=True)

    def _send_streaming_ordered(self, req: CopRequest, tasks,
                                concurrency: int, credit: int,
                                new_counter):
        """Ordered streaming at full concurrency: up to `concurrency`
        region streams produce in parallel, each into its OWN
        credit-sized BoundedFrameQueue; the consumer drains the queues
        strictly in task order, launching the next task as each window
        slot frees. Producers past their credit window block (counted
        as credit stalls), so client buffering is bounded by
        concurrency x credit frames while storage-side scan/decode/agg
        for later ranges overlaps the consumer's drain of earlier
        ones."""
        from collections import deque
        from tidb_tpu_torch.store.stream import BoundedFrameQueue

        stop = threading.Event()
        overlay = config.current_overlay()
        coll = runtime_stats.current()
        mem_root = memtrack.current()
        res_meter = meter.current()
        tspan = trace.propagate()
        pool = ThreadPoolExecutor(max_workers=concurrency,
                                  thread_name_prefix="cop-stream-ord")

        def launch(rng) -> BoundedFrameQueue:
            q: BoundedFrameQueue = BoundedFrameQueue(credit, stop)

            def produce():
                try:
                    with config.session_overlay(overlay), \
                            runtime_stats.collecting(coll), \
                            memtrack.tracking(mem_root), \
                            meter.metering(res_meter), \
                            trace.attached(tspan), \
                            trace.span("copr.stream"):
                        for resp in self._run_task_stream(
                                req, rng, new_counter()):
                            if not q.put(resp):
                                return       # consumer gone
                    q.put_done()
                except Exception as exc:  # noqa: BLE001 — re-raised by
                    q.put(exc)            # the consumer's drain
                    q.put_done()

            pool.submit(produce)
            return q

        try:
            it = iter(tasks)
            window: deque = deque()
            for _ in range(concurrency):
                nxt = next(it, None)
                if nxt is None:
                    break
                window.append(launch(nxt[1]))
            while window:
                q0 = window.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    window.append(launch(nxt[1]))
                yield from q0.drain(1)
        finally:
            stop.set()               # producers poll it inside put()
            pool.shutdown(wait=True)

    def _run_task_stream(self, req: CopRequest, rng: KVRange,
                         counter: dict | None = None):
        """One range, streamed: frames arrive in key order; `cur` tracks
        the last ACKED range boundary. A region error, failpoint, or
        dropped connection mid-stream re-locates from `cur` and
        re-issues — frames cover contiguous, non-overlapping ranges, so
        the retry can neither duplicate nor skip rows. Crossing a region
        boundary (final frame's `range.end` before the requested end)
        continues into the next region under the same cursor.
        `counter` collects this call's frame/resume counts for per-query
        span tags."""
        from tidb_tpu_torch import kv as _kv
        from tidb_tpu_torch.store.stream import note_resume

        if counter is None:
            counter = {"frames": 0, "resumes": 0}

        def resumed() -> None:
            counter["resumes"] += 1
            note_resume()
        bo = Backoffer(COP_MAX_BACKOFF)
        cur = rng.start
        while True:
            loc = self.cache.locate(cur)
            sub = CopRequest(tp=req.tp, ranges=[KVRange(cur, rng.end)],
                             plan=req.plan, start_ts=req.start_ts,
                             concurrency=1, isolation=req.isolation)
            covered_to = None
            try:
                it = self.shim.coprocessor_stream(
                    loc.ctx, sub, credit=config.copr_stream_credit(),
                    frame_bytes=config.copr_stream_frame_bytes())
                for frame in it:
                    # a killed statement stops at the next frame
                    memtrack.check_interrupted()
                    counter["frames"] += 1
                    # chunk is a Chunk (scan/filter), a GroupResult
                    # (device partial agg — no num_rows), or None
                    if frame.chunk is not None and \
                            getattr(frame.chunk, "num_rows", 1):
                        yield CopResponse(chunk=frame.chunk,
                                          range=frame.range)
                    cur = frame.range.end        # acked through here
                    if frame.last:
                        covered_to = frame.range.end
            except (NotLeaderError, RegionError, ServerBusyError,
                    KeyLockedError, _kv.StreamInterruptedError) as e:
                if covered_to is not None:
                    # the final frame was already acked — the stream's
                    # work is DONE and only protocol closure failed.
                    # Resuming would re-scan from `cur`, which for an
                    # open-ended final frame is b"" (= the very start):
                    # the one way this loop could duplicate rows.
                    pass
                elif isinstance(e, NotLeaderError):
                    self.cache.on_not_leader(e)
                    bo.backoff(BO_REGION_MISS, e)
                    resumed()
                    continue
                elif isinstance(e, RegionError):
                    self.cache.invalidate(loc.region.id)
                    bo.backoff(BO_REGION_MISS, e)
                    resumed()
                    continue
                elif isinstance(e, _kv.StreamInterruptedError):
                    # the stream died with the connection: the region
                    # epoch we hold may be from before the store plane
                    # restarted — re-resolve instead of re-issuing the
                    # same stale ctx forever
                    self.cache.invalidate(loc.region.id)
                    bo.backoff(BO_REGION_MISS, e)
                    resumed()
                    continue
                elif isinstance(e, ServerBusyError):
                    bo.backoff(BO_SERVER_BUSY, e)
                    resumed()
                    continue
                else:   # KeyLockedError
                    if not self.storage.resolver.resolve(bo, [e.lock]):
                        bo.backoff(BO_TXN_LOCK, e)
                    resumed()
                    continue
            if covered_to is None:
                covered_to = cur
            if not covered_to:
                return          # open-ended coverage: nothing beyond
            if rng.end and covered_to >= rng.end:
                return          # requested range fully covered
            cur = covered_to    # region ended early: continue next region
