"""Executors for plane-routed plans (plan/mesh_route.py).

The port of the JAX package's executor/mesh.py. The heavy reduction
happens ON the device plane (ops/meshagg.py, ops/meshjoin.py) and the
host only merges the already tiny per-statement group tables and
formats rows.

One pipeline: the streaming path is the same superchunk_batches +
pipeline_map machinery as the single-device operators (executor/agg.py):
pipeline_map owns the dispatch slots, meter sections, trace spans,
failpoint seams and the abandoned-token drain; this module only supplies
the dispatch/finalize closures and their device-ledger charges.
Per-batch recovery: a capacity overflow re-plans the kernel and re-runs
only that batch (group merging is associative, so batches already
merged stay valid); collisions or non-device expressions aggregate that
batch on the host, counted under the same `reason` labels as every
other device fallback (capacity, collision, unsupported).

Fallback contract: every plane plan carries the original subtree; the
operator delegates to it when no plane is active, when expressions fail
device validation, on group-capacity overflow past the escalation cap,
on hash collisions, or on non-unique dimension build keys.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict

from tidb_tpu_torch import config as sysconf
from tidb_tpu_torch import (devplane, memtrack, profiler, runtime_stats,
                            sched, trace)
from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.executor.agg import _empty_agg_value, _results_chunk
from tidb_tpu_torch.ops import runtime as op_runtime
from tidb_tpu_torch.ops.hashagg import (CapacityError, CollisionError,
                                        HashAggregator)
from tidb_tpu_torch.ops.hostagg import host_hash_agg
from tidb_tpu_torch.ops.meshagg import MeshAggKernel
from tidb_tpu_torch.ops.meshjoin import (BuildError, LookupSpec,
                                         MeshLookupAggKernel, _BuildTable,
                                         host_lookup_agg)
from tidb_tpu_torch.ops.runtime import bucket_size, superchunk_batches
from tidb_tpu_torch.util import failpoint

__all__ = ["MeshAggExec", "MeshLookupAggExec", "stream_stats",
           "reset_stream_stats"]

# Streaming telemetry (tests and the smoke assert bounded buffering and
# that the dispatch-ahead overlap actually happened).
_STREAM_STATS = {"streams": 0, "batches": 0, "host_batches": 0,
                 "max_batch_rows": 0, "overlapped_launches": 0}


def stream_stats() -> dict:
    return dict(_STREAM_STATS)


def reset_stream_stats() -> None:
    for k in _STREAM_STATS:
        _STREAM_STATS[k] = 0


# Initial per-shard group-table capacity; on overflow the operator
# re-plans the kernel with 2x the observed distinct count, then falls
# back to the host.
DEFAULT_CAPACITY = 4096
MAX_CAPACITY = 1 << 20

# kernel reuse across executions of cached plans: keyed by plan object
# identity (the entry pins the plan so its id cannot be recycled) PLUS
# the plane identity (generation and fingerprint), so a 1-shard and an
# 8-shard kernel for the same plan never collide.
_KERNELS: OrderedDict = OrderedDict()
_KERNELS_CAP = 64


def _drop_stale_kernels() -> None:
    """Topology listener: kernels of an older plane generation can never
    be hit again; drop them (and their replicated build tables) now."""
    gen = devplane.mesh_generation()
    for k in [k for k in _KERNELS if k[0] != gen]:
        del _KERNELS[k]


devplane.on_topology_change(_drop_stale_kernels)


def _kernel_cache_get(plan, capacity):
    key = (devplane.mesh_generation(),
           devplane.mesh_fingerprint(process=True), id(plan), capacity)
    hit = _KERNELS.get(key)
    if hit is not None and hit[0] is plan:
        _KERNELS.move_to_end(key)
        profiler.note_construct(profiler.profile_of(hit[1]), reuse=True)
        return hit[1]
    return None


def _kernel_cache_put(plan, capacity, kernel) -> None:
    key = (devplane.mesh_generation(),
           devplane.mesh_fingerprint(process=True), id(plan), capacity)
    # one mesh-family construction per cache fill; the profile row keys
    # on the same plan identity + capacity the kernel slot does
    prof = profiler.profile("mesh", f"plan{id(plan)}|{capacity}")
    profiler.note_construct(prof, reuse=False)
    kernel._profile = prof
    _KERNELS[key] = (plan, kernel)
    _KERNELS.move_to_end(key)
    while len(_KERNELS) > _KERNELS_CAP:
        _KERNELS.popitem(last=False)


def _concat_chunks(parts, schema) -> Chunk:
    big = Chunk.concat_all([p for p in parts if p.num_rows])
    if big is None:
        return Chunk([Column.from_values(c.ft, []) for c in schema.cols])
    return big


# Bounded registry of concat memos: each entry pins a table-sized host
# chunk (and transitively its device copy), so they are counted: a
# long-lived server executing many distinct cached plans would otherwise
# pin one table copy per plan.
_CONCATS: OrderedDict = OrderedDict()
_CONCATS_CAP = 16


def _concat_chunks_cached(holder, slot: str, parts, schema) -> Chunk:
    """Concat memoized on `holder` (a plan node): when the storage chunk
    cache serves the same per-region chunk objects again, the
    concatenated table (and so its memoized sharded device copy) is
    reused, and a hot multi-region scan transfers zero bytes. Keyed by
    part identities; the parts are pinned in the entry so ids cannot be
    recycled."""
    key = tuple(id(p) for p in parts)
    cached = getattr(holder, slot, None)
    if cached is not None and cached[0] == key:
        reg_key = (id(holder), slot)
        if reg_key in _CONCATS:
            _CONCATS.move_to_end(reg_key)
        return cached[2]
    big = _concat_chunks(parts, schema)
    if len(parts) > 1:     # a single-part concat returns the cached chunk
        setattr(holder, slot, (key, parts, big))
        reg_key = (id(holder), slot)
        _CONCATS[reg_key] = holder
        _CONCATS.move_to_end(reg_key)
        while len(_CONCATS) > _CONCATS_CAP:
            _rk, h = _CONCATS.popitem(last=False)
            if hasattr(h, _rk[1]):
                delattr(h, _rk[1])
    return big


def _fallback_reason(e) -> str:
    """Label of a per-batch host fallback: the real cause, in the
    single-device pipeline's taxonomy."""
    if isinstance(e, CollisionError):
        return "collision"
    if isinstance(e, CapacityError):
        return "capacity"
    return "unsupported"


class _MeshExecBase:
    def __init__(self, plan, child):
        self.plan = plan
        self.child = child
        self.schema = list(plan.schema.cols)

    def _fallback(self, ctx):
        from tidb_tpu_torch.executor import build_executor
        return build_executor(self.plan.fallback).chunks(ctx)

    def _note_fallback(self, ctx, reason: str) -> None:
        ctx.stats.note_fallback(reason)
        runtime_stats.note_fallback(self, reason)

    def _emit_agg(self, agg):
        results = agg.results()
        if not self.plan.group_exprs and not results:
            results = [((), [_empty_agg_value(a) for a in self.plan.aggs])]
        return _results_chunk(self.schema, results)

    def _emit_results(self, gr_or_none):
        agg = HashAggregator(self.plan.aggs, self.plan.group_exprs)
        if gr_or_none is not None:
            agg.update(gr_or_none)
        return self._emit_agg(agg)

    @staticmethod
    def _cached_scan(reader, ctx):
        """Pull a plane operand scan through the NON-streaming copr path.

        Framed copr streaming re-encodes and re-decodes the table on
        every execution and bypasses the columnar chunk cache; the
        whole-region decoded chunks served here are cache hits on
        re-execution, which also keeps their object identities stable
        (the concat and sharded-transfer memos key on them). With the
        chunk cache off there is nothing to serve from, so framed
        streaming keeps its memory-bounded cold-scan role. The overlay
        is thread-local, so it shadows the session's
        tidb_tpu_copr_stream only while this generator is pulled."""
        if not sysconf.chunk_cache_enabled():
            yield from reader.chunks(ctx)
            return
        it = reader.chunks(ctx)
        while True:
            with sysconf.session_overlay({"tidb_tpu_copr_stream": 0}):
                try:
                    c = next(it)
                except StopIteration:
                    return
            yield c

    def _whole_table_run(self, kernel, chunk, chip):
        """One whole-table kernel execution under the same trace-span
        pair and failpoint seams as the copr sync sites, so a statement's
        span vocabulary does not depend on the plane size."""
        prof = profiler.profile_of(kernel)
        nb = memtrack.device_put_bytes(chunk) if prof is not None else 0
        with profiler.dispatch_section(prof, nbytes=nb, plan=self):
            with trace.span("dispatch", rows=chunk.num_rows, chip=chip):
                outs = kernel.launch(chunk, bucket=True)
            failpoint.eval("device/finalize")
            with trace.span("finalize"):
                return kernel.finish(outs, chunk)

    def _run_with_escalation(self, make_kernel, run):
        """Kernel build + run with one capacity re-plan on overflow. The
        successful capacity sticks to the plan, so re-executions of a
        cached plan start there. -> GroupResult or None (the caller
        falls back)."""
        capacity = getattr(self.plan, "_mesh_capacity", DEFAULT_CAPACITY)
        kernel = None
        for _attempt in (0, 1):
            try:
                kernel = _kernel_cache_get(self.plan, capacity)
                if kernel is None:
                    kernel = make_kernel(capacity)
                    _kernel_cache_put(self.plan, capacity, kernel)
                out = run(kernel)
                self.plan._mesh_capacity = capacity
                return out
            except CapacityError as e:
                profiler.note_escalation(profiler.profile_of(kernel))
                needed = getattr(e, "needed", None)
                if needed is None:
                    return None
                capacity = 1 << max(needed * 2 - 1, 1).bit_length()
                if capacity > MAX_CAPACITY:
                    return None
            except (CollisionError, BuildError, ValueError) as e:
                profiler.note_kernel_fallback(profiler.profile_of(kernel),
                                              _fallback_reason(e))
                return None
        return None

    def _stream_groups(self, ctx, superchunks, get_kernel, host_batch,
                       agg: HashAggregator) -> int:
        """Streaming aggregation on the shared pipeline: pipeline_map
        keeps tidb_tpu_pipeline_depth launches in flight (the sharded
        transfer and the plane program of super-batch k+1 queue while
        k's readback blocks). Each in-flight launch holds its padded
        upload on the operator's DEVICE ledger until its readback, and
        the merged agg state is tracked on the host ledger as it grows.
        Returns the tracked state bytes for the caller to release once
        the results are emitted."""
        _STREAM_STATS["streams"] += 1
        mt_node = memtrack.op_node(self)
        state = {"kernel": None, "inflight": 0}
        try:
            state["kernel"] = get_kernel(
                getattr(self.plan, "_mesh_capacity", DEFAULT_CAPACITY))
        except (ValueError, BuildError):
            state["kernel"] = None      # every batch goes host

        def dispatch(sc):
            batch = sc.chunk
            _STREAM_STATS["batches"] += 1
            _STREAM_STATS["max_batch_rows"] = max(
                _STREAM_STATS["max_batch_rows"], batch.num_rows)
            ctx.stats.superchunks += 1
            k = state["kernel"]
            if k is None:
                # no device kernel for this plan (failed validation or
                # build): every batch aggregates on the host
                self._note_fallback(ctx, "unsupported")
                return None              # host path at finalize
            # device ledger: the sharded padded upload, sized from
            # shapes at dispatch; credited back at finalize
            db = memtrack.device_put_bytes(batch)
            memtrack.consume(self, device=db)
            try:
                outs = k.launch(batch, bucket=True)
            except (ValueError, CollisionError, BuildError) as e:
                memtrack.release(self, device=db)
                self._note_fallback(ctx, _fallback_reason(e))
                return None
            except BaseException:        # quota cancel / device fault
                memtrack.release(self, device=db)
                raise
            if state["inflight"]:
                _STREAM_STATS["overlapped_launches"] += 1
            state["inflight"] += 1
            profiler.note_bytes(profiler.profile_of(k), nbytes=db)
            runtime_stats.note_superchunk(
                self, batch.num_rows, bucket_size(max(batch.num_rows, 1)),
                sc.sources)
            return (k, outs, db)

        def finalize(sc, tok):
            batch = sc.chunk
            if tok is None:
                _STREAM_STATS["host_batches"] += 1
                ctx.stats.host_batches += 1
                return host_batch(batch)
            k, outs, db = tok
            state["inflight"] -= 1
            t0 = time.perf_counter_ns()
            reason = "capacity"
            try:
                gr = k.finish(outs, batch)
                ctx.stats.device_batches += 1
                return gr
            except CapacityError as e:
                # per-batch capacity re-plan: re-run only THIS batch at
                # 2x the observed distinct count; later batches dispatch
                # with the escalated kernel
                profiler.note_escalation(profiler.profile_of(k))
                ctx.stats.escalations += 1
                needed = getattr(e, "needed", None)
                while needed is not None:
                    cap2 = 1 << max(needed * 2 - 1, 1).bit_length()
                    if cap2 > MAX_CAPACITY:
                        break
                    try:
                        k2 = get_kernel(cap2)
                        gr = k2.finish(k2.launch(batch, bucket=True),
                                       batch)
                        state["kernel"] = k2
                        self.plan._mesh_capacity = cap2
                        ctx.stats.device_batches += 1
                        return gr
                    except CapacityError as e2:
                        needed = getattr(e2, "needed", None)
                    except (CollisionError, BuildError, ValueError) as e2:
                        reason = _fallback_reason(e2)
                        break
            except (CollisionError, BuildError, ValueError) as e:
                reason = _fallback_reason(e)
            finally:
                memtrack.release(self, device=db)
                runtime_stats.note_finalize_wait(
                    self, time.perf_counter_ns() - t0)
            _STREAM_STATS["host_batches"] += 1
            ctx.stats.host_batches += 1
            self._note_fallback(ctx, reason)
            return host_batch(batch)

        tracked = 0
        try:
            for gr in op_runtime.pipeline_map(
                    superchunks, dispatch, finalize,
                    sysconf.pipeline_depth(), tracker=mt_node,
                    cost=lambda sc: memtrack.chunk_bytes(sc.chunk),
                    profile=profiler.profile_of(state["kernel"])):
                agg.update(gr)
                tracked = memtrack.track_to(self, agg.approx_bytes(),
                                            tracked)
        except BaseException:
            # the caller's finally releases only what is reported; on an
            # unwinding cancel nothing is reported, so credit here
            memtrack.release(self, host=tracked)
            raise
        return tracked

    @staticmethod
    def _buffer_probe(it, limit):
        """Pull chunks until the probe proves larger than `limit`.
        -> (buffered parts, total rows, exhausted?)."""
        parts, total = [], 0
        for c in it:
            if c.num_rows:
                parts.append(c)
                total += c.num_rows
            if total > limit:
                return parts, total, False
        return parts, total, True

    def _run_whole(self, ctx, mesh, make, run, table, parts):
        """The small-probe path: one whole-table run under a scheduler
        slot, the device ledger and the device section. -> the output
        chunk, or None when the caller must fall back."""
        gr = None
        if table.num_rows:
            try:
                failpoint.eval("device/dispatch")
                with sched.device_slot() as slot, \
                        runtime_stats.device_section(
                            self, errors=False,
                            device=mesh.devices.flat[0]), \
                        memtrack.device_scope(
                            self, memtrack.device_put_bytes(table)):
                    gr = self._run_with_escalation(
                        make, lambda k: run(k, table, slot.chip))
            except failpoint.DispatchTimeoutError:
                raise   # statement already cancel-latched by the watchdog
            except failpoint.DeviceFaultError:
                sched.device_health().note_fault()
                self._note_fallback(ctx, "fault")
                return None
            if gr is None:
                return None
            ctx.stats.superchunks += 1
            ctx.stats.device_batches += 1
            # the whole table went down as ONE maximally coalesced batch
            runtime_stats.note_superchunk(
                self, table.num_rows, bucket_size(max(table.num_rows, 1)),
                max(len(parts), 1))
        return self._emit_results(gr)


class MeshAggExec(_MeshExecBase):
    """Group-by aggregation on the device plane (Q1 shape)."""

    def chunks(self, ctx):
        mesh = devplane.active_mesh()
        if mesh is None:
            yield from self._fallback(ctx)
            return
        plan = self.plan
        it = self._cached_scan(self.child, ctx)
        limit = sysconf.stream_rows()
        parts, _total, exhausted = self._buffer_probe(it, limit)

        def make(capacity):
            return MeshAggKernel(mesh, plan.filter_expr, plan.group_exprs,
                                 plan.aggs, capacity=capacity)

        if not exhausted:
            # probe larger than the streaming threshold: never
            # materialize it; feed the kernel <=limit-row super-batches,
            # dispatch-ahead
            def get_kernel(capacity):
                k = _kernel_cache_get(plan, capacity)
                if k is None:
                    k = make(capacity)
                    _kernel_cache_put(plan, capacity, k)
                return k

            agg = HashAggregator(plan.aggs, plan.group_exprs)
            tracked = 0
            try:
                # plane pipelines overlap async launches, so the device
                # time is the whole streaming region's wall (readback)
                with runtime_stats.device_section(
                        self, device=mesh.devices.flat[0]):
                    tracked = self._stream_groups(
                        ctx, superchunk_batches(
                            itertools.chain(parts, it), limit,
                            tracker=memtrack.op_node(self)),
                        get_kernel,
                        lambda b: host_hash_agg(b, plan.filter_expr,
                                                plan.group_exprs,
                                                plan.aggs),
                        agg)
                yield self._emit_agg(agg)
            finally:
                memtrack.release(self, host=tracked)
            return

        # small probe: the whole-table path, memoized so hot
        # re-executions of a cached plan transfer zero bytes
        big = _concat_chunks_cached(plan, "_probe_cache", parts,
                                    plan.children[0].schema)
        out = self._run_whole(ctx, mesh, make, self._whole_table_run, big,
                              parts)
        if out is None:
            yield from self._fallback(ctx)
            return
        yield out


class MeshLookupAggExec(_MeshExecBase):
    """Star join + aggregation on the device plane (Q3/Q5 shape)."""

    def __init__(self, plan, child, build_readers):
        super().__init__(plan, child)
        self.build_readers = build_readers

    def chunks(self, ctx):
        mesh = devplane.active_mesh()
        if mesh is None:
            yield from self._fallback(ctx)
            return
        plan = self.plan
        try:
            specs = []
            for lk, bexec in zip(plan.lookups, self.build_readers):
                bchunk = _concat_chunks_cached(
                    lk, "_chunk_cache", list(self._cached_scan(bexec, ctx)),
                    lk.build_plan.schema)
                specs.append(LookupSpec(
                    key_exprs=lk.key_exprs, build_chunk=bchunk,
                    build_key_offsets=lk.build_key_offsets,
                    payload_offsets=lk.payload_offsets))
            builds = [self._build_table(d, sp)
                      for d, sp in zip(plan.lookups, specs)]
        except BuildError:
            # non-unique / NULL-heavy dimension keys: host join fallback
            yield from self._fallback(ctx)
            return

        def make(capacity):
            k = MeshLookupAggKernel(mesh, plan.filter_expr, specs,
                                    plan.group_exprs, plan.aggs,
                                    capacity=capacity, builds=builds)
            k.lookups = specs    # freshly built: skip the refresh swap
            return k

        def refresh(kernel):
            if kernel.lookups is not specs:
                # cached kernel: the program depends only on the lookup
                # STRUCTURE; swap in the current tables
                kernel.lookups = specs
                kernel.builds = builds
            return kernel

        it = self._cached_scan(self.child, ctx)
        limit = sysconf.stream_rows()
        parts, _total, exhausted = self._buffer_probe(it, limit)

        if not exhausted:
            # fact side larger than the streaming threshold: feed the
            # lookup-chain kernel in super-batches; the dimension tables
            # stay resident across batches (device-memoized builds)
            def get_kernel(capacity):
                k = _kernel_cache_get(plan, capacity)
                if k is None:
                    k = make(capacity)
                    _kernel_cache_put(plan, capacity, k)
                return refresh(k)

            agg = HashAggregator(plan.aggs, plan.group_exprs)
            tracked = 0
            try:
                with runtime_stats.device_section(
                        self, device=mesh.devices.flat[0]):
                    tracked = self._stream_groups(
                        ctx, superchunk_batches(
                            itertools.chain(parts, it), limit,
                            tracker=memtrack.op_node(self)),
                        get_kernel,
                        lambda b: host_lookup_agg(b, plan.filter_expr,
                                                  specs, plan.group_exprs,
                                                  plan.aggs,
                                                  builds=builds),
                        agg)
                yield self._emit_agg(agg)
            finally:
                memtrack.release(self, host=tracked)
            return

        probe = _concat_chunks_cached(plan, "_probe_cache", parts,
                                      plan.children[0].schema)
        out = self._run_whole(
            ctx, mesh, make,
            lambda k, table, chip: self._whole_table_run(refresh(k), table,
                                                         chip),
            probe, parts)
        if out is None:
            yield from self._fallback(ctx)
            return
        yield out

    @staticmethod
    def _build_table(desc, spec):
        """Host build-table prep memoized on the plan's lookup descriptor:
        when the storage chunk cache serves the same dimension chunk
        object again, the prepared table (and its device copies) is
        reused as it is."""
        cached = getattr(desc, "_build_cache", None)
        if cached is not None and cached[0] is spec.build_chunk:
            return cached[1]
        bt = _BuildTable(spec)
        desc._build_cache = (spec.build_chunk, bt)
        return bt
