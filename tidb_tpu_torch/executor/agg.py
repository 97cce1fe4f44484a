"""The device aggregation drivers: chunks -> superchunks -> kernel ->
merged final rows.

`superchunk_partials` is the port's counterpart of the superchunk
pipeline of the JAX package's HashAggExec (executor/__init__.py): chunks
coalesce into ~tidb_tpu_superchunk_rows batches, tidb_tpu_pipeline_depth
of them are in flight on the device, and each is finalized into a
partial GroupResult. A CapacityError re-plans once with a larger table
(`_escalated_kernel`); a miss that survives it, or a CollisionError, goes
to the caller's miss handler. Two drivers share it:

  * `run_agg` / `run_q1`: a pushed (filter, group-by, aggs) scan
    aggregation, TPC-H Q1's coprocessor path; a miss runs that batch on
    the host, counted as a fallback;
  * `HashAgg`: the root aggregation operator over a child operator (the
    port of HashAggExec); a miss retries per radix partition
    (ops/hybrid.partitioned_agg). Over a plain inner hash join it fuses
    probe and partial agg into one dispatch per probe superchunk
    (ops/fragment.py) unless the join's build takes the hybrid path.

`StreamAgg` is the port of StreamAggExec: rows ordered by the group keys
(a sorted child, or the spill sorter of executor/extsort.py) are
segment-reduced on the device by ops/streamagg.SegmentAggKernel, with no
capacity limit. `agg_algorithm` is the JAX planner's NDV rule between the
two, over a column's ANALYZE statistics.

`run_q1_store` runs Q1 as the JAX package serves it from its store:
lineitem in the mock TiKV store, the TableReader's cop request fanned
out over the regions (store/copr.py, store/stream.py), per-region
partials from the chunk cache and the HBM block cache, merged here.

`run_q3` / `run_q5` run TPC-H Q3 and Q5 through HashAgg, with their host
tails (TopN, Sort) as plain host code; `run_q3_store` / `run_q5_store`
run the same trees over TableReader leaves that read the store through
the coprocessor and the chunk cache; `run_q18_inner` runs Q18's inner
block (ANALYZE, the NDV rule, StreamAgg, the HAVING). Each opens a
memtrack statement root carrying tidb_tpu_mem_quota_query, as a
session does for a statement.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

from tidb_tpu_torch import (config, devplane, memtrack, profiler,
                            runtime_stats, sched)
from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.executor import ExecContext, ExecStats
from tidb_tpu_torch.executor.join import HashJoin
from tidb_tpu_torch.expression import AggFunc
from tidb_tpu_torch.ops import runtime, segsum
from tidb_tpu_torch.ops.fragment import fragment_kernel_for
from tidb_tpu_torch.ops.hashagg import (CapacityError, CollisionError,
                                        DeviceRejectError, HashAggregator,
                                        kernel_for)
from tidb_tpu_torch.ops.hostagg import host_hash_agg, host_scalar_agg
from tidb_tpu_torch.ops.hybrid import escalated_capacity, partitioned_agg
from tidb_tpu_torch.ops.join import host_match_pairs
from tidb_tpu_torch.ops.streamagg import segment_kernel_for
from tidb_tpu_torch.plan.resolver import SchemaCol
from tidb_tpu_torch.sqltypes import np_dtype_for, object_fill

__all__ = ["Q1Result", "QueryResult", "StoreResult", "HashAgg",
           "StreamAgg", "STREAM_AGG_NDV", "agg_algorithm",
           "superchunk_partials", "run_agg", "run_q1", "run_q1_store",
           "run_q3", "run_q5", "run_q3_store", "run_q5_store",
           "run_q18_inner"]


def _host_agg(chunk, filter_expr, group_exprs, aggs):
    if group_exprs:
        return host_hash_agg(chunk, filter_expr, group_exprs, aggs)
    return host_scalar_agg(chunk, filter_expr, aggs)


def _escalated_kernel(e: CapacityError, filter_expr, group_exprs, aggs,
                      device):
    """Re-plan once with a larger device table; None when the overflow is
    hopeless. The growth rule lives in hybrid.escalated_capacity, shared
    with the per-partition chains."""
    cap = escalated_capacity(getattr(e, "needed", 0))
    if cap is None:
        return None
    return kernel_for(filter_expr, group_exprs, aggs, capacity=cap,
                      device=device)


def escalating_pipeline(batches, kernel, dispatch, finalize, escalate,
                        on_miss, stats):
    """The dispatch-ahead pipeline both aggregation paths share, with
    their recovery. dispatch(k, batch) -> token and finalize(k, batch,
    token) -> GroupResult run each batch through the current kernel k; a
    None token (or a ("host", ...) one) is a batch the host serves. A
    CapacityError from finalize re-plans once (escalate(err) -> a kernel,
    or None when the overflow is hopeless), counted in escalations: the
    batch runs again through the new kernel under a scheduler slot, and
    later batches dispatch with it. A miss that survives, or a
    CollisionError, goes to on_miss(batch, token, reason). The kernel's
    profile row (profiler.py) records the dispatches, the escalation and
    the miss."""
    state = {"k": kernel}

    def dispatch_current(batch):
        k = state["k"]
        tok = dispatch(k, batch)
        if tok is None:
            return None
        if isinstance(tok, tuple) and tok and \
                isinstance(tok[0], str) and tok[0] == "host":
            return ("host", k, tok)
        return k, tok

    def finalize_or_recover(batch, tok):
        if tok is None:
            k, token = state["k"], None
        elif isinstance(tok[0], str):
            _h, k, token = tok
        else:
            k, token = tok
        reason = "capacity"
        try:
            return finalize(k, batch, token)
        except CapacityError as e:
            profiler.note_escalation(profiler.profile_of(k))
            k2 = escalate(e)
            if k2 is not None:
                stats.escalations += 1
                state["k"] = k2      # later batches dispatch with it
                with sched.device_slot(profile=profiler.profile_of(k2)):
                    try:
                        return finalize(k2, batch, dispatch(k2, batch))
                    except CapacityError:
                        pass
                    except CollisionError:
                        reason = "collision"
        except CollisionError:
            reason = "collision"
        profiler.note_kernel_fallback(profiler.profile_of(k), reason)
        return on_miss(batch, token, reason)

    return runtime.pipeline_map(batches, dispatch_current,
                                finalize_or_recover, config.pipeline_depth(),
                                profile=profiler.profile_of(kernel))


def superchunk_partials(chunks, filter_expr, group_exprs, aggs,
                        ctx: ExecContext, on_miss, tracker=None, op=None):
    """Coalesced device partial aggregation of `chunks` -> GroupResults in
    order. A batch below tidb_tpu_device_min_rows aggregates on the host
    (designed, counted in host_batches); a capacity miss re-plans once
    and later batches dispatch with the larger kernel; a miss that
    survives, or a collision, goes to on_miss(chunk, reason). `tracker`
    (a memtrack node) bills the superchunk staging; the blocking readback
    of each device batch is `op`'s finalize wait (runtime_stats)."""
    stats = ctx.stats
    group_exprs = list(group_exprs)
    kernel = None
    try:
        kernel = kernel_for(filter_expr, group_exprs, aggs,
                            device=ctx.device)
    except DeviceRejectError:
        # not device-safe BY DESIGN: every batch goes to the host
        stats.note_fallback("unsupported")
    min_rows = config.device_min_rows()

    def dispatch(k, sc):
        if k is None or sc.num_rows < min_rows:
            return None      # host path at finalize
        tok = k.dispatch(sc.chunk)
        profiler.note_bytes(profiler.profile_of(k),
                            nbytes=k.dispatch_nbytes(sc.chunk))
        if op is not None:
            runtime_stats.note_superchunk(op, sc.num_rows, sc.bucket,
                                          sc.sources)
        runtime_stats.note_bytes_touched(memtrack.chunk_bytes(sc.chunk),
                                         memtrack.device_put_bytes(sc.chunk))
        return tok

    def finalize(k, sc, pending):
        if pending is None:
            stats.host_batches += 1
            return _host_agg(sc.chunk, filter_expr, group_exprs, aggs)
        t0 = time.perf_counter_ns()
        try:
            gr = k.finalize(sc.chunk, pending)
        finally:
            if op is not None:
                runtime_stats.note_finalize_wait(
                    op, time.perf_counter_ns() - t0)
        stats.device_batches += 1
        return gr

    def counted(batches):
        for sc in batches:
            stats.superchunks += 1
            yield sc

    return escalating_pipeline(
        counted(runtime.superchunk_batches(chunks, config.superchunk_rows(),
                                           tracker=tracker)),
        kernel, dispatch, finalize,
        lambda e: _escalated_kernel(e, filter_expr, group_exprs, aggs,
                                    ctx.device),
        lambda sc, _pending, reason: on_miss(sc.chunk, reason), stats)


def run_agg(chunks, filter_expr, group_exprs, aggs, device=None,
            superchunk_rows: int | None = None, depth: int | None = None,
            stats: ExecStats | None = None):
    """Aggregate `chunks` (filter, GROUP BY group_exprs, aggs) on `device`
    (CUDA unless the caller asks for another). A batch the device cannot
    serve after one re-plan runs on the host, counted as a fallback.
    -> (HashAggregator results, ExecStats)."""
    ctx = ExecContext(runtime.resolve_device(device),
                      stats=stats if stats is not None else ExecStats())
    group_exprs = list(group_exprs)

    def on_miss(chunk, reason):
        ctx.stats.note_fallback(reason)
        return _host_agg(chunk, filter_expr, group_exprs, aggs)

    overlay = {}
    if superchunk_rows:
        overlay["tidb_tpu_superchunk_rows"] = superchunk_rows
    if depth:
        overlay["tidb_tpu_pipeline_depth"] = depth
    agg = HashAggregator(aggs, group_exprs)
    with config.session_overlay(overlay):
        for gr in superchunk_partials(chunks, filter_expr, group_exprs,
                                      aggs, ctx, on_miss):
            agg.update(gr)
    return agg.results(), ctx.stats


def _empty_agg_value(a):
    return 0 if a.fn == AggFunc.COUNT else None


def _results_chunk(schema, results) -> Chunk:
    """HashAggregator results -> one Chunk over `schema` (group columns
    first): decimals stay scaled ints, strings objects, NULL invalid."""
    rows = [tuple(key) + tuple(vals) for key, vals in results]
    cols = []
    for j, sc in enumerate(schema):
        dtype = np_dtype_for(sc.ft.tp, sc.ft.flen)
        fill = object_fill(sc.ft) if dtype == np.dtype(object) else 0
        vals = [r[j] for r in rows]
        valid = np.array([v is not None for v in vals], dtype=bool)
        data = np.array([fill if v is None else v for v in vals],
                        dtype=dtype)
        cols.append(Column(sc.ft, data, valid))
    return Chunk(cols)


class HashAgg:
    """Root-side complete aggregation over a child operator's chunks,
    GROUP BY `group_exprs` (over the child's schema), computing `aggs`.
    `chunks(ctx)` yields one Chunk: the group columns, then one column
    per aggregate."""

    def __init__(self, child, group_exprs, aggs, plan=None):
        self.child = child
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self.schema = _agg_schema(self.group_exprs, self.aggs)
        # the plan node the per-chunk kernel lives on (None for the
        # hand-built drivers, which make no plans)
        self.plan = plan
        self._kernel = getattr(plan, "_root_kernel", None)

    def chunks(self, ctx):
        agg = HashAggregator(self.aggs, self.group_exprs)
        tracked = 0
        try:
            if not all(not a.distinct for a in self.aggs) or \
                    not config.device_enabled():
                # DISTINCT aggregates run on the host by design, and
                # everything does with tidb_tpu_device = 0
                source = (host_hash_agg(chunk, None, self.group_exprs,
                                        self.aggs)
                          for chunk in self.child.chunks(ctx)
                          if chunk.num_rows)
            elif not config.superchunk_rows():
                source = self._per_chunk_partials(ctx)
            else:
                frag = self._fragment_kernel(ctx)
                source = self._fused_partials(ctx, frag) \
                    if frag is not None else \
                    self._superchunk_partials(ctx, self.child.chunks(ctx))
            for gr in source:
                agg.update(gr)
                # the merged state grows with the group count: billed
                tracked = memtrack.track_to(self, agg.approx_bytes(),
                                            tracked)
            results = agg.results()
            if not self.group_exprs and not results:
                results = [((), [_empty_agg_value(a) for a in self.aggs])]
            yield _results_chunk(self.schema, results)
        finally:
            memtrack.release(self, host=tracked)

    def _per_chunk_partials(self, ctx):
        """Superchunk coalescing off (tidb_tpu_superchunk_rows = 0): each
        child chunk of at least tidb_tpu_device_min_rows rows is one
        synchronous device partial aggregate, the rest (and a plan that
        is not device-safe) aggregate on the host."""
        stats = ctx.stats
        min_rows = config.device_min_rows()
        for chunk in self.child.chunks(ctx):
            if chunk.num_rows == 0:
                continue
            stats.superchunks += 1
            gr = None
            if chunk.num_rows >= min_rows:
                gr = self._device_partial(ctx, chunk)
            if gr is None:
                stats.host_batches += 1
                gr = host_hash_agg(chunk, None, self.group_exprs, self.aggs)
            else:
                stats.device_batches += 1
            yield gr

    def _set_kernel(self, kernel) -> None:
        self._kernel = kernel
        # kernels live on the plan object: the plan cache shares plans
        # across executions (and an Apply re-runs its inner plan per
        # outer row), so the kernel outlives any one operator tree
        if self.plan is not None:
            self.plan._root_kernel = kernel

    def _escalated_kernel(self, ctx, e: CapacityError):
        cap = escalated_capacity(getattr(e, "needed", 0))
        if cap is None:
            return None
        try:
            k = kernel_for(None, self.group_exprs, self.aggs, capacity=cap,
                           device=ctx.device)
        except ValueError:
            return None
        self._set_kernel(k)
        return k

    def _device_call(self, ctx, k, chunk):
        nb = k.dispatch_nbytes(chunk)
        with sched.device_slot(), memtrack.device_scope(self, nb), \
                profiler.dispatch_section(profiler.profile_of(k),
                                          nbytes=nb, plan=self):
            gr = runtime_stats.device_call(self, k, chunk,
                                           device=ctx.device)
        runtime_stats.note_mode(self, "hash")
        return gr

    def _device_partial(self, ctx, chunk):
        """One chunk's device partial aggregate. A capacity miss re-plans
        once with a bigger table; a miss that survives (or a collision)
        radix-partitions the chunk and retries per partition
        (ops/hybrid.partitioned_agg). None only for a plan that is not
        device-safe by design: the caller's host path, counted as an
        "unsupported" fallback."""
        try:
            if self._kernel is None:
                self._set_kernel(kernel_for(None, self.group_exprs,
                                            self.aggs, device=ctx.device))
            return self._device_call(ctx, self._kernel, chunk)
        except CapacityError as e:
            reason = "capacity"
            profiler.note_escalation(profiler.profile_of(self._kernel))
            k = self._escalated_kernel(ctx, e)
            if k is not None:
                try:
                    return self._device_call(ctx, k, chunk)
                except CapacityError:
                    pass
                except CollisionError:
                    reason = "collision"
                except (DeviceRejectError, NotImplementedError):
                    ctx.stats.note_fallback("unsupported")
                    runtime_stats.note_fallback(self, "unsupported")
                    return None
            runtime_stats.note_mode(self, "hybrid")
            return partitioned_agg(chunk, None, self.group_exprs, self.aggs,
                                   ctx.stats, reason=reason,
                                   device=ctx.device)
        except CollisionError:
            runtime_stats.note_mode(self, "hybrid")
            return partitioned_agg(chunk, None, self.group_exprs, self.aggs,
                                   ctx.stats, reason="collision",
                                   device=ctx.device)
        except (DeviceRejectError, NotImplementedError):
            ctx.stats.note_fallback("unsupported")
            runtime_stats.note_fallback(self, "unsupported")
        return None

    def _fragment_kernel(self, ctx):
        """A ProbeAggKernel when this agg can fuse with its child join
        into one dispatch per probe superchunk, else None: fusion needs a
        plain single-device inner hash join (no other_cond) and a
        device-safe group/agg set over the joined schema."""
        if not config.fuse_fragments_enabled():
            return None
        join = self.child
        if type(join) is not HashJoin:
            return None
        if join.join_type != "inner" or join.other_cond is not None \
                or not join.left_keys:
            return None
        if devplane.ndev() > 1:
            return None     # the plane's shuffle owns multi-shard joins
        nl = len(join.left.schema)
        width = nl + len(join.right.schema)
        try:
            return fragment_kernel_for(len(join.left_keys), nl, width,
                                       self.group_exprs, self.aggs,
                                       device=ctx.device)
        except (DeviceRejectError, NotImplementedError, ValueError):
            return None

    def _fused_partials(self, ctx, fk):
        """Partial GroupResults from the fused probe -> agg fragment: the
        build side uploads once (used columns + key lanes), probe
        superchunks stream through the dispatch-ahead pipeline, and each
        in-flight token is one whole-fragment dispatch. A capacity miss
        escalates the fragment kernel once (later batches inherit it); a
        miss that survives, or a collision, falls back to the decoded
        per-batch path (host pair match + gather + host agg), counted.
        A build the hybrid join should carry (skew, or over a superchunk)
        runs the per-operator path instead."""
        stats = ctx.stats
        join = self.child
        nl = len(join.left.schema)
        width = nl + len(join.right.schema)
        build = Chunk.concat_all(list(join.right.chunks(ctx)))
        nb = build.num_rows if build is not None else 0
        if nb == 0:
            return      # inner join over an empty build: no input rows
        tracked = memtrack.track_to(self, memtrack.chunk_bytes(build))
        enc, bk, raw_bk = join._fit_build(build)
        engage, hot, h = join._hybrid_engage(bk, nb, raw_bk)
        if engage:
            # the keys, hashes and hot set just computed ride along
            try:
                yield from self._superchunk_partials(ctx, join._probe_join(
                    ctx, build, nb, prepared=(enc, bk, hot, h)))
            finally:
                memtrack.release(self, host=tracked)
            return
        stats.join_paths[join.build_label()] = "fused"
        build_dev = None
        min_rows = config.device_min_rows()

        def decoded_batch(pk, chunk):
            li, ri = host_match_pairs(bk, pk, nb, chunk.num_rows)
            return host_hash_agg(join._gather(chunk, build, li, ri), None,
                                 self.group_exprs, self.aggs)

        def dispatch(k, sc):
            nonlocal build_dev
            n = sc.num_rows
            pk = join._probe_keys(enc, sc.chunk)
            if n < min_rows and nb < join._DEVICE_MIN_BUILD:
                return ("host", pk)
            if build_dev is None:
                # build lanes stay device-resident for the whole probe
                build_dev = k.prepare_build(build, bk, nb)
            stats.fused_dispatches += 1
            tok = k.dispatch(build_dev, nb, pk, sc.chunk, n)
            # the probe superchunk's padded upload: the kernel has no
            # scratch sizing of its own yet
            profiler.note_bytes(profiler.profile_of(k),
                                nbytes=memtrack.device_put_bytes(sc.chunk))
            runtime_stats.note_superchunk(self, n, sc.bucket, sc.sources)
            runtime_stats.note_bytes_touched(memtrack.chunk_bytes(sc.chunk),
                                             k.input_nbytes(sc.chunk))
            return pk, tok

        def finalize(k, sc, tok):
            if isinstance(tok[0], str):
                stats.host_batches += 1
                return decoded_batch(tok[1], sc.chunk)
            pk, pend = tok
            t0 = time.perf_counter_ns()
            try:
                return k.finalize(sc.chunk, build, nb, pend)
            finally:
                runtime_stats.note_finalize_wait(
                    self, time.perf_counter_ns() - t0)

        def on_miss(sc, tok, reason):
            stats.note_fallback(reason)
            return decoded_batch(tok[0], sc.chunk)

        try:
            yield from escalating_pipeline(
                runtime.superchunk_batches(join.left.chunks(ctx),
                                           config.superchunk_rows(),
                                           tracker=memtrack.op_node(self)),
                fk, dispatch, finalize,
                lambda e: self._escalated_fragment(ctx, e, nl, width),
                on_miss, stats)
        finally:
            memtrack.release(self, host=tracked)

    def _escalated_fragment(self, ctx, e: CapacityError, nl: int,
                            width: int):
        """Fragment-kernel re-plan after a group-capacity miss; None when
        the overflow is hopeless (the decoded per-batch fallback then
        owns the batch)."""
        cap = escalated_capacity(getattr(e, "needed", 0))
        if cap is None:
            return None
        try:
            return fragment_kernel_for(len(self.child.left_keys), nl, width,
                                       self.group_exprs, self.aggs,
                                       capacity=cap, device=ctx.device)
        except (DeviceRejectError, NotImplementedError, ValueError):
            return None

    def _superchunk_partials(self, ctx, chunks):
        """Coalesced device partial aggregation of the child's chunks; a
        miss that survived the re-plan retries per radix partition
        instead of abandoning the device."""
        def on_miss(chunk, reason):
            return partitioned_agg(chunk, None, self.group_exprs, self.aggs,
                                   ctx.stats, reason=reason,
                                   device=ctx.device)
        return superchunk_partials(chunks, None, self.group_exprs,
                                   self.aggs, ctx, on_miss,
                                   tracker=memtrack.op_node(self), op=self)


def _agg_schema(group_exprs, aggs):
    return [SchemaCol(getattr(g, "name", "") or f"_g{i}", "", g.ft)
            for i, g in enumerate(group_exprs)] + \
        [SchemaCol(a.name or f"_a{i}", "", a.result_ft)
         for i, a in enumerate(aggs)]


class StreamAgg:
    """Sort-based aggregation: the port of StreamAggExec. Rows are
    ordered by the group keys, then segment-reduced on the device
    (ops/streamagg.py) with no capacity limit (num_segments = the padded
    rows of a superchunk), so arbitrarily many groups never overflow a
    device table. `chunks(ctx)` yields one Chunk: the group columns,
    then one column per aggregate.

    `sorted_input` streams the child's chunks as they come (they must
    hold equal keys adjacent); otherwise the input goes through the
    spill sorter, whose run size is tidb_tpu_sort_spill_rows, and which
    sheds its buffer to disk under the statement's quota instead of
    cancelling it. A group that spans two superchunks merges itself in
    the HashAggregator."""

    _SLICE = 1 << 17     # rows per device dispatch without superchunks

    def __init__(self, child, group_exprs, aggs, sorted_input: bool = False):
        self.child = child
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self.sorted_input = sorted_input
        self.schema = _agg_schema(self.group_exprs, self.aggs)
        self._kernel = None

    def _parts(self, ctx, slice_rows: int):
        """Key-ordered ~slice_rows superchunks: key adjacency survives
        coalescing because both sources yield key-ordered chunks."""
        mt_node = memtrack.op_node(self)
        if self.sorted_input:
            yield from runtime.superchunk_batches(self.child.chunks(ctx),
                                                  slice_rows,
                                                  tracker=mt_node)
            return
        from tidb_tpu_torch.executor.extsort import SpillSorter
        by = [(g, False) for g in self.group_exprs]
        sorter = SpillSorter(by, run_rows=config.sort_spill_rows(),
                             block_rows=slice_rows, tracker=mt_node)
        try:
            for chunk in self.child.chunks(ctx):
                sorter.add(chunk)
            yield from runtime.superchunk_batches(sorter.sorted_chunks(),
                                                  slice_rows,
                                                  tracker=mt_node)
        finally:
            ctx.stats.sort_spilled_runs += sorter.spilled_runs
            sorter.close()

    def chunks(self, ctx):
        device = runtime.resolve_device(ctx.device)
        stats = ctx.stats
        agg = HashAggregator(self.aggs, self.group_exprs)
        use_device = config.device_enabled() and \
            all(not a.distinct for a in self.aggs)
        slice_rows = config.superchunk_rows() or self._SLICE
        parts = self._parts(ctx, slice_rows)
        tracked = 0
        try:
            if use_device and config.superchunk_rows():
                source = self._pipelined_segments(ctx, device, parts)
            else:
                source = (self._feed(ctx, device, sc.chunk, use_device)
                          for sc in parts)
            for gr in source:
                agg.update(gr)
                tracked = memtrack.track_to(self, agg.approx_bytes(),
                                            tracked)
            results = agg.results()
            if not self.group_exprs and not results:
                results = [((), [_empty_agg_value(a) for a in self.aggs])]
            yield _results_chunk(self.schema, results)
        finally:
            memtrack.release(self, host=tracked)

    def _kernel_for(self, ctx, device):
        """The segment kernel, made on first use; None (counted as an
        "unsupported" fallback) when the plan is not device-safe."""
        if self._kernel is None:
            try:
                self._kernel = segment_kernel_for(self.group_exprs,
                                                  self.aggs, device=device)
            except (DeviceRejectError, NotImplementedError):
                ctx.stats.note_fallback("unsupported")
        return self._kernel

    def _host_part(self, ctx, part):
        ctx.stats.host_batches += 1
        return host_hash_agg(part, None, self.group_exprs, self.aggs)

    def _feed(self, ctx, device, part, use_device: bool):
        """One part, synchronously (tidb_tpu_superchunk_rows = 0)."""
        ctx.stats.superchunks += 1
        k = self._kernel_for(ctx, device) if use_device else None
        if k is None or part.num_rows < config.device_min_rows():
            return self._host_part(ctx, part)
        nb = k.dispatch_nbytes(part)
        with sched.device_slot(), memtrack.device_scope(self, nb), \
                profiler.dispatch_section(profiler.profile_of(k),
                                          nbytes=nb):
            gr = k(part)
        ctx.stats.device_batches += 1
        return gr

    def _pipelined_segments(self, ctx, device, parts):
        """Segment-reduce each superchunk through the dispatch-ahead
        pipeline: one whole-superchunk segment reduction per batch, the
        next batch padded and transferred while this one runs. A batch
        below tidb_tpu_device_min_rows aggregates on the host."""
        stats = ctx.stats
        min_rows = config.device_min_rows()
        self._kernel_for(ctx, device)

        def dispatch(sc):
            stats.superchunks += 1
            k = self._kernel
            if k is None or sc.num_rows < min_rows:
                return None
            db = k.dispatch_nbytes(sc.chunk)
            memtrack.consume(self, device=db)
            try:
                tok = k, k.dispatch(sc.chunk), db
            except BaseException:
                memtrack.release(self, device=db)
                raise
            profiler.note_bytes(profiler.profile_of(k), nbytes=db)
            runtime_stats.note_superchunk(self, sc.num_rows, sc.bucket,
                                          sc.sources)
            runtime_stats.note_bytes_touched(memtrack.chunk_bytes(sc.chunk),
                                             memtrack.device_put_bytes(sc.chunk))
            return tok

        def finalize(sc, tok):
            if tok is None:
                return self._host_part(ctx, sc.chunk)
            k, pending, db = tok
            t0 = time.perf_counter_ns()
            try:
                gr = k.finalize(sc.chunk, pending)
            finally:
                memtrack.release(self, device=db)
                runtime_stats.note_finalize_wait(
                    self, time.perf_counter_ns() - t0)
            stats.device_batches += 1
            return gr

        return runtime.pipeline_map(
            parts, dispatch, finalize, config.pipeline_depth(),
            tracker=memtrack.op_node(self),
            cost=lambda sc: memtrack.chunk_bytes(sc.chunk),
            profile=profiler.profile_of(self._kernel))


# beyond this many estimated groups the sort-based StreamAgg beats the
# hash kernel's capacity-escalation and collision-fallback protocol (the
# JAX planner's _STREAM_AGG_NDV)
STREAM_AGG_NDV = 1 << 16


def agg_algorithm(group_stats, aggs=()) -> str:
    """The JAX planner's choice for a grouped aggregation
    (plan/planner._choose_agg_algorithm), the port's stand-in until the
    planner is ported: "stream" when the largest NDV among the bare
    group columns' ANALYZE statistics exceeds STREAM_AGG_NDV, else
    "hash". `group_stats` holds one ColumnStats per group expression
    (None where the column cannot be traced to statistics); no group
    columns, a DISTINCT aggregate or no statistics at all keep the hash
    agg."""
    if not group_stats or any(a.distinct for a in aggs):
        return "hash"
    ndvs = [cs.hist.ndv for cs in group_stats if cs is not None]
    if ndvs and max(ndvs) > STREAM_AGG_NDV:
        return "stream"
    return "hash"


@dataclass
class Q1Result:
    rows: list          # (returnflag, linestatus, 8 aggregate values)
    stats: ExecStats
    seconds: float      # host clock, chunks in hand to rows merged
    chunks: list = field(repr=False, default_factory=list)


def run_q1(sf: float = 10.0, seed: int = 42, device=None, chunks=None,
           superchunk_rows: int | None = None) -> Q1Result:
    """TPC-H Q1's partial + final aggregation over lineitem at scale
    factor `sf` on `device`. Pass the `chunks` of an earlier result to
    run again over the same (device-memoized) data. Decimal sums and
    averages come back as scaled ints: frac 2, 4 and 6 for the sums,
    6 for the averages, as the JAX package's HashAggregator gives them."""
    from tidb_tpu_torch.benchmarks import tpch
    device = runtime.resolve_device(device)
    if chunks is None:
        chunks = tpch.lineitem_chunks(tpch.ScaledTpch(sf, seed),
                                      superchunk_rows or
                                      config.superchunk_rows())
    flt, group_exprs, aggs = tpch.q1_plan()
    t0 = time.perf_counter()
    results, stats = run_agg(chunks, flt, group_exprs, aggs, device=device,
                             superchunk_rows=superchunk_rows)
    seconds = time.perf_counter() - t0
    rows = [tuple(key) + tuple(vals) for key, vals in results]
    return Q1Result(rows=rows, stats=stats, seconds=seconds, chunks=chunks)


@dataclass
class StoreResult:
    rows: list          # Q1's rows, as run_q1 gives them
    stats: ExecStats
    seconds: float      # host clock, request sent to rows merged
    storage: object = field(repr=False, default=None)
    partials: list = field(repr=False, default_factory=list)


def run_q1_store(sf: float = 1.0, seed: int = 42, device=None,
                 storage=None, lineitem=None) -> StoreResult:
    """TPC-H Q1 served from the mock TiKV store on `device` (CUDA unless
    the caller asks for another): a TableReader's cop request over
    lineitem's regions at a fresh snapshot, each region's partial
    aggregate from the coprocessor (streamed by default, cached on the
    host and on the device once warm, patched under writes), merged with
    HashAggregator as run_q1 merges its superchunks. Without `storage`
    a store is made on `device` and ScaledTpch(sf, seed) bulk-loaded
    into it (lineitem and orders in 4 regions each); pass the `storage`
    of an earlier result to run again over the same store, and with it
    `lineitem`, the TableInfo to read, where the store was loaded
    through a Session (the one CREATE TABLE made; by default the
    hand-built `tpch.table_infos()`'s). The run is one statement: a
    memtrack root and a runtime-stats collector."""
    from tidb_tpu_torch import runtime_stats
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.executor.reader import TableReader
    storage = _store_of(sf, seed, device, storage)
    cop = tpch.q1_cop_plan(lineitem or tpch.table_infos()["lineitem"])
    ctx = ExecContext(storage.device, storage=storage,
                      read_ts=storage.current_ts())
    coll = runtime_stats.StatsCollector()
    agg = HashAggregator(cop.aggs, cop.group_exprs)
    partials = []
    t0 = time.perf_counter()
    with _statement(ctx.stats), runtime_stats.collecting(coll):
        for gr in TableReader(cop).partials(ctx):
            partials.append(gr)
            agg.update(gr)
    rows = [tuple(key) + tuple(vals) for key, vals in agg.results()]
    seconds = time.perf_counter() - t0
    st = coll.get(cop)
    if st is not None:
        for reason, n in st.fallback_reasons.items():
            ctx.stats.fallback_reasons[reason] = n
    return StoreResult(rows=rows, stats=ctx.stats, seconds=seconds,
                       storage=storage, partials=partials)


@dataclass
class QueryResult:
    rows: list
    stats: ExecStats
    seconds: float      # host clock, tables in hand to final rows
    tables: dict = field(repr=False, default_factory=dict)
    groups: list = field(repr=False, default_factory=list)  # before the tail
    storage: object = field(repr=False, default=None)   # store runs


def _chunk_rows(chunk: Chunk) -> list[tuple]:
    """Rows of a result chunk as Python values (None for NULL; decimals as
    scaled ints, dates as epoch micros)."""
    cols = [[(x.item() if isinstance(x, np.generic) else x) if ok else None
             for x, ok in zip(c.data, c.valid)] for c in chunk.columns]
    return list(zip(*cols))


@contextlib.contextmanager
def _statement(stats: ExecStats):
    """A run as one statement: a memtrack statement root carrying
    tidb_tpu_mem_quota_query, installed on this thread as a session does,
    with the segment-sum kernel's launches read around it. On exit the
    launches, the ledger's peak, what it still holds (0 after a clean
    run) and whether a device fault degraded the statement to the host
    path (sched.degrade_statement) go to `stats`, and the root
    detaches."""
    root = memtrack.statement_root(None, quota=config.mem_quota_query())
    launches = segsum.launches
    try:
        with memtrack.tracking(root):
            yield root
    finally:
        stats.segsum_launches += segsum.launches - launches
        if root.total_peak > stats.mem_peak:
            stats.mem_peak = root.total_peak
            stats.mem_device_at_peak = root.device_at_peak
        stats.mem_left = root.total()
        stats.fault_degraded = root.fault_degraded
        root.detach()


def _run_query(name: str, sf: float, seed: int, device, tables,
               superchunk_rows) -> QueryResult:
    from tidb_tpu_torch.benchmarks import tpch
    device = runtime.resolve_device(device)
    if tables is None:
        tables = tpch.table_chunks(tpch.ScaledTpch(sf, seed),
                                   tpch.QUERY_TABLES[name])
    plan, finish = tpch.PLANS[name]
    overlay = {} if superchunk_rows is None else \
        {"tidb_tpu_superchunk_rows": superchunk_rows}
    ctx = ExecContext(device, tables)
    with config.session_overlay(overlay):
        t0 = time.perf_counter()
        with _statement(ctx.stats):
            (chunk,) = plan().chunks(ctx)
        groups = _chunk_rows(chunk)
        rows = finish(groups)
        seconds = time.perf_counter() - t0
    return QueryResult(rows=rows, stats=ctx.stats, seconds=seconds,
                       tables=tables, groups=groups)


def run_q3(sf: float = 10.0, seed: int = 42, device=None, tables=None,
           superchunk_rows: int | None = None) -> QueryResult:
    """TPC-H Q3 at scale factor `sf` on `device`: rows (l_orderkey,
    revenue as a scaled int at frac 4, o_orderdate in epoch micros,
    o_shippriority), the top 10 by revenue. Pass the `tables` of an
    earlier result to run again over the same data."""
    return _run_query("q3", sf, seed, device, tables, superchunk_rows)


def run_q5(sf: float = 10.0, seed: int = 42, device=None, tables=None,
           superchunk_rows: int | None = None) -> QueryResult:
    """TPC-H Q5 at scale factor `sf` on `device`: rows (n_name, revenue
    as a scaled int at frac 4), by revenue descending."""
    return _run_query("q5", sf, seed, device, tables, superchunk_rows)


def _store_of(sf: float, seed: int, device, storage):
    """`storage` (checked against `device`), or a new mock store on
    `device` with ScaledTpch(sf, seed) bulk-loaded into it (lineitem and
    orders in 4 regions each)."""
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.store.storage import new_mock_storage
    if storage is None:
        storage = new_mock_storage(device=device)
        tpch.load_store(storage, tpch.ScaledTpch(sf, seed))
    elif device is not None and \
            runtime.resolve_device(device) != storage.device:
        raise ValueError(f"the storage runs on {storage.device}, "
                         f"not {device}")
    return storage


def _run_store_query(name: str, sf: float, seed: int, device,
                     storage, infos=None) -> QueryResult:
    """Q3 or Q5 over the store as one statement: the plan's TableReader
    leaves send their selection CopPlans at one snapshot, and HashJoin /
    HashAgg run above them as over chunks in hand."""
    from tidb_tpu_torch import runtime_stats
    from tidb_tpu_torch.benchmarks import tpch
    storage = _store_of(sf, seed, device, storage)
    build, finish = tpch.STORE_PLANS[name]
    plan = build(infos or tpch.table_infos())
    ctx = ExecContext(storage.device, storage=storage,
                      read_ts=storage.current_ts())
    coll = runtime_stats.StatsCollector()
    t0 = time.perf_counter()
    with _statement(ctx.stats), runtime_stats.collecting(coll):
        (chunk,) = plan.chunks(ctx)
    groups = _chunk_rows(chunk)
    rows = finish(groups)
    seconds = time.perf_counter() - t0
    for st in coll.ops():
        for reason, n in st.fallback_reasons.items():
            ctx.stats.fallback_reasons[reason] = \
                ctx.stats.fallback_reasons.get(reason, 0) + n
    return QueryResult(rows=rows, stats=ctx.stats, seconds=seconds,
                       groups=groups, storage=storage)


def run_q3_store(sf: float = 1.0, seed: int = 42, device=None,
                 storage=None, infos=None) -> QueryResult:
    """TPC-H Q3 served from the mock TiKV store on `device` (CUDA unless
    the caller asks for another): customer, orders and lineitem read by
    TableReaders through the coprocessor (streamed by default, from the
    chunk cache once warm), joined and aggregated as run_q3 does, then
    its TopN. Without `storage` a store is made and ScaledTpch(sf, seed)
    loaded into it; pass the `storage` of an earlier result to run again
    over the same store, and with it `infos` ({table: TableInfo}) where
    the store was loaded through a Session (the TableInfos CREATE TABLE
    made; by default the hand-built `tpch.table_infos()`). -> QueryResult
    with `groups` (every HashAgg group before the TopN) and `rows` in
    run_q3's layout."""
    return _run_store_query("q3", sf, seed, device, storage, infos)


def run_q5_store(sf: float = 1.0, seed: int = 42, device=None,
                 storage=None, infos=None) -> QueryResult:
    """TPC-H Q5 served from the mock TiKV store on `device`: the six
    tables read by TableReaders, as run_q3_store reads Q3's."""
    return _run_store_query("q5", sf, seed, device, storage, infos)


def run_q18_inner(sf: float = 10.0, seed: int = 42, device=None,
                  tables=None, superchunk_rows: int | None = None,
                  group_stats=None) -> QueryResult:
    """TPC-H Q18's inner block, `SELECT l_orderkey FROM lineitem GROUP BY
    l_orderkey HAVING SUM(l_quantity) > 300`, at scale factor `sf` on
    `device`, as the JAX package runs it after ANALYZE: l_orderkey's
    statistics (built on `device`, or `group_stats` = [ColumnStats] from
    an earlier ANALYZE), the planner's NDV rule (`agg_algorithm`), then
    StreamAgg over the lineitem scan (or the hash agg below the rule's
    threshold), then the HAVING on the host.

    -> QueryResult: rows (l_orderkey,) in key order; `groups` the
    aggregation's every group before the HAVING as two numpy arrays
    (l_orderkey, SUM(l_quantity) as a scaled int at frac 2); `stats`
    with the algorithm chosen, the sorter's spilled runs, the
    segment-sum launches, fallbacks and the ledger's peak. `seconds`
    covers the query, not the ANALYZE."""
    from tidb_tpu_torch.benchmarks import tpch
    device = runtime.resolve_device(device)
    if tables is None:
        tables = tpch.table_chunks(tpch.ScaledTpch(sf, seed), ["lineitem"])
    if group_stats is None:
        group_stats = [tpch.analyze_columns(
            None, ["l_orderkey"], device,
            chunks=tables["lineitem"])["l_orderkey"]]
    overlay = {} if superchunk_rows is None else \
        {"tidb_tpu_superchunk_rows": superchunk_rows}
    ctx = ExecContext(device, tables)
    with config.session_overlay(overlay):
        t0 = time.perf_counter()
        agg_op, having = tpch.q18_inner_plan()
        ctx.stats.agg_algorithm = agg_algorithm(group_stats, agg_op.aggs)
        if ctx.stats.agg_algorithm == "hash":
            agg_op = HashAgg(agg_op.child, agg_op.group_exprs, agg_op.aggs)
        with _statement(ctx.stats):
            (chunk,) = agg_op.chunks(ctx)
        keep = runtime.eval_filter_host(having, chunk)
        rows = [(int(k),) for k in chunk.columns[0].data[keep]]
        seconds = time.perf_counter() - t0
    groups = [chunk.columns[0].data, chunk.columns[1].data]
    return QueryResult(rows=rows, stats=ctx.stats, seconds=seconds,
                       tables=tables, groups=groups)
