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

`run_q3` / `run_q5` run TPC-H Q3 and Q5 through HashAgg, with their host
tails (TopN, Sort) as plain host code.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from tidb_tpu_torch import config
from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.executor import ExecContext, ExecStats
from tidb_tpu_torch.executor.join import HashJoin
from tidb_tpu_torch.executor.scan import SchemaCol
from tidb_tpu_torch.expression import AggFunc
from tidb_tpu_torch.ops import runtime
from tidb_tpu_torch.ops.fragment import fragment_kernel_for
from tidb_tpu_torch.ops.hashagg import (CapacityError, CollisionError,
                                        DeviceRejectError, HashAggregator,
                                        kernel_for)
from tidb_tpu_torch.ops.hostagg import host_hash_agg, host_scalar_agg
from tidb_tpu_torch.ops.hybrid import escalated_capacity, partitioned_agg
from tidb_tpu_torch.ops.join import host_match_pairs
from tidb_tpu_torch.sqltypes import np_dtype_for, object_fill

__all__ = ["Q1Result", "QueryResult", "HashAgg", "superchunk_partials",
           "run_agg", "run_q1", "run_q3", "run_q5"]


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
    token) -> GroupResult run each batch through the current kernel k. A
    CapacityError from finalize re-plans once (escalate(err) -> a kernel,
    or None when the overflow is hopeless), counted in escalations: the
    batch runs again through the new kernel and later batches dispatch
    with it. A miss that survives, or a CollisionError, goes to
    on_miss(batch, token, reason)."""
    state = {"k": kernel}

    def dispatch_current(batch):
        k = state["k"]
        return k, dispatch(k, batch)

    def finalize_or_recover(batch, tok):
        k, token = tok
        reason = "capacity"
        try:
            return finalize(k, batch, token)
        except CapacityError as e:
            k2 = escalate(e)
            if k2 is not None:
                stats.escalations += 1
                state["k"] = k2      # later batches dispatch with it
                try:
                    return finalize(k2, batch, dispatch(k2, batch))
                except CapacityError:
                    pass
                except CollisionError:
                    reason = "collision"
        except CollisionError:
            reason = "collision"
        return on_miss(batch, token, reason)

    return runtime.pipeline_map(batches, dispatch_current,
                                finalize_or_recover, config.pipeline_depth())


def superchunk_partials(chunks, filter_expr, group_exprs, aggs,
                        ctx: ExecContext, on_miss):
    """Coalesced device partial aggregation of `chunks` -> GroupResults in
    order. A batch below tidb_tpu_device_min_rows aggregates on the host
    (designed, counted in host_batches); a capacity miss re-plans once
    and later batches dispatch with the larger kernel; a miss that
    survives, or a collision, goes to on_miss(chunk, reason)."""
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

    def dispatch(k, chunk):
        if k is None or chunk.num_rows < min_rows:
            return None      # host path at finalize
        return k.dispatch(chunk)

    def finalize(k, chunk, pending):
        if pending is None:
            stats.host_batches += 1
            return _host_agg(chunk, filter_expr, group_exprs, aggs)
        gr = k.finalize(chunk, pending)
        stats.device_batches += 1
        return gr

    def counted(batches):
        for chunk in batches:
            stats.superchunks += 1
            yield chunk

    return escalating_pipeline(
        counted(runtime.superchunk_batches(chunks, config.superchunk_rows())),
        kernel, dispatch, finalize,
        lambda e: _escalated_kernel(e, filter_expr, group_exprs, aggs,
                                    ctx.device),
        lambda chunk, _pending, reason: on_miss(chunk, reason), stats)


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

    def __init__(self, child, group_exprs, aggs):
        self.child = child
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self.schema = [SchemaCol("", getattr(g, "name", "") or f"_g{i}",
                                 g.ft)
                       for i, g in enumerate(self.group_exprs)] + \
            [SchemaCol("", a.name or f"_a{i}", a.result_ft)
             for i, a in enumerate(self.aggs)]

    def chunks(self, ctx):
        agg = HashAggregator(self.aggs, self.group_exprs)
        if not all(not a.distinct for a in self.aggs):
            # DISTINCT aggregates run on the host by design
            for chunk in self.child.chunks(ctx):
                if chunk.num_rows:
                    agg.update(host_hash_agg(chunk, None, self.group_exprs,
                                             self.aggs))
        elif not config.superchunk_rows():
            raise NotImplementedError(
                "per-chunk device aggregation (tidb_tpu_superchunk_rows "
                "= 0) is not ported yet")
        else:
            frag = self._fragment_kernel(ctx)
            source = self._fused_partials(ctx, frag) if frag is not None \
                else self._superchunk_partials(ctx, self.child.chunks(ctx))
            for gr in source:
                agg.update(gr)
        results = agg.results()
        if not self.group_exprs and not results:
            results = [((), [_empty_agg_value(a) for a in self.aggs])]
        yield _results_chunk(self.schema, results)

    def _fragment_kernel(self, ctx):
        """A ProbeAggKernel when this agg can fuse with its child join
        into one dispatch per probe superchunk, else None: fusion needs a
        plain inner hash join (no other_cond) and a device-safe
        group/agg set over the joined schema."""
        if not config.fuse_fragments_enabled():
            return None
        join = self.child
        if type(join) is not HashJoin:
            return None
        if join.join_type != "inner" or join.other_cond is not None \
                or not join.left_keys:
            return None
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
        enc, bk = join._fit_build(build)
        engage, hot, h = join._hybrid_engage(bk, nb)
        if engage:
            # the keys, hashes and hot set just computed ride along
            yield from self._superchunk_partials(ctx, join._probe_join(
                ctx, build, nb, prepared=(enc, bk, hot, h)))
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
            pk = join._probe_keys(enc, sc)
            if n < min_rows and nb < join._DEVICE_MIN_BUILD:
                return pk, None
            if build_dev is None:
                # build lanes stay device-resident for the whole probe
                build_dev = k.prepare_build(build, bk, nb)
            stats.fused_dispatches += 1
            return pk, k.dispatch(build_dev, nb, pk, sc, n)

        def finalize(k, sc, tok):
            pk, pend = tok
            if pend is None:
                stats.host_batches += 1
                return decoded_batch(pk, sc)
            return k.finalize(sc, build, nb, pend)

        def on_miss(sc, tok, reason):
            stats.note_fallback(reason)
            return decoded_batch(tok[0], sc)

        yield from escalating_pipeline(
            runtime.superchunk_batches(join.left.chunks(ctx),
                                       config.superchunk_rows()),
            fk, dispatch, finalize,
            lambda e: self._escalated_fragment(ctx, e, nl, width), on_miss,
            stats)

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
                                   self.aggs, ctx, on_miss)


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
class QueryResult:
    rows: list
    stats: ExecStats
    seconds: float      # host clock, tables in hand to final rows
    tables: dict = field(repr=False, default_factory=dict)
    groups: list = field(repr=False, default_factory=list)  # before the tail


def _chunk_rows(chunk: Chunk) -> list[tuple]:
    """Rows of a result chunk as Python values (None for NULL; decimals as
    scaled ints, dates as epoch micros)."""
    cols = [[(x.item() if isinstance(x, np.generic) else x) if ok else None
             for x, ok in zip(c.data, c.valid)] for c in chunk.columns]
    return list(zip(*cols))


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
