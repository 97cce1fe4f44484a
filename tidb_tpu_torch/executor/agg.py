"""The device aggregation driver: chunks -> superchunks -> kernel ->
merged final rows.

The port's counterpart of the device-agg branch of the JAX package's
store/copr.exec_cop_plan together with HashAggExec's superchunk pipeline
and final merge (executor/__init__.py): scan chunks coalesce into
~tidb_tpu_superchunk_rows batches, tidb_tpu_pipeline_depth of them are in
flight on the device, each is finalized into a partial GroupResult, and a
HashAggregator merges the partials. A CapacityError re-plans once with a
larger table (as `_escalated_kernel` does); a miss that survives it, or a
CollisionError, runs that batch on the host path and counts one fallback.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from tidb_tpu_torch import config
from tidb_tpu_torch.ops import runtime
from tidb_tpu_torch.ops.hashagg import (CapacityError, CollisionError,
                                        HashAggregator, kernel_for)
from tidb_tpu_torch.ops.hostagg import host_hash_agg, host_scalar_agg

__all__ = ["AggRunStats", "Q1Result", "run_agg", "run_q1",
           "escalated_capacity"]

_MAX_AGG_CAPACITY = 1 << 20     # the JAX package's escalation ceiling


def escalated_capacity(needed: int) -> int | None:
    """Next capacity for a CapacityError retry (2x the true group count,
    power of two); None when the overflow is hopeless."""
    cap = 1 << max(needed * 2 - 1, 1).bit_length()
    if not needed or cap > _MAX_AGG_CAPACITY:
        return None
    return cap


@dataclass
class AggRunStats:
    superchunks: int = 0
    device_batches: int = 0
    host_batches: int = 0       # below tidb_tpu_device_min_rows (designed)
    escalations: int = 0
    fallbacks: int = 0          # capacity/collision misses run on the host


def run_agg(chunks, filter_expr, group_exprs, aggs, device=None,
            superchunk_rows: int | None = None, depth: int | None = None,
            stats: AggRunStats | None = None):
    """Aggregate `chunks` (filter, GROUP BY group_exprs, aggs) on `device`
    (CUDA unless the caller asks for another). -> (HashAggregator
    results, AggRunStats)."""
    device = runtime.resolve_device(device)
    stats = stats if stats is not None else AggRunStats()
    group_exprs = list(group_exprs)
    state = {"k": kernel_for(filter_expr, group_exprs, aggs, device=device)}
    min_rows = config.device_min_rows()
    limit = superchunk_rows or config.superchunk_rows()
    depth = depth or config.pipeline_depth()

    def host(chunk):
        if group_exprs:
            return host_hash_agg(chunk, filter_expr, group_exprs, aggs)
        return host_scalar_agg(chunk, filter_expr, aggs)

    def dispatch(chunk):
        stats.superchunks += 1
        if chunk.num_rows < min_rows:
            return None      # host path at finalize
        k = state["k"]
        return k, k.dispatch(chunk)

    def finalize(chunk, tok):
        if tok is None:
            stats.host_batches += 1
            return host(chunk)
        k, pending = tok
        try:
            gr = k.finalize(chunk, pending)
            stats.device_batches += 1
            return gr
        except CapacityError as e:
            cap = escalated_capacity(getattr(e, "needed", 0))
            if cap is not None:
                stats.escalations += 1
                k2 = kernel_for(filter_expr, group_exprs, aggs,
                                capacity=cap, device=device)
                state["k"] = k2      # later batches dispatch with it
                try:
                    gr = k2(chunk)
                    stats.device_batches += 1
                    return gr
                except (CapacityError, CollisionError):
                    pass
        except CollisionError:
            pass
        stats.fallbacks += 1
        return host(chunk)

    agg = HashAggregator(aggs, group_exprs)
    for gr in runtime.pipeline_map(runtime.superchunk_batches(chunks, limit),
                                   dispatch, finalize, depth):
        agg.update(gr)
    return agg.results(), stats


@dataclass
class Q1Result:
    rows: list          # (returnflag, linestatus, 8 aggregate values)
    stats: AggRunStats
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
