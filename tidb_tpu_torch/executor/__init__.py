"""Executors that drive the device operators.

Operators take a context (`ExecContext`) in `chunks(ctx)`, as the JAX
package's executors do: here it carries the device the run's kernels go
to, the table chunks the scans read (or the storage and the snapshot ts
the table readers of executor/reader.py read through), the session's
transaction, and the run's counters (ExecStats).

`build_executor` lowers a physical plan (plan/physical.py) onto these
operators: executor/builder.py holds the lowering per plan node, and the
root operators the SELECT and INSERT paths need (executor/root.py,
executor/write.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tidb_tpu_torch import kv

__all__ = ["ExecStats", "ExecContext", "ExecError", "build_executor"]


class ExecError(kv.KVError):
    pass


def build_executor(plan):
    """The operator tree that runs physical plan `plan` (ref:
    executorBuilder.build, builder.go:62-146), each operator wrapped for
    the active runtime-stats collector."""
    from tidb_tpu_torch.executor.builder import build
    return build(plan)


@dataclass
class ExecStats:
    """Counters of one run, summed over its operators."""

    superchunks: int = 0        # agg batches (device or host)
    device_batches: int = 0     # agg batches aggregated on the device
    host_batches: int = 0       # below tidb_tpu_device_min_rows (designed)
    escalations: int = 0        # agg capacity re-plans
    join_dispatches: int = 0    # pipelined-probe matcher dispatches
    host_match_batches: int = 0  # probe batches too small for a dispatch
    hybrid_joins: int = 0       # joins the partitioned hybrid path carried
    partition_uploads: int = 0  # hybrid build partitions uploaded
    hybrid_tasks: int = 0       # hybrid (probe batch x partition) dispatches
    fused_dispatches: int = 0   # fused probe -> partial-agg dispatches
    spilled_partitions: int = 0  # hybrid build partitions the quota shed
    staged_probe_rows: int = 0  # probe rows staged for spilled partitions
    drained_probe_rows: int = 0  # staged probe rows matched in the drain
    sort_spilled_runs: int = 0  # runs the stream agg's sorter wrote
    agg_algorithm: str = ""     # "stream" or "hash", where a run chose
    segsum_launches: int = 0    # segment-sum kernel launches of the run
    mem_peak: int = 0           # the statement ledger's host+device peak
    mem_device_at_peak: int = 0  # ... and its device bytes at that moment
    mem_left: int = 0           # bytes the ledger still held at the end
    fault_degraded: bool = False  # a device fault latched the host path
    fallback_reasons: dict = field(default_factory=dict)
    # build table (or "?") -> the path its join took: hybrid, pipelined,
    # fused, per-chunk
    join_paths: dict = field(default_factory=dict)

    def note_fallback(self, reason: str) -> None:
        """One batch (or partition) that a device path could not serve
        and the host aggregated, by reason: capacity, collision,
        unsupported."""
        self.fallback_reasons[reason] = \
            self.fallback_reasons.get(reason, 0) + 1

    @property
    def fallbacks(self) -> int:
        return sum(self.fallback_reasons.values())


@dataclass
class ExecContext:
    """What one run's operators share: the device, the scans' tables
    (table name -> list of Chunks), the counters, and for readers over
    the store the storage and the statement's snapshot ts; a session
    statement adds its transaction (writes and dirty reads; None for an
    autocommit read) and its interrupt probe (KILL QUERY)."""

    device: object
    tables: dict = field(default_factory=dict)
    stats: ExecStats = field(default_factory=ExecStats)
    storage: object = None
    read_ts: int = 0
    txn: object = None
    interrupted: object = None

    def check_interrupt(self) -> None:
        if self.interrupted is not None and self.interrupted():
            raise ExecError("Query execution was interrupted")
