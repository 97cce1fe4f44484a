"""In-process metrics registry with Prometheus text exposition.

A copy of the JAX package's metrics module (which imports nothing of that
package): the same registry, metric names, labels and help strings, so a
counter means the same thing in both packages. Counters, gauges and
histograms are plain values under one lock; `expose` renders the
Prometheus text format and `snapshot` / `gauges_snapshot` give dicts for
tests and benchmarks. The port's memory ledger (memtrack), the hybrid
join (JOIN_SPILL_PARTITIONS, JOIN_HOT_ROWS) and the quota chain
(MEM_QUOTA_EXCEEDED) count here.
"""

from __future__ import annotations

import threading

__all__ = ["counter", "histogram", "gauge", "expose", "snapshot",
           "gauges_snapshot",
           "QUERY_DURATIONS", "QUERIES_TOTAL", "SLOW_QUERIES",
           "CONNECTIONS", "COP_TASKS", "QUERY_ERRORS",
           "COP_STREAM_FRAMES", "COP_STREAM_BYTES",
           "COP_STREAM_CREDIT_STALLS", "COP_STREAM_RESUMES",
           "OP_DURATIONS", "OP_ROWS", "OP_DEVICE_DURATIONS",
           "SUPERCHUNKS", "SUPERCHUNK_SOURCES", "SUPERCHUNK_FILL_ROWS",
           "SUPERCHUNK_BUCKET_ROWS", "PIPELINE_STALLS",
           "QUERY_MEM", "MEM_QUOTA_EXCEEDED", "DEVICE_PEAK",
           "HBM_CACHE_HITS", "HBM_CACHE_MISSES", "HBM_CACHE_EVICTIONS",
           "DEVICE_FALLBACKS", "JOIN_SPILL_PARTITIONS", "JOIN_HOT_ROWS",
           "CONNECTIONS_CURRENT", "ADMISSIONS", "ADMISSION_WAITS",
           "ADMISSION_QUEUE_DEPTH", "SCHED_STALLS", "SCHED_BYPASSES",
           "DELTA_ROWS", "DELTA_MERGES", "CACHE_DELTA_SERVES",
           "FLEET_JOURNAL_PULLS", "FLEET_PATCHED_ROWS",
           "FLEET_RPC_SECONDS", "FLEET_LOCAL_COP",
           "BYTES_ENCODED", "BYTES_DECODED_EQUIV",
           "FAILPOINT_FIRES", "WORKER_RESTARTS", "DISPATCH_TIMEOUTS",
           "DEVICE_QUARANTINES", "TRACES",
           "CLUSTER_SCRAPES", "MEMBER_START_TIME",
           "DEVICE_UTILIZATION", "HBM_OCCUPANCY", "CHIP_UTILIZATION",
           "KERNEL_COMPILE_SECONDS", "KERNEL_DISPATCHES"]

_lock = threading.Lock()
_counters: dict[tuple[str, tuple], float] = {}       # guarded-by: _lock
_histograms: dict[tuple[str, tuple], "_Hist"] = {}   # guarded-by: _lock
_gauges: dict[tuple[str, tuple], float] = {}         # guarded-by: _lock

_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)


class _Hist:
    __slots__ = ("buckets", "counts", "total", "sum")

    def __init__(self):
        self.buckets = _BUCKETS
        self.counts = [0] * (len(_BUCKETS) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        i = 0
        for i, b in enumerate(self.buckets):
            if v <= b:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.total += 1
        self.sum += v


def _label_key(labels: dict | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _label_str(labels: tuple, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def counter(name: str, labels: dict | None = None, inc: float = 1) -> None:
    key = (name, _label_key(labels))
    with _lock:
        _counters[key] = _counters.get(key, 0) + inc


def histogram(name: str, value: float, labels: dict | None = None) -> None:
    key = (name, _label_key(labels))
    with _lock:
        h = _histograms.get(key)
        if h is None:
            h = _histograms[key] = _Hist()
        h.observe(value)


def gauge(name: str, value: float, labels: dict | None = None) -> None:
    """Set a gauge series to its current value (last write wins)."""
    key = (name, _label_key(labels))
    with _lock:
        _gauges[key] = float(value)


def gauges_snapshot() -> dict:
    """Gauge series only (flattened name{labels} keys) — the history
    sampler copies these per tick, and the conftest gauge-hygiene check
    asserts the *_current/*_depth families drain to zero."""
    with _lock:
        return {name + _label_str(labels): v
                for (name, labels), v in _gauges.items()}


def snapshot() -> dict:
    """Plain dict of counter/histogram values (tests / status JSON).
    Unlabeled series keep the historical flat keys (name, name_count,
    name_sum); labeled series append their label set."""
    with _lock:
        out = {}
        for (name, labels), v in _counters.items():
            out[name + _label_str(labels)] = v
        for (name, labels), v in _gauges.items():
            out[name + _label_str(labels)] = v
        for (name, labels), h in _histograms.items():
            lbl = _label_str(labels)
            out[name + "_count" + lbl] = h.total
            out[name + "_sum" + lbl] = round(h.sum, 6)
        return out


def expose() -> str:
    """Prometheus text exposition format, with # HELP/# TYPE per family
    so real scrapers ingest the endpoint cleanly."""
    lines = []
    with _lock:
        seen_meta: set[str] = set()

        def meta(name: str, tp: str) -> None:
            if name in seen_meta:
                return
            seen_meta.add(name)
            lines.append(f"# HELP {name} {_HELP.get(name, name)}")
            lines.append(f"# TYPE {name} {tp}")

        for (name, labels), v in sorted(_counters.items()):
            meta(name, "counter")
            lines.append(f"{name}{_label_str(labels)} {v}")
        for (name, labels), v in sorted(_gauges.items()):
            meta(name, "gauge")
            lines.append(f"{name}{_label_str(labels)} {v}")
        for (name, labels), h in sorted(_histograms.items()):
            meta(name, "histogram")
            acc = 0
            for b, c in zip(h.buckets, h.counts):
                acc += c
                le = 'le="%s"' % b
                lines.append(
                    f"{name}_bucket{_label_str(labels, le)} {acc}")
            inf = 'le="+Inf"'
            lines.append(
                f"{name}_bucket{_label_str(labels, inf)} {h.total}")
            lines.append(f"{name}_count{_label_str(labels)} {h.total}")
            lines.append(f"{name}_sum{_label_str(labels)} {h.sum}")
    return "\n".join(lines) + "\n"


# metric names (one place, mirroring the reference's metric families)
QUERY_DURATIONS = "tidb_tpu_query_duration_seconds"
QUERIES_TOTAL = "tidb_tpu_queries_total"
SLOW_QUERIES = "tidb_tpu_slow_queries_total"
CONNECTIONS = "tidb_tpu_connections_total"
COP_TASKS = "tidb_tpu_cop_tasks_total"
QUERY_ERRORS = "tidb_tpu_query_errors_total"
# streaming coprocessor (store/stream.py): framed partial responses,
# credit-window backpressure, mid-stream resume counts
COP_STREAM_FRAMES = "tidb_tpu_cop_stream_frames_total"
COP_STREAM_BYTES = "tidb_tpu_cop_stream_bytes_total"
COP_STREAM_CREDIT_STALLS = "tidb_tpu_cop_stream_credit_stalls_total"
COP_STREAM_RESUMES = "tidb_tpu_cop_stream_resumes_total"
# per-operator runtime stats (runtime_stats.py), labeled {op="HashAgg"}
OP_DURATIONS = "tidb_tpu_op_duration_seconds"
OP_ROWS = "tidb_tpu_op_act_rows_total"
OP_DEVICE_DURATIONS = "tidb_tpu_op_device_seconds"
# superchunk pipeline (ops/runtime.py), labeled {op=...}: fill ratio is
# derived as fill_rows / bucket_rows; stall is host time blocked on
# device readback inside the dispatch-ahead pipeline
SUPERCHUNKS = "tidb_tpu_superchunks_total"
SUPERCHUNK_SOURCES = "tidb_tpu_superchunk_source_chunks_total"
SUPERCHUNK_FILL_ROWS = "tidb_tpu_superchunk_fill_rows_total"
SUPERCHUNK_BUCKET_ROWS = "tidb_tpu_superchunk_bucket_rows_total"
PIPELINE_STALLS = "tidb_tpu_pipeline_stall_seconds"
# hierarchical memory tracking (memtrack.py): per-statement peak bytes
# (gauge, last statement's peak, labeled kind=host|device), quota
# OOM-action firings (counter, labeled action=spill|cancel), and the
# process-wide backend allocator watermark kept ONLY as a server-root
# gauge — per-op mem comes from the trackers, never the watermark
QUERY_MEM = "tidb_tpu_query_mem_bytes"
MEM_QUOTA_EXCEEDED = "tidb_tpu_mem_quota_exceeded_total"
DEVICE_PEAK = "tidb_tpu_device_peak_bytes"
# HBM-resident columnar region-block cache (store/device_cache.py): a
# hit serves a dispatch straight from device-resident columns (zero
# host->device bytes); evictions count LRU/budget drops AND stale-
# version invalidation drops
HBM_CACHE_HITS = "tidb_tpu_hbm_cache_hits_total"
HBM_CACHE_MISSES = "tidb_tpu_hbm_cache_misses_total"
HBM_CACHE_EVICTIONS = "tidb_tpu_hbm_cache_evictions_total"
# device->host execution fallbacks (labeled {op=...,reason=capacity|
# collision|unsupported|mesh}): every time an operator planned for the
# device lands on the host numpy path instead. Before the hybrid
# join/agg this happened invisibly inside broad except nets; now each
# one is counted and surfaced in EXPLAIN ANALYZE
DEVICE_FALLBACKS = "tidb_tpu_device_fallback_total"
# hybrid hash join (ops/hybrid.py): build partitions shed from HBM to
# host staging by the memtrack quota spill action, and probe rows routed
# through the heavy-hitter broadcast lane
JOIN_SPILL_PARTITIONS = "tidb_tpu_join_spill_partitions_total"
JOIN_HOT_ROWS = "tidb_tpu_join_hot_lane_rows_total"
# concurrent serving (the scheduler + server accept loop): live
# connection count, statement admission outcomes/wait/queue against
# tidb_tpu_server_mem_quota, and the device scheduler's dispatch-slot
# stalls (time statements spent waiting for their round-robin grant)
# and bypasses (dispatches that proceeded unscheduled past the valve)
CONNECTIONS_CURRENT = "tidb_tpu_connections_current"
ADMISSIONS = "tidb_tpu_admission_total"
ADMISSION_WAITS = "tidb_tpu_admission_wait_seconds"
ADMISSION_QUEUE_DEPTH = "tidb_tpu_admission_queue_depth"
SCHED_STALLS = "tidb_tpu_sched_stall_seconds"
SCHED_BYPASSES = "tidb_tpu_sched_bypass_total"
# MVCC delta store (store/delta.py): staged committed-row deltas kept
# per table so cached columnar blocks serve base + delta under OLTP
# writes instead of re-colding; merges fold deltas back into base
# blocks (labeled by what triggered them)
DELTA_ROWS = "tidb_tpu_delta_rows_current"
DELTA_MERGES = "tidb_tpu_delta_merge_total"
CACHE_DELTA_SERVES = "tidb_tpu_cache_served_with_delta_total"
# fleet serving (store/fleetcop.py, store/remote.py): N SQL-server
# processes share one store plane; each keeps its own chunk + HBM
# caches coherent by pulling delta-journal windows over the wire
FLEET_JOURNAL_PULLS = "tidb_tpu_fleet_journal_pulls_total"
FLEET_PATCHED_ROWS = "tidb_tpu_fleet_journal_patched_rows_total"
FLEET_RPC_SECONDS = "tidb_tpu_fleet_remote_rpc_seconds"
FLEET_LOCAL_COP = "tidb_tpu_fleet_local_cop_total"
# encoded execution (ops/encoded.py): input bytes device dispatches
# actually staged/read (dict codes + validity at the padded bucket) vs
# the decoded-equivalent footprint of the same inputs — BENCH's
# per-query bytes_touched column diffs these to audit the compression
# win (ROADMAP item 4)
BYTES_ENCODED = "tidb_tpu_device_bytes_encoded_total"
BYTES_DECODED_EQUIV = "tidb_tpu_device_bytes_decoded_equiv_total"
# fault injection + device-plane recovery (util/failpoint.py, sched.py,
# util/supervisor.py): armed failpoint firings (labeled {name=...}),
# supervised background workers restarted after a crash (labeled
# {worker=...}), dispatch-watchdog cancellations past
# tidb_tpu_dispatch_timeout_ms, and device quarantine transitions
# (labeled {event=quarantine|readmit})
FAILPOINT_FIRES = "tidb_tpu_failpoint_fires_total"
WORKER_RESTARTS = "tidb_tpu_worker_restarts_total"
DISPATCH_TIMEOUTS = "tidb_tpu_dispatch_timeout_total"
DEVICE_QUARANTINES = "tidb_tpu_device_quarantine_total"
# statement tracing (trace.py): span trees retained into the bounded
# server trace ring, labeled by what retained them
# (sampled|slow|forced)
TRACES = "tidb_tpu_statement_traces_total"
# cluster fan-out (util/statusclient.fetch_all): per-member fetch
# outcomes of the cluster_* / /fleet/* surfaces. Labeled by outcome
# only — NEVER by member (the metric-cardinality rule: members churn,
# and the per-member attribution lives in cluster_members itself)
CLUSTER_SCRAPES = "tidb_tpu_cluster_scrape_total"
# member identity stamp on the /metrics exposition (server/status.py
# renders it with the member id + role as labels — hand-rendered
# there, not a registry series, because the id is per-process)
MEMBER_START_TIME = "tidb_tpu_member_start_time_seconds"
# continuous resource metering (meter.py + metrics_history.py): the
# history sampler derives these each tick — device busy-ns per wall
# interval (can exceed 1.0 under dispatch overlap; that overlap IS the
# pipeline working) and the HBM region-block cache's resident bytes
# over its tidb_tpu_device_cache_bytes budget
DEVICE_UTILIZATION = "tidb_tpu_device_utilization_ratio"
HBM_OCCUPANCY = "tidb_tpu_hbm_occupancy_ratio"
# per-chip slot busy-time over the sampler interval, labeled {chip}
# (bounded by the plane's device count): the scheduler's placement
# signal surfaced as a series, and the serve bench's balance figure
CHIP_UTILIZATION = "tidb_tpu_chip_utilization_ratio"
# kernel profiling plane (profiler.py): per-family kernel first-call
# wall time (trace+compile+load) and per-family dispatch counts. Labeled
# {family} only (hashagg|scalaragg|streamagg|fragment|mesh|plane — a
# bounded vocabulary, per the cardinality rule)
KERNEL_COMPILE_SECONDS = "tidb_tpu_kernel_compile_seconds"
KERNEL_DISPATCHES = "tidb_tpu_kernel_dispatch_total"

_HELP = {
    QUERY_DURATIONS: "Statement wall time through Session.execute.",
    QUERIES_TOTAL: "Statements executed, by statement type.",
    SLOW_QUERIES: "Statements at/above tidb_tpu_slow_query_ms.",
    CONNECTIONS: "Client connections accepted.",
    COP_TASKS: "Coprocessor region tasks dispatched.",
    QUERY_ERRORS: "Statements that raised an error.",
    COP_STREAM_FRAMES: "Streamed coprocessor frames produced.",
    COP_STREAM_BYTES: "Raw bytes carried by streamed frames.",
    COP_STREAM_CREDIT_STALLS:
        "Producer stalls waiting for client credit.",
    COP_STREAM_RESUMES: "Mid-stream resumes after interruption.",
    OP_DURATIONS: "Per-operator host wall time per statement, by op.",
    OP_ROWS: "Per-operator actual output rows, by op.",
    OP_DEVICE_DURATIONS:
        "Per-operator device time (block_until_ready), by op.",
    SUPERCHUNKS: "Coalesced superchunk device dispatches, by op.",
    SUPERCHUNK_SOURCES:
        "Source chunks folded into superchunks, by op.",
    SUPERCHUNK_FILL_ROWS:
        "Live rows carried by superchunks, by op.",
    SUPERCHUNK_BUCKET_ROWS:
        "Padded bucket rows dispatched for superchunks, by op.",
    PIPELINE_STALLS:
        "Per-operator host time blocked on device readback, by op.",
    QUERY_MEM:
        "Last statement's peak tracked bytes, by ledger kind.",
    MEM_QUOTA_EXCEEDED:
        "Quota OOM-action firings, by action (spill|cancel).",
    DEVICE_PEAK:
        "Backend allocator peak-bytes watermark (process-wide).",
    HBM_CACHE_HITS:
        "Dispatches served from the HBM region-block cache.",
    HBM_CACHE_MISSES:
        "HBM region-block cache misses (upload paid).",
    HBM_CACHE_EVICTIONS:
        "HBM region-block cache entries dropped (LRU/stale/shed).",
    DEVICE_FALLBACKS:
        "Device operators that fell back to the host path, "
        "by op and reason.",
    JOIN_SPILL_PARTITIONS:
        "Hybrid-join build partitions spilled from HBM under quota.",
    JOIN_HOT_ROWS:
        "Probe rows routed through the heavy-hitter join lane.",
    CONNECTIONS_CURRENT: "Client connections currently open.",
    ADMISSIONS:
        "Statement admission decisions, by outcome "
        "(admitted|queued|shed|rejected).",
    ADMISSION_WAITS:
        "Time statements spent in the admission controller.",
    ADMISSION_QUEUE_DEPTH:
        "Statements currently waiting for admission.",
    SCHED_STALLS:
        "Time statements spent waiting for a device dispatch slot.",
    SCHED_BYPASSES:
        "Dispatches that proceeded unscheduled past the bypass valve.",
    DELTA_ROWS:
        "Committed row deltas currently staged in the delta store.",
    DELTA_MERGES:
        "Delta-store merges into new base blocks, by trigger "
        "(rows|ratio|shed|close).",
    CACHE_DELTA_SERVES:
        "Cache reads served as base + delta instead of re-scanning.",
    FLEET_JOURNAL_PULLS:
        "Journal-window pulls from the store plane, by outcome "
        "(window|empty|stale|meta).",
    FLEET_PATCHED_ROWS:
        "Rows patched into resident fleet cache blocks from shipped "
        "journal windows.",
    FLEET_RPC_SECONDS:
        "Remote store RPC latency by method.",
    FLEET_LOCAL_COP:
        "Fleet coprocessor reads, by serving path (cached|store).",
    BYTES_ENCODED:
        "Input bytes device dispatches actually staged or read "
        "(dictionary codes + validity at the padded bucket).",
    BYTES_DECODED_EQUIV:
        "Decoded-equivalent footprint of the same dispatch inputs.",
    FAILPOINT_FIRES:
        "Armed failpoint firings, by declared point name.",
    WORKER_RESTARTS:
        "Supervised background workers restarted after a crash, "
        "by worker.",
    DISPATCH_TIMEOUTS:
        "Statements cancelled by the dispatch watchdog past "
        "tidb_tpu_dispatch_timeout_ms.",
    DEVICE_QUARANTINES:
        "Device quarantine transitions after repeated faults, "
        "by event (quarantine|readmit).",
    TRACES:
        "Statement traces retained into the server trace ring, "
        "by reason (sampled|slow|forced).",
    CLUSTER_SCRAPES:
        "Cluster fan-out fetches against member status ports, "
        "by outcome (ok|timeout|error).",
    MEMBER_START_TIME:
        "This member's process start time (unix seconds), labeled "
        "with its fleet member id and role.",
    DEVICE_UTILIZATION:
        "Device busy-time per wall second over the last history "
        "sampler interval (dispatch overlap can push it past 1.0).",
    HBM_OCCUPANCY:
        "HBM region-block cache resident bytes over its budget.",
    CHIP_UTILIZATION:
        "Per-chip scheduler-slot busy time per wall second over the "
        "last history sampler interval, labeled by plane chip index.",
    KERNEL_COMPILE_SECONDS:
        "Kernel first-call wall time (trace+compile+cache load), "
        "by kernel family.",
    KERNEL_DISPATCHES:
        "Device kernel dispatches, by kernel family.",
}
