"""The sysvars the port's kernels, its storage path, its planner, its
session and its server read.

A subset of the JAX package's registry, with the same names, types and
defaults, so one setting means the same thing in both packages.
`SET [GLOBAL] @@tidb_tpu_x = v` in a session writes through `coerce` and
`set_var` (GLOBAL) or the session's overlay; `on_change` hooks run after
a `set_var` (util/failpoint.py arms the registry from
`tidb_tpu_failpoints`, a GLOBAL-only variable). Values
come from the defaults, then from the environment (TIDB_TPU_SUPERCHUNK_ROWS
and so on), then from `set_var`; `session_overlay` shadows them on one
thread for a statement's duration, and `current_overlay` hands a
thread's overlay to the coprocessor's pool workers.
"""

from __future__ import annotations

import os
import threading

__all__ = ["get_var", "set_var", "session_overlay", "current_overlay",
           "chunk_cache_enabled",
           "cop_concurrency", "copr_stream_enabled",
           "copr_stream_frame_bytes", "copr_stream_credit",
           "device_cache_bytes", "delta_store_enabled", "delta_merge_rows",
           "delta_merge_ratio_pct", "delta_retain_ms", "device_min_rows",
           "superchunk_rows", "pipeline_depth", "fused_scan_enabled",
           "encoded_exec_enabled", "fuse_fragments_enabled",
           "direct_agg_slots", "join_partitions", "skew_threshold",
           "sort_spill_rows", "mem_quota_query", "sched_inflight",
           "sched_inflight_bytes", "dispatch_timeout_ms", "kernel_profile",
           "kernel_profile_cap", "device_enabled", "slow_query_ms",
           "server_mem_quota", "admission_timeout_ms", "stmt_profile_cap",
           "metrics_history_interval_ms", "metrics_history_points",
           "runtime_stats_enabled", "runtime_stats_device", "trace_sample",
           "slow_trace_ms", "trace_log", "failpoints_spec", "on_change",
           "is_global_only", "all_vars", "is_known", "coerce",
           "SERVER_VERSION", "UnknownVariableError"]

# the version string the server reports (VERSION(), the @@version
# sysvar, the handshake's greeting)
SERVER_VERSION = "8.0.11-tidb-tpu-1.0"


class UnknownVariableError(Exception):
    pass


_BOOL, _INT, _STR = "bool", "int", "str"

_DEFS: dict[str, tuple[str, int]] = {
    # master switch for the device kernels; 0 = the numpy host path
    # everywhere (the session's SET @@tidb_tpu_device = 0)
    "tidb_tpu_device": (_BOOL, 1),
    # columnar region-chunk cache on the storage side (store/chunk_cache)
    "tidb_tpu_chunk_cache": (_BOOL, 1),
    # coprocessor fan-out worker count
    "tidb_tpu_cop_concurrency": (_INT, 10),
    # streaming coprocessor (store/stream.py): framed partial responses
    # per key range; 0 = materialized per-region response lists
    "tidb_tpu_copr_stream": (_BOOL, 1),
    # a streamed frame carries at most this many raw scanned bytes
    "tidb_tpu_copr_stream_frame_bytes": (_INT, 4 << 20),
    # frames in flight past the consumer before a producer blocks
    "tidb_tpu_copr_stream_credit": (_INT, 4),
    # HBM-resident region-block cache budget in bytes
    # (store/device_cache.py); 0 disables it
    "tidb_tpu_device_cache_bytes": (_INT, 2 << 30),
    # MVCC delta store (store/delta.py): row commits journal per table
    # and both cache tiers serve base + delta
    "tidb_tpu_delta_store": (_BOOL, 1),
    # staged delta rows per table that trigger a merge
    "tidb_tpu_delta_merge_rows": (_INT, 8192),
    # merge when staged rows pass this percent of the cached base rows
    "tidb_tpu_delta_merge_ratio_pct": (_INT, 25),
    # journal kept behind now by a merge, wall-clock ms (0 = none)
    "tidb_tpu_delta_retain_ms": (_INT, 0),
    # min chunk rows before an executor pays a device dispatch
    "tidb_tpu_device_min_rows": (_INT, 2048),
    # rows per coalesced device batch (ops/runtime.superchunk_batches); a
    # power of two keeps every full superchunk on one bucket shape
    "tidb_tpu_superchunk_rows": (_INT, 1 << 18),
    # dispatch-ahead window of the device pipeline (2 = double buffering)
    "tidb_tpu_pipeline_depth": (_INT, 2),
    # fused scan->filter->partial-agg over device-resident blocks
    "tidb_tpu_fused_scan": (_BOOL, 1),
    # operate on dictionary codes end to end
    "tidb_tpu_encoded_exec": (_BOOL, 1),
    # one program per pipeline fragment
    "tidb_tpu_fuse_fragments": (_BOOL, 1),
    # cardinality bound of the direct-indexed partial-agg table; past it
    # the group-by degrades to the packed-sort hash table
    "tidb_tpu_direct_agg_slots": (_INT, 4096),
    # radix fan-out of the partitioned hybrid hash join/agg
    # (ops/hybrid.py); 0/1 disables partitioning
    "tidb_tpu_join_partitions": (_INT, 8),
    # heavy-hitter threshold in rows: a join key this frequent on either
    # side routes to the hybrid join's broadcast lane; 0 disables it
    "tidb_tpu_skew_threshold": (_INT, 1 << 15),
    # external sort's run size in rows (executor/extsort.SpillSorter):
    # buffered rows past it spill to disk as one sorted run
    "tidb_tpu_sort_spill_rows": (_INT, 1 << 20),
    # per-statement memory quota in bytes over the memtrack ledgers
    # (host + device); 0 = unlimited. Crossing it fires the registered
    # spill actions first, then cancels with QuotaExceededError
    "tidb_tpu_mem_quota_query": (_INT, 0),
    # global device dispatch window (sched.DeviceScheduler): at most this
    # many kernel dispatches in flight across ALL concurrent statements,
    # granted round-robin per statement. 0 = scheduler off
    "tidb_tpu_sched_inflight": (_INT, 4),
    # in-flight-bytes gate: a dispatch slot is granted only while the
    # memtrack SERVER root's DEVICE ledger sits below this many bytes
    # (0 = no bytes gate); one dispatch always passes when none is in
    # flight
    "tidb_tpu_sched_inflight_bytes": (_INT, 0),
    # dispatch watchdog (sched.DispatchWatchdog): a finalize (or a
    # device_slot-guarded sync dispatch) past this many milliseconds
    # cancels its statement with the retryable device-fault error.
    # 0 = off (the default)
    "tidb_tpu_dispatch_timeout_ms": (_INT, 0),
    # kernel profiling plane (profiler.py): per-kernel dispatch, busy
    # time, bytes and roofline accounting keyed (family, plan
    # fingerprint, device fingerprint)
    "tidb_tpu_kernel_profile": (_BOOL, 1),
    # bounded size of the kernel-profile registry (true LRU beyond)
    "tidb_tpu_kernel_profile_cap": (_INT, 512),
    # statements at/above this wall time land in the slow-query log
    # (ref: config.Log.SlowThreshold, default 300ms)
    "tidb_tpu_slow_query_ms": (_INT, 300),
    # per-operator runtime statistics (runtime_stats.py): rows, loops
    # and host wall time per operator for EXPLAIN ANALYZE, the digest
    # summary, the slow log and the operator metric families
    "tidb_tpu_runtime_stats": (_BOOL, 1),
    # device-time attribution: a CUDA event pair around each timed call,
    # waited on, which SERIALIZES dispatch; off by default (EXPLAIN
    # ANALYZE's device_time)
    "tidb_tpu_runtime_stats_device": (_BOOL, 0),
    # emit every statement's span tree to the tidb_tpu_torch.trace logger
    "tidb_tpu_trace_log": (_BOOL, 0),
    # statement-trace sampling (trace.py): every N-th non-internal
    # statement retains its span tree in the bounded trace ring; 1
    # retains everything, 0 disables sampling (slow capture and TRACE
    # still retain). A deterministic counter, not random
    "tidb_tpu_trace_sample": (_INT, 64),
    # slow-trace capture: a statement at or over this many milliseconds
    # retains its tree regardless of sampling; 0 = off
    "tidb_tpu_slow_trace_ms": (_INT, 300),
    # server-wide memory quota in bytes over the memtrack SERVER root
    # (host + device) for statement admission (sched.AdmissionController);
    # 0 = admission off. A statement whose digest's recorded peak does
    # not fit sheds the server's caches, then queues up to
    # tidb_tpu_admission_timeout_ms, then is rejected with the retryable
    # ER_SERVER_BUSY_ADMISSION (9008), never a mid-query OOM cancel
    "tidb_tpu_server_mem_quota": (_INT, 0),
    # bounded admission-queue wait before a statement is rejected with
    # the retryable 9008 (milliseconds)
    "tidb_tpu_admission_timeout_ms": (_INT, 1000),
    # bounded size of perfschema's per-digest mode-history memo
    "tidb_tpu_stmt_profile_cap": (_INT, 1024),
    # metrics-history sampler cadence (metrics_history.py); 0 = idle
    "tidb_tpu_metrics_history_interval_ms": (_INT, 1000),
    # metrics-history ring capacity in points
    "tidb_tpu_metrics_history_points": (_INT, 512),
    # failpoint arming (util/failpoint.py): "name=spec;name=spec" over
    # the declared registry. Declarative: a write arms the listed points
    # and disarms what a previous write armed. GLOBAL scope only
    "tidb_tpu_failpoints": (_STR, ""),
}

# vars whose write is a process-wide side effect routed through on_change
# hooks: a session-scope SET would shadow the value on one thread while
# arming nothing, so the session refuses it (ER_GLOBAL_VARIABLE)
_GLOBAL_ONLY = frozenset({"tidb_tpu_failpoints"})

_vals: dict[str, int] = {}
_lock = threading.Lock()
_tls = threading.local()
# name -> [fn]: set_var runs them after the write, with _lock dropped
_hooks: dict[str, list] = {}        # guarded-by: _lock


def _coerce(tp: str, value) -> int:
    if tp == _STR:
        return "" if value is None else str(value)
    if isinstance(value, str):
        v = value.strip().lower()
        if tp == _BOOL and v in ("on", "true"):
            return 1
        if tp == _BOOL and v in ("off", "false"):
            return 0
        value = int(v)
    iv = int(value)
    return (1 if iv else 0) if tp == _BOOL else iv


def _init() -> None:
    for name, (tp, dflt) in _DEFS.items():
        env = os.environ.get(name.upper())
        _vals[name] = dflt if env is None else _coerce(tp, env)


_init()


def _read(key: str) -> int:
    ov = getattr(_tls, "overlay", None)
    if ov is not None and key in ov:
        return ov[key]
    return _vals[key]


class session_overlay:
    """Shadow registry values on THIS thread for a statement's duration.
    Nests: inner overlays win, outers restore."""

    def __init__(self, vars: dict):
        self.vars = {k.lower(): _coerce(_DEFS[k.lower()][0], v)
                     for k, v in vars.items() if k.lower() in _DEFS}
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "overlay", None)
        merged = dict(self._prev) if self._prev else {}
        merged.update(self.vars)
        _tls.overlay = merged
        return self

    def __exit__(self, *exc):
        _tls.overlay = self._prev
        return False


def current_overlay() -> dict:
    """This thread's effective overlay, for re-installing in a worker
    thread with session_overlay(...)."""
    return dict(getattr(_tls, "overlay", None) or {})


def get_var(name: str) -> int:
    key = name.lower()
    if key not in _DEFS:
        raise UnknownVariableError(name)
    return _read(key)


def set_var(name: str, value) -> None:
    key = name.lower()
    if key not in _DEFS:
        raise UnknownVariableError(name)
    new = _coerce(_DEFS[key][0], value)
    with _lock:
        prev = _vals.get(key)
        _vals[key] = new
        hooks = list(_hooks.get(key, ()))
    try:
        for fn in hooks:
            fn(new)
    except Exception:
        # a hook that rejects the value (a bad failpoint spec) must not
        # leave the registry claiming a value that never took effect;
        # compare-and-restore, so a concurrent write is not clobbered
        with _lock:
            if _vals.get(key) == new:
                _vals[key] = prev
        raise


def on_change(name: str, fn) -> None:
    """Register fn(new_value) to run after every set_var(name)."""
    key = name.lower()
    if key not in _DEFS:
        raise UnknownVariableError(name)
    with _lock:
        _hooks.setdefault(key, []).append(fn)


def is_global_only(name: str) -> bool:
    return name.lower() in _GLOBAL_ONLY


def all_vars() -> dict[str, int]:
    """Effective values on this thread (session overlay applied)."""
    out = dict(_vals)
    ov = getattr(_tls, "overlay", None)
    if ov:
        out.update(ov)
    return out


def is_known(name: str) -> bool:
    return name.lower() in _DEFS


def coerce(name: str, value) -> int:
    """Validate + normalize a value for a known variable (raises
    UnknownVariableError / ValueError)."""
    key = name.lower()
    if key not in _DEFS:
        raise UnknownVariableError(name)
    return _coerce(_DEFS[key][0], value)


def device_enabled() -> bool:
    return bool(_read("tidb_tpu_device"))


def device_min_rows() -> int:
    return _read("tidb_tpu_device_min_rows")


def superchunk_rows() -> int:
    return _read("tidb_tpu_superchunk_rows")


def pipeline_depth() -> int:
    return _read("tidb_tpu_pipeline_depth")


def fused_scan_enabled() -> bool:
    return bool(_read("tidb_tpu_fused_scan"))


def encoded_exec_enabled() -> bool:
    return bool(_read("tidb_tpu_encoded_exec"))


def fuse_fragments_enabled() -> bool:
    return bool(_read("tidb_tpu_fuse_fragments"))


def direct_agg_slots() -> int:
    return _read("tidb_tpu_direct_agg_slots")


def join_partitions() -> int:
    return max(0, _read("tidb_tpu_join_partitions"))


def skew_threshold() -> int:
    return max(0, _read("tidb_tpu_skew_threshold"))


def sort_spill_rows() -> int:
    return _read("tidb_tpu_sort_spill_rows")


def mem_quota_query() -> int:
    return max(0, _read("tidb_tpu_mem_quota_query"))


def chunk_cache_enabled() -> bool:
    return bool(_read("tidb_tpu_chunk_cache"))


def cop_concurrency() -> int:
    return _read("tidb_tpu_cop_concurrency")


def copr_stream_enabled() -> bool:
    return bool(_read("tidb_tpu_copr_stream"))


def copr_stream_frame_bytes() -> int:
    return min(max(1, _read("tidb_tpu_copr_stream_frame_bytes")), 1 << 30)


def copr_stream_credit() -> int:
    return max(1, _read("tidb_tpu_copr_stream_credit"))


def device_cache_bytes() -> int:
    return max(0, _read("tidb_tpu_device_cache_bytes"))


def delta_store_enabled() -> bool:
    return bool(_read("tidb_tpu_delta_store"))


def delta_merge_rows() -> int:
    return max(1, _read("tidb_tpu_delta_merge_rows"))


def delta_merge_ratio_pct() -> int:
    return max(0, _read("tidb_tpu_delta_merge_ratio_pct"))


def delta_retain_ms() -> int:
    return max(0, _read("tidb_tpu_delta_retain_ms"))



def sched_inflight() -> int:
    return max(0, _read("tidb_tpu_sched_inflight"))


def sched_inflight_bytes() -> int:
    return max(0, _read("tidb_tpu_sched_inflight_bytes"))


def dispatch_timeout_ms() -> int:
    return max(0, _read("tidb_tpu_dispatch_timeout_ms"))


def kernel_profile() -> bool:
    return bool(_read("tidb_tpu_kernel_profile"))


def kernel_profile_cap() -> int:
    return min(max(16, _read("tidb_tpu_kernel_profile_cap")), 1 << 16)


def slow_query_ms() -> int:
    return _read("tidb_tpu_slow_query_ms")


def server_mem_quota() -> int:
    return max(0, _read("tidb_tpu_server_mem_quota"))


def admission_timeout_ms() -> int:
    return max(0, _read("tidb_tpu_admission_timeout_ms"))


def stmt_profile_cap() -> int:
    return min(max(16, _read("tidb_tpu_stmt_profile_cap")), 1 << 16)


def metrics_history_interval_ms() -> int:
    return max(0, _read("tidb_tpu_metrics_history_interval_ms"))


def metrics_history_points() -> int:
    return min(max(16, _read("tidb_tpu_metrics_history_points")), 1 << 16)


def runtime_stats_enabled() -> bool:
    return bool(_read("tidb_tpu_runtime_stats"))


def runtime_stats_device() -> bool:
    return bool(_read("tidb_tpu_runtime_stats_device"))


def trace_sample() -> int:
    return max(0, _read("tidb_tpu_trace_sample"))


def slow_trace_ms() -> int:
    return max(0, _read("tidb_tpu_slow_trace_ms"))


def trace_log() -> bool:
    return bool(_read("tidb_tpu_trace_log"))


def failpoints_spec() -> str:
    return str(_read("tidb_tpu_failpoints") or "")
