"""In-process metrics history: a bounded time-series ring + sampler.

metrics.py is deliberately instantaneous — counters accumulate, gauges
are last-write-wins, and the /metrics endpoint assumes an EXTERNAL
scraper keeps the history. Nothing in-process could answer "how busy
was the device over the last minute" or "is the HBM hit rate decaying",
which is exactly what the adaptive-runtime items (ROADMAP 2 and 3, per
the hash-vs-sort study arxiv 2411.13245) and the serve bench's
utilization audit need. This module keeps that history in-process:

* a background sampler — supervised per util/supervisor.py, so a
  crashing beat restarts counted instead of dying silently — snapshots
  every registered gauge plus DERIVED series each
  `tidb_tpu_metrics_history_interval_ms`:
    - `tidb_tpu_device_utilization_ratio`: the resource meter's SERVER
      device busy-ns delta over the wall interval (meter.py);
      also published as a live gauge,
    - `tidb_tpu_hbm_occupancy_ratio`: HBM cache resident bytes over
      budget (live gauge too),
    - `hbm_hit_ratio`: cache hits over lookups within the interval,
    - memtrack SERVER host/device ledger bytes;
* each tick also calls `meter.roll_interval()`, so the per-tenant
  "current interval" numbers in information_schema.resource_usage and
  GET /top describe the same wall window as the history point;
* the ring is bounded by `tidb_tpu_metrics_history_points` and billed
  to a `metrics-history` memtrack SERVER node with a registered shed
  action — admission shedding and GET /shed reclaim retained points
  like any other server-scope residency (trace-ring discipline).

`sample_now()` is the deterministic door: tests and bench call it to
record a point (and roll the meter intervals) without waiting out the
cadence. Served as JSON on `GET /metrics/history` (server/status.py).
"""

from __future__ import annotations

import threading
import time

from tidb_tpu_torch import config, memtrack, meter, metrics

__all__ = ["ensure_started", "sample_now", "series", "points",
           "stats", "shed", "reset_for_tests"]

# fixed supervisor tick: each beat checks whether a sample is due
# against the (live-settable) interval sysvar, so SET takes effect
# without restarting the worker thread
_TICK_S = 0.25

# rough per-point retention cost billed to the memtrack node: a dict of
# ~a-few-dozen float series plus the key strings
_POINT_EST_BYTES = 96


class _Ring:
    """Sampled points, oldest first, bounded by the points sysvar and
    billed to the `metrics-history` memtrack SERVER node. The shed
    action clears it (GET /shed, admission shedding)."""

    def __init__(self):
        self._mu = threading.Lock()
        # (t_unix, point, billed_cost), oldest first
        self._points: list[tuple[float, dict, int]] = []  # guarded-by: _mu
        self._bytes = 0                               # guarded-by: _mu
        self._node = None                             # guarded-by: _mu

    def _tracker(self):
        with self._mu:
            if self._node is None:
                self._node = memtrack.server_node("metrics-history")
                self._node.add_spill_action(self.shed)
            return self._node

    def append(self, t: float, point: dict) -> None:
        cost = _POINT_EST_BYTES * max(len(point), 1)
        node = self._tracker()
        # lint: exempt[paired-resource] ownership transfer: point bytes release on evict (below) / shed / reset
        node.consume(host=cost)
        cap = config.metrics_history_points()
        evicted = 0
        with self._mu:
            self._points.append((t, point, cost))
            self._bytes += cost
            while len(self._points) > cap:
                _t, _p, old_cost = self._points.pop(0)
                self._bytes -= old_cost
                evicted += old_cost
        if evicted:
            node.release(host=evicted)

    def shed(self) -> int:
        """Drop every retained point (the memtrack shed action).
        -> bytes freed."""
        with self._mu:
            freed = self._bytes
            self._points.clear()
            self._bytes = 0
            node = self._node
        if node is not None and freed:
            node.release(host=freed)
        return freed

    def points(self) -> list[tuple[float, dict]]:
        with self._mu:
            return [(t, p) for t, p, _c in self._points]

    def stats(self) -> dict:
        with self._mu:
            return {"points": len(self._points), "bytes": self._bytes}


_RING = _Ring()

_state_mu = threading.Lock()
_started = False                 # guarded-by: _state_mu
_stop: threading.Event | None = None   # guarded-by: _state_mu
# previous-tick baselines for the derived rate series
_prev_mu = threading.Lock()
_prev: dict = {}                 # guarded-by: _prev_mu


def _hbm_counter_totals() -> tuple[int, int]:
    snap = metrics.snapshot()
    return (int(snap.get(metrics.HBM_CACHE_HITS, 0)),
            int(snap.get(metrics.HBM_CACHE_MISSES, 0)))


def sample_now() -> dict:
    """Record one history point NOW (and roll the per-tenant meter
    interval baselines): derived utilization/occupancy/hit-rate series
    plus a copy of every registered gauge. Returns the point."""
    now_wall = time.time()
    now_ns = time.perf_counter_ns()
    server_device_ns = meter.SERVER.totals()["device_ns"]
    hits, misses = _hbm_counter_totals()
    chip_busy = _chip_busy_ns()
    with _prev_mu:
        prev = dict(_prev)
        _prev.update(t_ns=now_ns, device_ns=server_device_ns,
                     hbm_hits=hits, hbm_misses=misses,
                     chip_ns=chip_busy)
    point: dict = {}
    wall_ns = now_ns - prev.get("t_ns", now_ns)
    if wall_ns > 0:
        util = (server_device_ns - prev.get("device_ns", 0)) / wall_ns
        point["tidb_tpu_device_utilization_ratio"] = round(max(util, 0.0), 6)
        lookups = (hits - prev.get("hbm_hits", 0)) + \
            (misses - prev.get("hbm_misses", 0))
        point["hbm_hit_ratio"] = round(
            (hits - prev.get("hbm_hits", 0)) / lookups, 6) \
            if lookups > 0 else 0.0
        metrics.gauge(metrics.DEVICE_UTILIZATION,
                      point["tidb_tpu_device_utilization_ratio"])
        # per-chip slot busy-time ratios (the scheduler's placement
        # signal as a series; label cardinality = the plane's device
        # count). The gauges ride into the point via gauges_snapshot.
        prev_chip = prev.get("chip_ns", {})
        for c, ns in sorted(chip_busy.items()):
            ratio = max(ns - prev_chip.get(c, 0), 0) / wall_ns
            metrics.gauge(metrics.CHIP_UTILIZATION, round(ratio, 6),
                          {"chip": c})
    budget = config.device_cache_bytes()
    resident = _hbm_resident_bytes()
    point["tidb_tpu_hbm_occupancy_ratio"] = \
        round(resident / budget, 6) if budget > 0 else 0.0
    metrics.gauge(metrics.HBM_OCCUPANCY,
                  point["tidb_tpu_hbm_occupancy_ratio"])
    point["server_host_bytes"] = memtrack.SERVER.host
    point["server_device_bytes"] = memtrack.SERVER.device
    # every registered gauge rides along (cardinality is bounded by the
    # metric-cardinality lint, so this stays a few dozen series)
    point.update(metrics.gauges_snapshot())
    meter.roll_interval()
    _RING.append(now_wall, point)
    return point


def _hbm_resident_bytes() -> int:
    from tidb_tpu_torch.store import device_cache
    return device_cache.tracker().device


def _chip_busy_ns() -> dict:
    from tidb_tpu_torch import sched
    return sched.device_scheduler().chip_busy_ns()


_last_sample_ns = 0.0
_beat_mu = threading.Lock()


def _beat() -> None:
    """One supervisor tick: sample when the cadence sysvar says a point
    is due; an interval of 0 idles the sampler without stopping the
    (cheap) tick."""
    global _last_sample_ns
    interval_ms = config.metrics_history_interval_ms()
    if interval_ms <= 0:
        return
    with _beat_mu:
        now = time.perf_counter_ns()
        if now - _last_sample_ns < interval_ms * 1e6:
            return
        _last_sample_ns = now
    sample_now()


def ensure_started() -> None:
    """Start the supervised sampler thread once per process (idempotent;
    Server.start / StatusServer.start / the bench legs call it)."""
    global _started, _stop
    with _state_mu:
        if _started:
            return
        _started = True
        _stop = threading.Event()
        from tidb_tpu_torch.util import supervisor
        supervisor.supervise("metrics-history", _beat, _stop, _TICK_S)


def series(names: list[str] | None = None) -> dict:
    """{series_name: [[unix_seconds, value], ...]} over the retained
    window (the GET /metrics/history payload). A point that lacks a
    series (gauge not yet written at that tick) skips that timestamp."""
    out: dict[str, list] = {}
    for t, point in _RING.points():
        for name, v in point.items():
            if names is not None and name not in names:
                continue
            out.setdefault(name, []).append([round(t, 3), v])
    return out


def points() -> list[tuple[float, dict]]:
    return _RING.points()


def stats() -> dict:
    st = _RING.stats()
    st["interval_ms"] = config.metrics_history_interval_ms()
    return st


def shed() -> int:
    return _RING.shed()


def reset_for_tests() -> None:
    """Clear the ring and the rate baselines (test isolation); the
    sampler thread, if started, keeps running — it is allowlisted
    long-lived infrastructure (util/testleak.py)."""
    _RING.shed()
    with _prev_mu:
        _prev.clear()
