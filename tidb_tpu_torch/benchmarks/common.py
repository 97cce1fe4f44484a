"""Helpers shared by the port's bench legs (`tidb_tpu_torch.bench` and
the modules of `tidb_tpu_torch/benchmarks/` it dispatches to).

The port's copies of the JAX package's `bench.py` helpers: row equality
across the two execution modes and across the wire, best-of timing, the
metrics counters each leg diffs, latency percentiles, the per-phase
latency attribution from the trace ring, the resource meter's
utilization block and the Chrome trace-event schema check. Numbers are
returned unrounded.
"""

from __future__ import annotations

import math
import sys
import time

__all__ = ["TABLE_PREFIX", "rows_equal", "time_query",
           "hbm_counters", "query_bytes", "bytes_counters", "bytes_touched",
           "fallback_counters", "fallbacks_by_reason", "percentile",
           "lat_summary", "trace_mark", "trace_attribution", "meter_mark",
           "utilization_block", "metric_total", "validate_chrome",
           "parse_cell", "rows_match", "geomean", "progress_printer",
           "point_sql"]

TABLE_PREFIX = {"region": "r_", "nation": "n_", "customer": "c_",
                "supplier": "s_", "orders": "o_", "lineitem": "l_"}

def point_sql(k: int) -> str:
    """The serve, fleet, trace and chaos legs' point lookup
    (bench.py:958)."""
    return ("SELECT o_custkey, o_orderpriority FROM orders "
            f"WHERE o_orderkey = {k}")


def rows_equal(a, b) -> bool:
    """Device and host rows agree: exact, floats within 1e-9 relative."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                fx, fy = float(x), float(y)
                if abs(fx - fy) > max(1e-6, abs(fy) * 1e-9):
                    return False
            elif x != y:
                return False
    return True


def time_query(session, sql: str, iters: int) -> tuple[float, list]:
    """-> (best seconds, rows) over `iters` full Session.query runs."""
    best, rows = math.inf, None
    for _ in range(iters):
        t0 = time.perf_counter()
        r = session.query(sql)
        best = min(best, time.perf_counter() - t0)
        rows = r.rows
    return best, rows


def hbm_counters() -> dict:
    from tidb_tpu_torch import metrics
    snap = metrics.snapshot()
    return {"hits": int(snap.get(metrics.HBM_CACHE_HITS, 0)),
            "misses": int(snap.get(metrics.HBM_CACHE_MISSES, 0)),
            "evictions": int(snap.get(metrics.HBM_CACHE_EVICTIONS, 0))}


def query_bytes(data, qname: str) -> int:
    """Bytes the query's input tables occupy in the columnar layout:
    8-byte lanes for fixed-width columns, utf8 length for strings."""
    import numpy as np
    from tidb_tpu_torch.benchmarks import tpch
    total = 0
    for tname in tpch.QUERY_TABLES[qname]:
        pref = TABLE_PREFIX[tname]
        for name in vars(data):
            if not name.startswith(pref):
                continue
            a = np.asarray(getattr(data, name))
            if a.ndim != 1:
                continue
            if a.dtype == np.dtype(object):
                total += int(sum(len(str(x)) for x in a))
            else:
                total += int(a.size * 8)
    return total


def bytes_counters() -> dict:
    """Encoded bytes the device dispatches staged against their decoded
    equivalent (the bytes_touched block diffs these)."""
    from tidb_tpu_torch import metrics
    snap = metrics.snapshot()
    return {"encoded": int(snap.get(metrics.BYTES_ENCODED, 0)),
            "decoded_equivalent": int(
                snap.get(metrics.BYTES_DECODED_EQUIV, 0))}


def bytes_touched(b0: dict, b1: dict) -> dict:
    enc = b1["encoded"] - b0["encoded"]
    dec = b1["decoded_equivalent"] - b0["decoded_equivalent"]
    return {"decoded_equivalent_bytes": dec, "encoded_bytes": enc,
            "ratio": enc / dec if dec else None}


def _prefix_total(snap: dict, prefix: str) -> int:
    return int(sum(v for k, v in snap.items() if k.startswith(prefix)))


def fallback_counters() -> dict:
    """Device->host fallbacks, partitions spilled under quota and the
    heavy-hitter lane's rows."""
    from tidb_tpu_torch import metrics
    snap = metrics.snapshot()
    return {"fallbacks": _prefix_total(snap, metrics.DEVICE_FALLBACKS),
            "partitions_spilled": _prefix_total(
                snap, metrics.JOIN_SPILL_PARTITIONS),
            "hot_lane_rows": _prefix_total(snap, metrics.JOIN_HOT_ROWS)}


def fallbacks_by_reason(snap: dict | None = None) -> dict:
    """{reason: count} of the device-fallback counter family."""
    from tidb_tpu_torch import metrics
    if snap is None:
        snap = metrics.snapshot()
    out: dict = {}
    for k, v in snap.items():
        if k.startswith(metrics.DEVICE_FALLBACKS) and 'reason="' in k:
            reason = k.split('reason="')[1].split('"')[0]
            out[reason] = out.get(reason, 0) + int(v)
    return out


def percentile(xs: list, p: float) -> float:
    """Nearest-rank percentile over a non-empty list: the
    ceil(p/100 * n)-th smallest value."""
    ys = sorted(xs)
    i = min(math.ceil(p / 100.0 * len(ys)) - 1, len(ys) - 1)
    return ys[max(i, 0)]


def lat_summary(lat: dict) -> dict:
    """{class: seconds} -> {class: count, p50_ms, p99_ms}."""
    return {cls: {"count": len(xs),
                  "p50_ms": percentile(xs, 50) * 1e3,
                  "p99_ms": percentile(xs, 99) * 1e3}
            for cls, xs in lat.items() if xs}


def trace_mark() -> int:
    """The highest retained trace id now (ids are monotone): a later
    ring_records(mark) returns only the leg's traces."""
    from tidb_tpu_torch import trace
    return max((r["trace_id"] for r in trace.ring_records()), default=0)


def trace_attribution(mark: int, class_digests: dict) -> dict:
    """Per class (digest -> class name; other digests under "other_sql")
    of the traces retained since `mark`: p50/p99 per lifecycle phase
    (trace.phases_of), of the statement, and the tail's coverage (every
    phase over the statement's p99) and attribution (the named phases
    only)."""
    from tidb_tpu_torch import trace
    by_cls: dict = {}
    for rec in trace.ring_records(mark):
        cls = class_digests.get(rec["digest"], "other_sql")
        by_cls.setdefault(cls, []).append(trace.phases_of(rec["root"]))
    out: dict = {}
    for cls, phs in sorted(by_cls.items()):
        block: dict = {"traces": len(phs)}
        phase_keys = [k for k in phs[0] if k != "total"]
        for key in phase_keys:
            xs = [p[key] / 1e9 for p in phs]
            block[key] = {"p50_ms": percentile(xs, 50) * 1e3,
                          "p99_ms": percentile(xs, 99) * 1e3}
        totals = [p["total"] / 1e9 for p in phs]
        block["statement"] = {"p50_ms": percentile(totals, 50) * 1e3,
                              "p99_ms": percentile(totals, 99) * 1e3}
        p99 = block["statement"]["p99_ms"]
        if p99 > 0:
            block["p99_coverage"] = sum(
                block[k]["p99_ms"] for k in phase_keys) / p99
            block["p99_attributed"] = sum(
                block[k]["p99_ms"] for k in phase_keys if k != "other") / p99
        out[cls] = block
    return out


def meter_mark() -> dict:
    """The resource meter before a leg: SERVER totals, per-session and
    per-digest device time (utilization_block diffs against it)."""
    from tidb_tpu_torch import meter
    return {"t": time.perf_counter(),
            "server": meter.server_snapshot(),
            "sessions": {s["session_id"]: s["device_ns"]
                         for s in meter.sessions_snapshot()},
            "digests": {d["digest"]: d["device_ns"]
                        for d in meter.digests_snapshot()}}


def utilization_block(mark: dict, class_digests: dict | None = None,
                      wall_secs: float | None = None) -> dict:
    """The leg's device busy fraction over its wall time, device seconds
    per class (digest deltas through `class_digests`) and the
    attribution coverage: the per-session device time over the SERVER
    total, which the serve contract holds to [0.9, 1.1]."""
    from tidb_tpu_torch import meter, metrics_history
    metrics_history.sample_now()
    wall = wall_secs if wall_secs is not None \
        else time.perf_counter() - mark["t"]
    server = meter.server_snapshot()
    busy_ns = server["device_ns"] - mark["server"]["device_ns"]
    host_ns = server["host_fallback_ns"] - mark["server"]["host_fallback_ns"]
    prev = mark["sessions"]
    attributed_ns = sum(s["device_ns"] - prev.get(s["session_id"], 0)
                        for s in meter.sessions_snapshot())
    out = {"wall_secs": wall,
           "device_busy_secs": busy_ns / 1e9,
           "device_busy_fraction": busy_ns / (wall * 1e9) if wall > 0
           else 0.0,
           "host_fallback_secs": host_ns / 1e9,
           "attributed_device_secs": attributed_ns / 1e9,
           "attribution_coverage": attributed_ns / busy_ns if busy_ns > 0
           else 1.0}
    if class_digests:
        prev_d = mark["digests"]
        per_class: dict = {}
        for d in meter.digests_snapshot():
            cls = class_digests.get(d["digest"])
            if cls is None:
                continue
            delta = d["device_ns"] - prev_d.get(d["digest"], 0)
            per_class[cls] = per_class.get(cls, 0.0) + delta / 1e9
        out["per_class_device_secs"] = dict(sorted(per_class.items()))
    return out


def metric_total(snap: dict, name: str):
    """One counter family summed over its label sets in a flat
    metrics.snapshot() (keys look like 'name{label="v"}')."""
    return sum(v for k, v in snap.items()
               if k == name or k.startswith(name + "{"))


def validate_chrome(doc: dict) -> None:
    """Chrome trace-event schema check (what Perfetto loads): raises
    RuntimeError on a violation."""
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise RuntimeError("chrome export: traceEvents missing/empty")
    if not any(e.get("ph") == "X" for e in evs):
        raise RuntimeError("chrome export: no complete (X) span events")
    for e in evs:
        if e.get("ph") not in ("X", "i", "M"):
            raise RuntimeError(f"chrome export: bad ph in {e!r}")
        if not isinstance(e.get("name"), str) or \
                not isinstance(e.get("pid"), int) or \
                not isinstance(e.get("tid"), int):
            raise RuntimeError(f"chrome export: bad name/pid/tid {e!r}")
        if e["ph"] in ("X", "i") and not isinstance(e.get("ts"),
                                                    (int, float)):
            raise RuntimeError(f"chrome export: bad ts in {e!r}")
        if e["ph"] == "X" and (not isinstance(e.get("dur"), (int, float))
                               or e["dur"] < 0):
            raise RuntimeError(f"chrome export: bad dur in {e!r}")


def parse_cell(x):
    """A text-protocol cell as int, float or str."""
    if isinstance(x, (bytes, bytearray)):
        x = x.decode()
    if isinstance(x, str):
        try:
            return int(x)
        except ValueError:
            pass
        try:
            return float(x)
        except ValueError:
            return x
    return x


def rows_match(got, want, cols=None) -> bool:
    """Row equality across the wire (text cells) and the two execution
    modes: numeric cells within 1e-6 relative (1e-5 absolute), the rest
    exact; with `cols`, only those column indexes."""
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for i in range(len(rg)) if cols is None else cols:
            x, y = parse_cell(rg[i]), parse_cell(rw[i])
            if isinstance(x, float) or isinstance(y, float):
                try:
                    fx, fy = float(x), float(y)
                except (TypeError, ValueError):
                    return False
                if abs(fx - fy) > max(1e-5, abs(fy) * 1e-6):
                    return False
            elif x != y:
                return False
    return True


def geomean(xs) -> float:
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs)) if xs else 0.0


def progress_printer(leg: str):
    """-> progress(msg): `[leg +seconds] msg` on stderr."""
    t_start = time.perf_counter()

    def progress(msg: str) -> None:
        print(f"[{leg} +{time.perf_counter() - t_start:7.1f}s] {msg}",
              file=sys.stderr, flush=True)
    return progress
