"""The bench legs' contracts: the assertions of the JAX package's
`scripts/{serve,chaos,fleet,trace,profile,encoded,multichip,htap}_bench.sh`
as functions over a leg's JSON line.

`check_<leg>(line) -> list[str]` returns the failures, empty when the
line holds, with the scripts' defaults. A failure that is a performance
floor (the fleet's scaling, htap's `vs_read_only`, multichip's per-chip
ratio and serving growth) starts with FLOOR; `invariants` drops those,
the rest are correctness and completeness.
"""

from __future__ import annotations

import os

__all__ = ["FLOOR", "SERVE_P99_FLOOR_MS", "FLEET_SCALING_FLOOR",
           "FLEET_P99_FLOOR_MS", "HTAP_VS_FLOOR", "HTAP_FRESHNESS_CEIL_MS",
           "MULTICHIP_RATIO_FLOOR", "COVERAGE", "CHECKS", "check",
           "invariants", "floors"]

FLOOR = "floor: "
SERVE_P99_FLOOR_MS = 60000.0
COVERAGE = (0.9, 1.1)
FLEET_SCALING_FLOOR = 2.0
FLEET_P99_FLOOR_MS = 60000.0
HTAP_VS_FLOOR = 0.5
HTAP_FRESHNESS_CEIL_MS = 30000.0
MULTICHIP_RATIO_FLOOR = 0.75


def invariants(failures: list[str]) -> list[str]:
    return [f for f in failures if not f.startswith(FLOOR)]


def floors(failures: list[str]) -> list[str]:
    return [f for f in failures if f.startswith(FLOOR)]


def check_serve(line: dict, p99_floor_ms: float = SERVE_P99_FLOOR_MS,
                coverage=COVERAGE) -> list[str]:
    """scripts/serve_bench.sh."""
    out = []
    d = line["detail"]
    if not line["value"] > 0:
        out.append("aggregate rows/sec must be positive")
    for cls, lat in d["concurrent"]["latency"].items():
        if lat["p99_ms"] > p99_floor_ms:
            out.append(f"{cls}: p99 {lat['p99_ms']}ms over the "
                       f"{p99_floor_ms}ms sanity floor")
    pinched = d["pinched"]
    if not pinched["completed"]:
        out.append(f"pinched leg failed: {pinched['errors']}")
    if pinched["oom_cancels"] != 0:
        out.append(f"pinched leg paid {pinched['oom_cancels']} mid-query "
                   f"OOM cancels")
    util = d.get("utilization")
    if not util:
        return out + ["utilization block missing from the serve detail"]
    for key in ("device_busy_fraction", "device_busy_secs",
                "attributed_device_secs", "attribution_coverage",
                "per_class_device_secs"):
        if key not in util:
            out.append(f"utilization block unpopulated: missing {key}")
    if not util.get("device_busy_secs", 0) > 0:
        out.append(f"utilization block unpopulated: zero device busy "
                   f"time ({util})")
    cov = util.get("attribution_coverage")
    if cov is None or not coverage[0] <= cov <= coverage[1]:
        out.append(f"attribution coverage {cov} outside "
                   f"[{coverage[0]}, {coverage[1]}]: per-session metering "
                   f"is leaking ({util})")
    return out


def check_chaos(line: dict) -> list[str]:
    """scripts/chaos_bench.sh."""
    d = line["detail"]
    out = []
    if not d["ops_completed"] > 0:
        out.append("no client ops completed under chaos")
    if not d["writes_completed"] > 0:
        out.append("no HTAP writes completed under chaos")
    if not (d["failpoints_armed"] > 0 and d["failpoint_fires"]):
        out.append("the fault schedule never fired: the run proved nothing")
    if d["wrong_results"]:
        out.append(f"WRONG RESULTS under faults: {d['wrong_results']}")
    if d["non_retryable_errors"]:
        out.append(f"non-retryable errors surfaced: "
                   f"{d['non_retryable_errors']}")
    if d["stuck_statements"]:
        out.append(f"stuck statements: {d['stuck_statements']}")
    if d["oom_cancels"] != 0:
        out.append(f"chaos paid {d['oom_cancels']} mid-query OOM cancels")
    if not d["post_chaos_healthy"]:
        out.append("serving did not recover after disarm")
    if d["sched_inflight_end"] != 0 or d["sched_waiting_end"] != 0:
        out.append("scheduler slots leaked")
    if d["server_ledger_host_end"] != 0 or \
            d["server_ledger_device_end"] != 0:
        out.append("SERVER memtrack ledgers leaked")
    if not d["passed"]:
        out.append("chaos harness reported failure")
    return out


def check_fleet(line: dict, scaling_floor: float = FLEET_SCALING_FLOOR,
                p99_floor_ms: float = FLEET_P99_FLOOR_MS,
                cores: int | None = None) -> list[str]:
    """scripts/fleet_bench.sh (the scaling floor only at 4+ servers on
    4+ cores, as there)."""
    d = line["detail"]
    legs = d.get("legs")
    if not legs:
        return ["fleet detail has no legs block"]
    out = []
    if not line["value"] > 0:
        out.append("aggregate statements/sec must be positive")
    for leg in legs:
        n = leg["servers"]
        if not leg["stmts_per_sec"] > 0:
            out.append(f"leg x{n} unpopulated")
        if not leg["latency"]:
            out.append(f"leg x{n} has no latency block")
        for cls, lat in leg["latency"].items():
            if lat["p99_ms"] > p99_floor_ms:
                out.append(f"x{n} {cls}: p99 {lat['p99_ms']}ms over the "
                           f"{p99_floor_ms}ms sanity floor")
        per = leg.get("per_server")
        if not per or len(per) != n:
            out.append(f"leg x{n} per-server utilization unpopulated")
        elif not sum(s["stmts"] for s in per.values()) > 0:
            out.append(f"leg x{n}: no statements attributed")
    cores = cores if cores is not None else (os.cpu_count() or 1)
    if legs[-1]["servers"] >= 4 and cores >= 4 and \
            d["scaling_max_vs_1"] < scaling_floor:
        out.append(f"{FLOOR}sub-linear collapse: x{legs[-1]['servers']} "
                   f"aggregate is only {d['scaling_max_vs_1']}x the "
                   f"single-server aggregate (floor {scaling_floor}x)")
    coh = d.get("coherence")
    if not coh:
        out.append("coherence counter block missing from the fleet detail")
    elif not sum(c["journal_pulls"] for c in coh.values()) > 0:
        out.append(f"no journal-window pulls recorded: caches are not "
                   f"coherent ({coh})")
    fa = d.get("fleet_attribution")
    if not fa:
        return out + ["fleet_attribution block missing from the fleet "
                      "detail"]
    live = fa.get("live_members") or {}
    util = fa.get("members") or {}
    if not live or not set(util) >= set(live):
        out.append(f"per-member utilization unpopulated: live="
                   f"{sorted(live)} attributed={sorted(util)}")
    if not any(m["statements"] > 0 for m in util.values()):
        out.append(f"no member shows attributed statements: {util}")
    if not fa.get("trace_id", 0) > 0xFFFFFF:
        out.append(f"trace id {fa.get('trace_id')} is not fleet-unique "
                   f"(no nonce)")
    if not fa.get("stitched_store"):
        out.append("store-plane ring record missing origin_trace_id for "
                   "the traced statement")
    return out


def check_trace(line: dict) -> list[str]:
    """scripts/trace_bench.sh."""
    d = line["detail"]
    out = []
    if not d.get("passed"):
        out.append(f"trace bench did not pass: {d}")
    if not line["value"] > 0:
        out.append("no traces retained")
    attr = d.get("latency_attribution", {})
    if not attr.get("q1", {}).get("traces", 0) > 0:
        out.append(f"attribution unpopulated: {attr}")
    return out


def check_profile(line: dict) -> list[str]:
    """scripts/profile_bench.sh."""
    d = line["detail"]
    out = []
    if not d.get("passed"):
        out.append(f"profile bench did not pass: {d.get('failures')}")
    if not line["value"] > 0:
        out.append("no kernel profiles recorded")
    if not d.get("statement_profile_rows", 0) > 0:
        out.append("mode-history memo empty")
    return out


def check_encoded(line: dict) -> list[str]:
    """scripts/encoded_bench.sh."""
    qs = line["detail"]["queries"]
    if not qs:
        return ["no queries ran"]
    out = []
    for name, q in qs.items():
        if q["encoding_fallbacks"] != 0:
            out.append(f"{name}: {q['encoding_fallbacks']} encoding "
                       f"fallback(s)")
        bt = q["bytes_touched"]
        if not bt["decoded_equivalent_bytes"] > 0:
            out.append(f"{name}: bytes_touched not populated ({bt})")
        if not bt["encoded_bytes"] > 0:
            out.append(f"{name}: encoded bytes not counted ({bt})")
    return out


def check_multichip(line: dict,
                    ratio_floor: float = MULTICHIP_RATIO_FLOOR) -> list[str]:
    """scripts/multichip_bench.sh, with `ok` split into what it holds:
    every leg ran with its rows equal (an invariant), no reason="mesh"
    fallback (an invariant), the per-chip ratio and the serving growth
    (floors)."""
    d = line["detail"]
    out = []
    legs = d.get("legs", [])
    if len(legs) != len(d.get("device_counts", ())) or \
            not all(lg.get("ok") for lg in legs):
        out.append(f"a leg did not run or its rows differ: "
                   f"{[(lg.get('n_devices'), lg.get('ok')) for lg in legs]}")
    if not d["checks"]["no_mesh_fallbacks"]:
        out.append('reason="mesh" fallback observed: the unified plane '
                   'must not have a mesh-specific fallback class')
    ratios = d["per_chip_ratio_1_to_n"]
    if not ratios or min(ratios.values()) < ratio_floor:
        out.append(f"{FLOOR}per-chip rows/sec collapsed 1->N: {ratios} "
                   f"(floor {ratio_floor})")
    serve = {int(k): v for k, v in d["serve_aggregate_by_n"].items()}
    ns = sorted(serve)
    if not ns or not serve[ns[-1]] > serve[ns[0]] > 0:
        out.append(f"{FLOOR}serving aggregate did not grow with the mesh: "
                   f"{serve}")
    return out


def check_htap(line: dict, vs_floor: float = HTAP_VS_FLOOR,
               freshness_ceil_ms: float = HTAP_FRESHNESS_CEIL_MS) \
        -> list[str]:
    """scripts/htap_bench.sh."""
    d = line["detail"]
    out = []
    if not line["value"] > 0:
        out.append("analytic rows/sec must be positive")
    nonzero = {int(k): v for k, v in d["rates"].items() if int(k) > 0}
    if not nonzero:
        out.append("sweep must include a nonzero write rate")
    for rate, leg in sorted(d["rates"].items(), key=lambda kv: int(kv[0])):
        if leg["errors"]:
            out.append(f"rate {rate}: errors {leg['errors']}")
        if leg["delta"]["hbm_misses"] != 0:
            out.append(f"rate {rate}: HBM cache re-colded ({leg['delta']})")
        if int(rate) > 0:
            if not leg["delta"]["served_with_delta"] > 0:
                out.append(f"rate {rate}: no reads served as base+delta")
            fmax = leg["freshness_ms_max"]
            if fmax is not None and fmax > freshness_ceil_ms:
                out.append(f"rate {rate}: freshness lag {fmax}ms over the "
                           f"{freshness_ceil_ms}ms ceiling")
    ratios = [v["vs_read_only"] for v in nonzero.values()
              if v["vs_read_only"] is not None]
    if not ratios:
        out.append("no read-only baseline ran: include rate 0 in the "
                   "rates")
    elif max(ratios) < vs_floor:
        out.append(f"{FLOOR}best nonzero-rate analytic throughput "
                   f"{max(ratios)} of read-only (< {vs_floor}: the write "
                   f"cliff is back)")
    return out


CHECKS = {"serve": check_serve, "chaos": check_chaos, "fleet": check_fleet,
          "trace": check_trace, "profile": check_profile,
          "encoded": check_encoded, "multichip": check_multichip,
          "htap": check_htap}


def check(leg: str, line: dict) -> list[str]:
    """check_<leg>(line); a line missing a key the contract reads fails
    with that key named."""
    try:
        return CHECKS[leg](line)
    except (KeyError, TypeError) as e:
        return [f"{leg}: the line lacks what its contract reads: {e!r}"]
