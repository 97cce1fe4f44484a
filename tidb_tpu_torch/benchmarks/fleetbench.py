"""The fleet scale-out leg: the port's counterpart of the JAX package's
`python bench.py fleet` (`_fleet_bench`, `fleet_main`).

One store-plane process and `servers` stateless SQL members (the port's
`Fleet`, each member with its own coherent chunk and HBM caches on the
fleet's device), TPC-H loaded through a session on the store plane. The
serve leg's mixed workload replays over `clients` wire connections
against the first 1, 2, 4 ... `servers` members: statements/s and p50/p99
per class per leg, and per member its statements and device time from
its `/top`. Then per member the coherence counters, and the cluster
plane end to end: per-member utilization through
`cluster_resource_usage`, and one traced statement on member 0 whose
fleet trace id finds a store-plane record in `cluster_statement_traces`
read from another member.
"""

from __future__ import annotations

import json
import time

from tidb_tpu_torch.benchmarks.common import lat_summary, metric_total
from tidb_tpu_torch.benchmarks.serve import client_ops, replay

__all__ = ["METRIC", "MEMBER_CACHE_BYTES", "leg_counts", "run",
           "line"]

METRIC = "fleet_stmts_per_sec"
# each SQL member's HBM block-cache budget: the store plane and every
# member share one card, each with its own CUDA context
MEMBER_CACHE_BYTES = 2 << 30


def leg_counts(servers: int) -> list[int]:
    """The legs' member counts: 1, 2, 4 up to `servers`, and `servers`."""
    legs = [n for n in (1, 2, 4) if n <= servers]
    if legs[-1] != servers:
        legs.append(servers)
    return legs


def run(progress=None, servers: int = 4, clients: int = 8, rounds: int = 2,
        lookups: int = 8, sf: float = 0.02, seed: int = 42,
        device="cuda") -> dict:
    """-> the line's detail. Raises RuntimeError on a leg's error or
    where the traced statement finds no store-plane record. Stops every
    process it started."""
    from tidb_tpu_torch import errcode
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.fleet import Fleet
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.remote import connect
    from tidb_tpu_torch.util import statusclient
    from tidb_tpu_torch.util.mysqlclient import MiniClient, MySQLError
    progress = progress or (lambda msg: None)
    legs_n = leg_counts(servers)
    data = tpch.ScaledTpch(sf, seed)
    all_ops = [client_ops(data, ci, rounds, lookups)
               for ci in range(clients)]
    total_stmts = sum(len(ops) for ops in all_ops)
    progress(f"fleet: starting store plane + {servers} SQL servers")
    fleet = Fleet(n_sql=servers, device=device,
                  sql_args=["--set", "tidb_tpu_device_cache_bytes="
                            f"{MEMBER_CACHE_BYTES}"])
    out: dict = {"servers": servers, "clients": clients, "rounds": rounds,
                 "lookups_per_round": lookups, "sf": sf,
                 "stmts_per_leg": total_stmts}
    try:
        t0 = time.perf_counter()
        fleet.start()
        fleet.wait_healthy(timeout=120)
        out["start_secs"] = time.perf_counter() - t0

        progress(f"fleet: loading sf={sf} via the store plane")
        storage = connect(fleet.host, fleet.store_port, device=device)
        session = Session(storage)
        try:
            session.execute("CREATE DATABASE tpch_fleet")
            session.execute("USE tpch_fleet")
            out["rows_loaded"] = tpch.load(session, storage, data,
                                           regions_per_table=2)
        finally:
            session.close()
            storage.close()

        def member_client(mi: int) -> MiniClient:
            c = MiniClient(fleet.host, fleet.members[mi].port,
                           db="tpch_fleet")
            c.sock.settimeout(600)
            return c

        def wait_schema(mi: int, timeout: float = 90.0) -> None:
            deadline = time.monotonic() + timeout
            while True:
                try:
                    c = member_client(mi)
                    try:
                        c.query("SELECT COUNT(*) FROM orders")
                        return
                    finally:
                        c.close()
                except (MySQLError, OSError):
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.25)

        progress("fleet: warmup (schema convergence + cache fill)")
        for mi in range(servers):
            wait_schema(mi)
            c = member_client(mi)
            try:
                for sql in tpch.QUERIES.values():
                    c.query(sql)
                c.query("SELECT o_custkey FROM orders WHERE o_orderkey = 1")
            finally:
                c.close()

        def member_mark(mi: int) -> dict:
            m = fleet.members[mi]
            top = statusclient.get_json(fleet.host, m.status_port, "/top",
                                        timeout=15.0)
            status = fleet.health(mi)
            return {"device_ns": top["server"]["device_ns"],
                    "host_ns": top["server"]["host_fallback_ns"],
                    "stmts": metric_total(status["metrics"],
                                          "tidb_tpu_queries_total")}

        legs = []
        for n in legs_n:
            progress(f"fleet: leg x{n} server(s), {clients} clients, "
                     f"{total_stmts} stmts")
            marks = [member_mark(mi) for mi in range(n)]
            secs, lat_all, errs, _r = replay(
                lambda ci, n=n: member_client(ci % n), all_ops,
                errcode.RETRYABLE, "fleet-client")
            if errs:
                raise RuntimeError(f"fleet leg x{n} errors: {errs[:3]}")
            per_server = {}
            for mi in range(n):
                after = member_mark(mi)
                busy = (after["device_ns"] - marks[mi]["device_ns"]) / 1e9
                per_server[str(mi)] = {
                    "stmts": int(after["stmts"] - marks[mi]["stmts"]),
                    "device_busy_secs": busy,
                    "device_busy_fraction": busy / secs if secs > 0
                    else 0.0,
                    "host_fallback_secs": (after["host_ns"] -
                                           marks[mi]["host_ns"]) / 1e9}
            legs.append({"servers": n, "secs": secs,
                         "stmts_per_sec": total_stmts / secs,
                         "latency": lat_summary(lat_all),
                         "per_server": per_server})
        out["legs"] = legs
        out["scaling_max_vs_1"] = \
            legs[-1]["stmts_per_sec"] / legs[0]["stmts_per_sec"]

        coherence = {}
        launches = {}
        for mi in range(servers):
            status = fleet.health(mi)
            snap = status["metrics"]
            coherence[str(mi)] = {
                "journal_pulls": int(metric_total(
                    snap, "tidb_tpu_fleet_journal_pulls_total")),
                "patched_rows": int(metric_total(
                    snap, "tidb_tpu_fleet_journal_patched_rows_total")),
                "local_cop": int(snap.get(
                    'tidb_tpu_fleet_local_cop_total{path="cached"}', 0)),
                "store_cop": int(snap.get(
                    'tidb_tpu_fleet_local_cop_total{path="store"}', 0)),
                "delta_serves": int(metric_total(
                    snap, "tidb_tpu_cache_served_with_delta_total"))}
            launches[str(mi)] = {"segsum_launches":
                                 status.get("segsum_launches", 0),
                                 "segsum_shapes":
                                 status.get("segsum_shapes", [])}
        out["coherence"] = coherence
        store_status = statusclient.get_json(
            fleet.host, fleet.store_status_port, "/status", timeout=5.0)
        launches["store"] = {
            "segsum_launches": store_status.get("segsum_launches", 0),
            "segsum_shapes": store_status.get("segsum_shapes", [])}
        out["kernel_launches"] = launches

        progress("fleet: attribution via cluster_* tables")
        out["fleet_attribution"] = _attribution(
            member_client(0), member_client(1 % servers))
        progress(f"fleet: scaling x{legs_n[-1]} vs x1 = "
                 f"{out['scaling_max_vs_1']}")
    finally:
        fleet.stop()
    return out


def _attribution(c0, c1) -> dict:
    """Per-member utilization through cluster_resource_usage, and one
    traced statement on member 0 (c0) whose fleet trace id finds a
    store-plane record from another member (c1). Closes both clients."""
    try:
        _cols, mrows = c0.query("SELECT member_id, role FROM "
                                "information_schema.cluster_members")
        store_ids = {r[0] for r in mrows if r[1] == "store"}
        _cols, urows = c0.query(
            "SELECT member, device_time_ns, statements, rows_sent FROM "
            "information_schema.cluster_resource_usage "
            "WHERE scope = 'server'")
        members = {r[0]: {"device_time_ns": int(r[1]),
                          "statements": int(r[2]),
                          "rows_sent": int(r[3])} for r in urows}
        _cols, trows = c0.query("TRACE FORMAT='json' SELECT o_custkey "
                                "FROM orders WHERE o_orderkey = 1")
        tid = int(json.loads(trows[0][0])["trace_id"])
        deadline = time.monotonic() + 30
        while True:
            _cols, srows = c1.query(
                "SELECT member, origin_member, trace_id FROM "
                "information_schema.cluster_statement_traces "
                f"WHERE origin_trace_id = {tid}")
            stitched = [{"member": r[0], "origin_member": r[1],
                         "trace_id": int(r[2])} for r in srows]
            if any(r["member"] in store_ids for r in stitched):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"fleet attribution: no store-plane trace record with "
                    f"origin_trace_id={tid} (got {stitched!r})")
            time.sleep(0.25)
        return {"live_members": {r[0]: r[1] for r in mrows},
                "members": members, "trace_id": tid,
                "stitched_records": stitched, "stitched_store": True}
    finally:
        c0.close()
        c1.close()


def line(detail: dict) -> dict:
    """bench.py's line around the detail (bench.py:1479-1487)."""
    legs = detail.get("legs", [])
    return {"metric": METRIC,
            "value": legs[-1]["stmts_per_sec"] if legs else 0.0,
            "unit": "stmts/s",
            "vs_baseline": detail.get("scaling_max_vs_1", 0.0),
            "detail": detail}


if __name__ == "__main__":
    import sys
    from tidb_tpu_torch.bench import leg_main
    raise SystemExit(leg_main("fleet", sys.argv[1:]))
