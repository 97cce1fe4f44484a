"""The multi-client serving leg: the port's counterpart of the JAX
package's `python bench.py serve` (`_serve_bench`, `serve_main`).

N wire connections (the port's `util/mysqlclient.MiniClient`) replay a
mixed workload against one in-process `Server`: per client and round one
of TPC-H Q1/Q3/Q5 (rotating per client and round, so the classes
overlap across clients) and a burst of point lookups. Three replays of
the same op multiset: serialized on one connection, concurrent on N
(every statement traced, for the latency attribution), and pinched under
a `tidb_tpu_server_mem_quota` around one analytic's peak, where clients
retry the retryable 9008 and the workload must complete with no OOM
cancel. The utilization block covers all three.
"""

from __future__ import annotations

import threading
import time

from tidb_tpu_torch.benchmarks.common import (lat_summary, meter_mark,
                                              point_sql, trace_attribution,
                                              trace_mark, utilization_block)

__all__ = ["METRIC", "OOM_KEY", "client_ops", "run_ops",
           "replay", "run", "line"]

METRIC = "serve_concurrent_rows_per_sec"
OOM_KEY = 'tidb_tpu_mem_quota_exceeded_total{action="cancel"}'


def client_ops(data, ci: int, rounds: int, lookups: int) -> list:
    """Client `ci`'s ops [(class, sql, input rows)]: per round one
    analytic (rotating over q1, q3, q5 by client and round) and
    `lookups` point lookups."""
    from tidb_tpu_torch.benchmarks import tpch
    classes = list(tpch.QUERIES)
    n_orders = data.counts["orders"]
    ops = []
    for r in range(rounds):
        q = classes[(ci + r) % len(classes)]
        ops.append((q, tpch.QUERIES[q],
                    sum(data.counts[t] for t in tpch.QUERY_TABLES[q])))
        for j in range(lookups):
            k = (ci * 7919 + r * 104729 + j * 131) % n_orders
            ops.append(("point", point_sql(k), 1))
    return ops


def run_ops(cli, ops, lat: dict, errors: list, retry_codes,
            counts: dict | None = None) -> None:
    """Run `ops` on `cli`, retrying an error whose code is in
    `retry_codes` after 50 ms (at most 200 times); other errors go to
    `errors`. Latency per class (seconds, retries included) into `lat`;
    `counts["retries"]` counts the retries."""
    from tidb_tpu_torch.util.mysqlclient import MySQLError
    for cls, sql, *_rows in ops:
        t0 = time.perf_counter()
        tries = 0
        while True:
            try:
                cli.query(sql)
                break
            except MySQLError as e:
                if e.code in retry_codes and tries < 200:
                    tries += 1
                    time.sleep(0.05)
                    continue
                errors.append(f"{cls}: ({e.code}) {e}")
                break
        if counts is not None and tries:
            counts["retries"] = counts.get("retries", 0) + tries
        lat.setdefault(cls, []).append(time.perf_counter() - t0)


def replay(new_client, all_ops, retry_codes, name: str) -> tuple:
    """Every client's ops on a connection of its own (new_client(ci)),
    all started together. -> (seconds, {class: [latency s]}, errors,
    retries)."""
    n = len(all_ops)
    lats = [dict() for _ in range(n)]
    errlists = [list() for _ in range(n)]
    counts = [dict() for _ in range(n)]
    clients = [new_client(ci) for ci in range(n)]
    start = threading.Barrier(n + 1)

    def worker(ci: int) -> None:
        start.wait()
        run_ops(clients[ci], all_ops[ci], lats[ci], errlists[ci],
                retry_codes, counts[ci])

    threads = [threading.Thread(target=worker, args=(ci,),
                                name=f"{name}-{ci}") for ci in range(n)]
    try:
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        secs = time.perf_counter() - t0
    finally:
        for c in clients:
            c.close()
    lat: dict = {}
    for d in lats:
        for cls, xs in d.items():
            lat.setdefault(cls, []).extend(xs)
    return (secs, lat, [e for el in errlists for e in el],
            sum(c.get("retries", 0) for c in counts))


def run(progress=None, clients: int = 8, rounds: int = 2, lookups: int = 8,
        sf: float = 0.02, seed: int = 42, device="cuda") -> dict:
    """-> the line's detail. Raises RuntimeError where the serialized or
    the concurrent replay saw an error; the pinched leg records its
    errors (`completed` False)."""
    from tidb_tpu_torch import (config, errcode, memtrack, metrics,
                                perfschema, sched)
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    from tidb_tpu_torch.util.mysqlclient import MiniClient
    progress = progress or (lambda msg: None)
    data = tpch.ScaledTpch(sf, seed)
    storage = new_mock_storage(device=device)
    session = Session(storage)
    server = None
    busy = {errcode.ER_SERVER_BUSY_ADMISSION}
    try:
        session.execute("CREATE DATABASE tpch_serve")
        session.execute("USE tpch_serve")
        progress(f"serve: loading sf={sf} for {clients} clients")
        total_loaded = tpch.load(session, storage, data, regions_per_table=2)
        all_ops = [client_ops(data, ci, rounds, lookups)
                   for ci in range(clients)]
        workload_rows = sum(r for ops in all_ops for _c, _s, r in ops)
        progress("serve: warmup (cache fill)")
        for sql in tpch.QUERIES.values():
            session.query(sql)
        server = Server(storage)
        server.start()

        def new_client(_ci: int = 0) -> MiniClient:
            c = MiniClient("127.0.0.1", server.port, db="tpch_serve")
            c.sock.settimeout(600)
            return c

        out: dict = {"clients": clients, "rounds": rounds,
                     "lookups_per_round": lookups, "sf": sf,
                     "rows_loaded": total_loaded,
                     "ops": sum(len(ops) for ops in all_ops),
                     "workload_rows": workload_rows}
        util_mark = meter_mark()

        progress("serve: serialized replay")
        lat_ser: dict = {}
        errs: list = []
        cli = new_client()
        try:
            t0 = time.perf_counter()
            for ops in all_ops:
                run_ops(cli, ops, lat_ser, errs, busy)
            ser_secs = time.perf_counter() - t0
        finally:
            cli.close()
        if errs:
            raise RuntimeError(f"serialized replay errors: {errs[:3]}")
        out["serialized"] = {"secs": ser_secs,
                             "rows_per_sec": workload_rows / ser_secs,
                             "latency": lat_summary(lat_ser)}

        progress(f"serve: concurrent replay x{clients}")
        sched0 = sched.stats()
        mark = trace_mark()
        sample_prev = config.get_var("tidb_tpu_trace_sample")
        config.set_var("tidb_tpu_trace_sample", 1)
        try:
            conc_secs, lat_conc, errs, _r = replay(new_client, all_ops, busy,
                                                  "serve-client")
        finally:
            config.set_var("tidb_tpu_trace_sample", sample_prev)
        if errs:
            raise RuntimeError(f"concurrent replay errors: {errs[:3]}")
        class_digests = {perfschema.sql_digest(sql)[0]: q
                         for q, sql in tpch.QUERIES.items()}
        # literals normalize away: one digest covers every point lookup
        class_digests[perfschema.sql_digest(point_sql(0))[0]] = "point"
        sched1 = sched.stats()
        conc_rps = workload_rows / conc_secs
        out["concurrent"] = {
            "secs": conc_secs, "rows_per_sec": conc_rps,
            "speedup_vs_serialized": conc_rps / (workload_rows / ser_secs),
            "latency": lat_summary(lat_conc),
            "latency_attribution": trace_attribution(mark, class_digests),
            "sched_stall_seconds": sched1["scheduler"]["stall_seconds"] -
            sched0["scheduler"]["stall_seconds"],
            "sched_bypasses": sched1["scheduler"]["bypasses"] -
            sched0["scheduler"]["bypasses"]}

        peak = max(perfschema.digest_max_mem(sql)
                   for sql in tpch.QUERIES.values())
        resident = memtrack.SERVER.host + memtrack.SERVER.device
        quota = max(peak, resident, 1 << 22)
        progress(f"serve: pinched leg quota={quota} (digest peak {peak}, "
                 f"resident {resident})")
        oom0 = metrics.snapshot().get(OOM_KEY, 0)
        adm0 = sched.stats()["admission"]
        quota_prev = config.get_var("tidb_tpu_server_mem_quota")
        config.set_var("tidb_tpu_server_mem_quota", quota)
        try:
            pinch_secs, lat_p, errs, retries = replay(
                new_client, all_ops, busy, "serve-pinch")
        finally:
            config.set_var("tidb_tpu_server_mem_quota", quota_prev)
        adm1 = sched.stats()["admission"]
        oom1 = metrics.snapshot().get(OOM_KEY, 0)
        out["pinched"] = {
            "quota_bytes": quota, "secs": pinch_secs,
            "rows_per_sec": workload_rows / pinch_secs,
            "latency": lat_summary(lat_p),
            "errors": errs[:5],
            "admission": {k: adm1[k] - adm0[k]
                          for k in ("admitted", "queued", "shed",
                                    "rejected")},
            "admission_shed": adm1["shed"] - adm0["shed"],
            "shed_bytes": adm1["shed_bytes"] - adm0["shed_bytes"],
            "busy_retries": retries,
            "oom_cancels": int(oom1 - oom0),
            "completed": not errs}
        out["utilization"] = utilization_block(util_mark, class_digests)
        progress(f"serve: utilization busy="
                 f"{out['utilization']['device_busy_fraction']} coverage="
                 f"{out['utilization']['attribution_coverage']}")
    finally:
        if server is not None:
            server.close()
        session.close()
        storage.close()
    return out


def line(detail: dict) -> dict:
    """bench.py's line around the detail (bench.py:1181-1189)."""
    conc = detail.get("concurrent", {})
    return {"metric": METRIC, "value": conc.get("rows_per_sec", 0.0),
            "unit": "rows/s",
            "vs_baseline": conc.get("speedup_vs_serialized", 0.0),
            "detail": detail}


if __name__ == "__main__":
    import sys
    from tidb_tpu_torch.bench import leg_main
    raise SystemExit(leg_main("serve", sys.argv[1:]))
