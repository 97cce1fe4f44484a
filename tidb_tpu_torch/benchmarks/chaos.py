"""The chaos serving leg: the port's counterpart of the JAX package's
`python bench.py chaos` (`_chaos_bench`, `chaos_main`).

The serving mix (TPC-H Q1/Q3/Q5, an aggregate over the written `stock`
table and point lookups, over N wire clients) runs beside an HTAP writer
on `stock` while a seeded driver arms and disarms budgeted failpoints
across the device plane: `device/dispatch` faults, `device/finalize`
delays (one past the dispatch watchdog), `hbm/fill` faults, `hbm/patch`
skips, `rpc/request` server-busy bursts, a `delta/merge` crash and
`sched/slot` delays. The detail records, and `passed` requires: no wrong
result against the fault-free references read over the wire (the
written table's write-invariant columns only), no non-retryable error,
no statement past its deadline, no OOM cancel, serving healthy after the
faults are disarmed, and the scheduler's slots and the SERVER ledgers
drained to zero.
"""

from __future__ import annotations

import gc
import random
import threading
import time

import numpy as np

from tidb_tpu_torch.benchmarks.common import (meter_mark, metric_total,
                                              point_sql, rows_match,
                                              trace_attribution, trace_mark,
                                              utilization_block)

__all__ = ["METRIC", "SEED", "STOCK_SQL", "N_STOCK", "schedule",
           "run", "line"]

METRIC = "chaos_ops_completed_under_faults"
SEED = 20260804
N_STOCK = 12000
STOCK_SQL = ("SELECT s_seg, COUNT(*), SUM(s_qty) FROM stock "
             "GROUP BY s_seg ORDER BY s_seg")
OOM_KEY = 'tidb_tpu_mem_quota_exceeded_total{action="cancel"}'


def schedule(rng: random.Random, timeout_ms: int) -> list:
    """The seeded fault schedule: (point, spec factory, hold). hold None
    arms for a short random window; a float holds the arm until its
    budget fires or the hold expires (the watchdog-tripping delay would
    otherwise rarely meet a dispatch in a short window)."""
    return [
        ("device/dispatch",
         lambda: f"{rng.randint(2, 6)}*raise(DeviceFaultError)", None),
        ("device/finalize",
         lambda: f"1-in-{rng.randint(3, 6)}:delay({rng.randint(10, 60)})",
         None),
        ("device/finalize", lambda: f"1*delay({int(timeout_ms * 1.4)})",
         6.0),
        ("hbm/fill", lambda: f"{rng.randint(1, 4)}*raise(DeviceFaultError)",
         2.0),
        ("hbm/patch", lambda: f"{rng.randint(1, 4)}*return(1)", None),
        ("rpc/request",
         lambda: f"{rng.randint(2, 6)}*raise(ServerBusyError)", None),
        ("delta/merge", lambda: "1*raise(RuntimeError:chaos-merge)", 4.0),
        ("sched/slot",
         lambda: f"1-in-{rng.randint(4, 8)}:delay({rng.randint(5, 20)})",
         None),
    ]


def _load(session, storage, sf: float, seed: int) -> int:
    """TPC-H at `sf` and `stock` (s_id, s_seg, s_qty) of N_STOCK rows
    from `seed`. -> the orders count."""
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.table import Table, bulkload
    data = tpch.ScaledTpch(sf, 42)
    tpch.load(session, storage, data, regions_per_table=2)
    session.execute("CREATE TABLE stock (s_id BIGINT PRIMARY KEY, "
                    "s_seg BIGINT, s_qty BIGINT)")
    srng = np.random.default_rng(seed)
    bulkload.bulk_load(storage, Table(session.domain.info_schema().table(
        session.current_db, "stock"), storage), {
        "s_id": np.arange(N_STOCK, dtype=np.int64),
        "s_seg": np.arange(N_STOCK, dtype=np.int64) % 11,
        "s_qty": srng.integers(10, 100, N_STOCK)})
    return data.counts["orders"]


def run(progress=None, seed: int = SEED, clients: int = 4,
        secs: float = 15.0, sf: float = 0.01, writes_per_sec: float = 25.0,
        timeout_ms: int = 3000, stuck_secs: float = 90.0,
        device="cuda") -> dict:
    """-> the line's detail, `passed` among it. Restores the variables
    it sets, disarms every failpoint, and starts and ends with a fresh
    scheduler and health gate (sched.reset_for_tests)."""
    from tidb_tpu_torch import (config, errcode, memtrack, metrics,
                                perfschema, sched)
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.session import Session, SQLError
    from tidb_tpu_torch.store.storage import new_mock_storage
    from tidb_tpu_torch.util import failpoint
    from tidb_tpu_torch.util.mysqlclient import MiniClient, MySQLError
    progress = progress or (lambda msg: None)
    rng = random.Random(seed)
    saved = {k: config.get_var(k) for k in
             ("tidb_tpu_dispatch_timeout_ms", "tidb_tpu_delta_merge_rows",
              "tidb_tpu_failpoints", "tidb_tpu_trace_sample")}
    sched.reset_for_tests()
    storage = new_mock_storage(device=device)
    session = Session(storage)
    server = None
    ok = False
    try:
        session.execute("CREATE DATABASE chaos")
        session.execute("USE chaos")
        progress(f"chaos: loading tpch sf={sf} + stock (seed {seed})")
        n_orders = _load(session, storage, sf, seed)
        analytics = dict(tpch.QUERIES)
        analytics["stock"] = STOCK_SQL
        progress("chaos: warmup + fault-free references")
        for sql in analytics.values():
            session.query(sql)
        server = Server(storage)
        server.start()

        def new_client() -> MiniClient:
            c = MiniClient("127.0.0.1", server.port, db="chaos")
            c.sock.settimeout(stuck_secs)
            return c

        # the references through the clients' own surface (text rows)
        ref_cli = new_client()
        try:
            refs = {cls: ref_cli.query(sql)[1]
                    for cls, sql in analytics.items()}
            point_keys = [(ci * 7919 + j * 131) % n_orders
                          for ci in range(clients) for j in range(8)]
            point_refs = {k: ref_cli.query(point_sql(k))[1]
                          for k in set(point_keys)}
        finally:
            ref_cli.close()

        sched_list = schedule(rng, timeout_ms)
        stop = threading.Event()
        armed_log: list = []

        def chaos_driver() -> None:
            # each epoch arms every entry once, in a seeded order, so the
            # rare entries (the long delay, the merge crash) all fire
            while not stop.is_set():
                order = list(range(len(sched_list)))
                rng.shuffle(order)
                for i in order:
                    if stop.is_set():
                        return
                    name, mk, hold = sched_list[i]
                    spec = mk()
                    failpoint.enable(name, spec)
                    armed_log.append(f"{name}={spec}")
                    if hold is None:
                        stop.wait(rng.uniform(0.1, 0.4))
                    else:
                        end = time.monotonic() + hold
                        while time.monotonic() < end and \
                                name in failpoint.armed() and \
                                not stop.is_set():
                            stop.wait(0.1)
                    failpoint.disable(name)
                    if stop.wait(rng.uniform(0.0, 0.05)):
                        return

        wrong: list = []
        non_retryable: list = []
        stuck: list = []
        ops_done = [0]
        retried = [0]
        mu = threading.Lock()

        def run_op(cli, cls, sql, check) -> None:
            deadline = time.monotonic() + stuck_secs
            while True:
                try:
                    res = cli.query(sql)
                    rows = res[1] if isinstance(res, tuple) else []
                    with mu:
                        if not check(rows):
                            wrong.append(f"{cls}: {rows[:2]!r}")
                        ops_done[0] += 1
                    return
                except MySQLError as e:
                    if not errcode.is_retryable(e.code):
                        non_retryable.append(f"{cls}: ({e.code}) {e}")
                        return
                    with mu:
                        retried[0] += 1
                    if time.monotonic() >= deadline:
                        stuck.append(f"{cls}: retries past {stuck_secs}s")
                        return
                    time.sleep(0.03)
                except OSError as e:
                    stuck.append(f"{cls}: socket {e}")
                    return

        def client_worker(ci: int) -> None:
            cli = new_client()
            classes = list(analytics)
            j = 0
            try:
                while not stop.is_set():
                    cls = classes[(ci + j) % len(classes)]
                    # the written table: only its write-invariant columns
                    # (seg, count) compare
                    cols = (0, 1) if cls == "stock" else None
                    run_op(cli, cls, analytics[cls],
                           lambda rows, c=cls, cols=cols: rows_match(
                               rows, refs[c], cols=cols))
                    for pk in point_keys[ci * 8:(ci + 1) * 8]:
                        if stop.is_set():
                            break
                        run_op(cli, "point", point_sql(pk),
                               lambda rows, k=pk: rows_match(
                                   rows, point_refs[k]))
                    j += 1
            finally:
                try:
                    cli.close()
                except OSError:
                    pass

        write_errs: list = []
        writes_done = [0]

        def writer() -> None:
            ws = Session(storage, db="chaos")
            period = 1.0 / max(writes_per_sec, 1e-6)
            seq = 0
            nxt = time.perf_counter()
            try:
                while not stop.is_set():
                    seq += 1
                    k = (seq * 7919) % N_STOCK
                    try:
                        ws.execute(f"UPDATE stock SET s_qty = s_qty + 1 "
                                   f"WHERE s_id = {k}")
                        writes_done[0] += 1
                    except SQLError as exc:
                        code = errcode.classify(exc)[0]
                        if not errcode.is_retryable(code):
                            write_errs.append(f"({code}) {exc}")
                    nxt += period
                    d = nxt - time.perf_counter()
                    if d > 0:
                        time.sleep(min(d, 0.25))
                    else:
                        nxt = time.perf_counter()
            finally:
                ws.close()

        snap0 = metrics.snapshot()
        config.set_var("tidb_tpu_dispatch_timeout_ms", timeout_ms)
        config.set_var("tidb_tpu_delta_merge_rows", 64)
        # one statement in two traced: where the retries' time went
        config.set_var("tidb_tpu_trace_sample", 2)
        t_mark = trace_mark()
        util_mark = meter_mark()
        progress(f"chaos: {clients} clients + writer + driver for {secs}s "
                 f"(watchdog {timeout_ms}ms)")
        threads = [threading.Thread(target=client_worker, args=(ci,),
                                    name=f"chaos-client-{ci}")
                   for ci in range(clients)]
        threads.append(threading.Thread(target=writer, name="chaos-writer"))
        driver = threading.Thread(target=chaos_driver, name="chaos-driver")
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        driver.start()
        try:
            while time.perf_counter() < t0 + secs:
                time.sleep(0.1)
        finally:
            stop.set()
            driver.join(timeout=10)
            failpoint.disable_all()
            for t in threads:
                t.join(timeout=stuck_secs + 30)
                if t.is_alive():
                    stuck.append(f"thread {t.name} did not drain")
        window = time.perf_counter() - t0
        config.set_var("tidb_tpu_dispatch_timeout_ms", 0)
        digests = {perfschema.sql_digest(sql)[0]: cls
                   for cls, sql in analytics.items()}
        digests[perfschema.sql_digest(point_sql(0))[0]] = "point"
        attribution = trace_attribution(t_mark, digests)
        utilization = utilization_block(util_mark, digests,
                                        wall_secs=window)

        # serving after the faults: every analytic right again
        post_ok = True
        try:
            c = new_client()
            try:
                for cls, sql in analytics.items():
                    cols = (0, 1) if cls == "stock" else None
                    if not rows_match(c.query(sql)[1], refs[cls],
                                      cols=cols):
                        post_ok = False
                        wrong.append(f"post-chaos {cls}")
            finally:
                c.close()
        except (MySQLError, OSError) as e:
            post_ok = False
            wrong.append(f"post-chaos: {e}")
        ok = True
    finally:
        failpoint.disable_all()
        if server is not None:
            server.close()
        session.close()
        if not ok:
            storage.close()
            for k, v in saved.items():
                config.set_var(k, v)
    sched_snap = sched.device_scheduler().snapshot()
    # drain: dead sessions collect, forced merges and HBM sheds return
    # every server-scope byte
    deadline = time.time() + 10.0
    while (memtrack.SERVER.host or memtrack.SERVER.device) and \
            time.time() < deadline:
        gc.collect()
        sched.shed_server(0)
        time.sleep(0.05)
    ledger_host, ledger_device = memtrack.SERVER.host, memtrack.SERVER.device
    storage.close()
    # the faults leave their counts in the health gate and the scheduler
    # (faults, quarantines, slot history): the caller gets fresh ones, as
    # after the reference's leg, which runs in a process of its own
    sched.reset_for_tests()
    for k, v in saved.items():
        config.set_var(k, v)

    snap1 = metrics.snapshot()

    def delta_of(name: str) -> int:
        return int(metric_total(snap1, name) - metric_total(snap0, name))

    fires = {k.split('name="')[1].split('"')[0]: int(v - snap0.get(k, 0))
             for k, v in snap1.items()
             if k.startswith(metrics.FAILPOINT_FIRES) and
             v - snap0.get(k, 0) > 0}
    fallbacks: dict = {}
    for k, v in snap1.items():
        if k.startswith(metrics.DEVICE_FALLBACKS) and 'reason="' in k:
            reason = k.split('reason="')[1].split('"')[0]
            d = int(v - snap0.get(k, 0))
            if d:
                fallbacks[reason] = fallbacks.get(reason, 0) + d
    out = {
        "seed": seed, "clients": clients, "secs": window,
        "ops_completed": ops_done[0], "writes_completed": writes_done[0],
        "retries": retried[0], "failpoints_armed": len(armed_log),
        "failpoint_fires": fires, "wrong_results": wrong[:10],
        "non_retryable_errors": (non_retryable + write_errs)[:10],
        "stuck_statements": stuck[:10],
        "oom_cancels": int(snap1.get(OOM_KEY, 0) - snap0.get(OOM_KEY, 0)),
        "latency_attribution": attribution, "utilization": utilization,
        "watchdog_fires": delta_of(metrics.DISPATCH_TIMEOUTS),
        "device_fallbacks": fallbacks,
        "quarantines": delta_of(metrics.DEVICE_QUARANTINES),
        "worker_restarts": delta_of(metrics.WORKER_RESTARTS),
        "post_chaos_healthy": post_ok,
        "sched_inflight_end": sched_snap["inflight"],
        "sched_waiting_end": sched_snap["waiting"],
        "server_ledger_host_end": ledger_host,
        "server_ledger_device_end": ledger_device}
    out["passed"] = (not wrong and not non_retryable and not write_errs and
                     not stuck and out["oom_cancels"] == 0 and post_ok and
                     sched_snap["inflight"] == 0 and
                     sched_snap["waiting"] == 0 and ledger_host == 0 and
                     ledger_device == 0 and ops_done[0] > 0 and
                     writes_done[0] > 0)
    progress(f"chaos: {ops_done[0]} ops, {writes_done[0]} writes, "
             f"{len(armed_log)} arms, fires={sum(fires.values())}, "
             f"passed={out['passed']}")
    return out


def line(detail: dict) -> dict:
    """bench.py's line around the detail (bench.py:2367-2374)."""
    return {"metric": METRIC, "value": detail.get("ops_completed", 0),
            "unit": "ops",
            "vs_baseline": 1.0 if detail.get("passed") else 0.0,
            "detail": detail}


if __name__ == "__main__":
    import sys
    from tidb_tpu_torch.bench import leg_main
    raise SystemExit(leg_main("chaos", sys.argv[1:]))
