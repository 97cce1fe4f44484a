"""The general traffic generator: one process of its own, started with
the spawn method, with one thread per client, so that the clients'
packet work does not share the server's interpreter lock.

It reads a traffic mix as plain data (traffic/<mix>.json, turned into a
plan by harness.py) and drives the server over the MySQL wire with the
program's own client (util/mysqlclient.MiniClient). Analytic clients
run a closed loop: each sends its next statement as soon as the last one
returned, rotating through the mix from its own offset.

Times are time.perf_counter() readings, which on Linux are
CLOCK_MONOTONIC and so comparable between the two processes.
"""

from __future__ import annotations

import threading
import time

CONNECT_TIMEOUT_S = 600.0


def _connect(port: int, db: str):
    from tidb_tpu_torch.util.mysqlclient import MiniClient
    c = MiniClient("127.0.0.1", port, db=db)
    c.sock.settimeout(CONNECT_TIMEOUT_S)
    return c


def _analytic(client, stmt, record):
    """One statement: -> the record (name, send, recv, rows or None,
    error or None)."""
    name, sql = stmt
    t0 = time.perf_counter()
    try:
        _cols, rows = client.query(sql)
        err = None
    except Exception as e:  # noqa: BLE001 - an error is a result here
        rows, err = None, f"{type(e).__name__}: {e}"
    record((name, t0, time.perf_counter(), rows, err))


def child_main(plan: dict, conn) -> None:
    """The load process: connect, warm up, report ready, run the window
    it is sent, report every record."""
    try:
        _child(plan, conn)
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        import traceback
        conn.send(("error", f"{type(e).__name__}: {e}\n"
                   + traceback.format_exc()))
        raise
    finally:
        conn.close()


def _child(plan: dict, conn) -> None:
    clients = [_connect(plan["port"], plan["db"]) for _ in plan["clients"]]
    warm: list = []
    mix = plan["statements"]
    # warm-up: the first client runs every statement of the mix
    # warm_runs times (the first run fills the chunk cache, the next the
    # HBM cache), then every client runs each of its statements once
    for _ in range(plan["warm_runs"]):
        for st in mix:
            _analytic(clients[0], st, warm.append)
    for c in clients:
        for st in mix:
            _analytic(c, st, warm.append)
    conn.send(("ready", warm))
    start_at, stop_at = conn.recv()

    records = [[] for _ in clients]

    def analytic_loop(i: int) -> None:
        c = clients[i]
        k = plan["clients"][i]["offset"]
        while time.perf_counter() < start_at:
            time.sleep(min(0.001, max(0.0, start_at - time.perf_counter())))
        while time.perf_counter() < stop_at:
            _analytic(c, mix[k % len(mix)], records[i].append)
            k += 1

    threads = [threading.Thread(target=analytic_loop, args=(i,),
                                name=f"client-{i}")
               for i in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for c in clients:
        c.close()
    conn.send(("done", records))
