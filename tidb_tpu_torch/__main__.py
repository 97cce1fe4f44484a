"""The port's server process: `python -m tidb_tpu_torch [flags]`.

The port of the JAX package's __main__.py (reference: TiDB's
tidb-server/main.go:127-152 — flag/config merge, store open, bootstrap,
MySQL wire server + HTTP status server, signal-driven graceful close).
Config precedence: built-in defaults < TIDB_TPU_* environment < --config
TOML file < explicit CLI flags (`--set VAR=V` last).

The store is an in-process mock TiKV store on the CUDA device, and the
process refuses to start where there is none (it never falls back to the
CPU by itself); `--device cpu` runs it on the CPU instead, the port's
counterpart of the reference's JAX_PLATFORMS. `python -m tidb_tpu_torch
storeserve [--device ...]` runs the fleet's store plane
(store/remote.serve_main); `--store HOST:PORT` makes this process a
stateless SQL member over it, with its own chunk and HBM caches on its
device. With the status server up, the process registers in the
membership registry (member.py). The XLA compile-cache report is not
ported. As in the reference, the process installs a device plane
(devplane.py) over every visible device by default, so one card keeps
ndev = 1 and plans are never routed onto a plane; `--mesh N` installs
N shards spread over the visible devices (several may share one card),
`--no-mesh` none.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def _apply_config_file(path: str) -> dict:
    """TOML config tree (ref: config/config.go:29). Returns the flat
    {sysvar_name: value} dict of the [variables] table plus top-level
    server keys."""
    import tomllib
    with open(path, "rb") as f:
        return tomllib.load(f)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tidb_tpu_torch",
        description="HTAP SQL server on a CUDA device (PyTorch port)")
    # None defaults distinguish "flag given" from "use config/default":
    # precedence is defaults < env < config file < explicit flags
    p.add_argument("--host", default=None)
    p.add_argument("-P", "--port", type=int, default=None)
    p.add_argument("--status-port", type=int, default=None)
    p.add_argument("--no-status", action="store_true",
                   help="disable the HTTP status server")
    p.add_argument("--config", help="TOML config file")
    p.add_argument("--device", default="cuda",
                   help="torch device of the store and its kernels "
                        "(default cuda; cpu runs the host path)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="device plane of N shards over the visible "
                        "devices (default: one per device)")
    p.add_argument("--no-mesh", action="store_true")
    p.add_argument("--token-limit", type=int, default=1000,
                   help="max concurrent connections (ref: TokenLimit)")
    p.add_argument("--log-level", default="info")
    p.add_argument("--slow-threshold-ms", type=int, default=None)
    p.add_argument("--set", action="append", default=[], metavar="VAR=V",
                   help="set a tidb_tpu_* sysvar (repeatable)")
    p.add_argument("--store", default=None, metavar="HOST:PORT",
                   help="connect to a store-plane server (fleet mode: "
                        "this process is a stateless SQL server with "
                        "its own coherent caches) instead of hosting an "
                        "in-process store")
    return p


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "storeserve":
        # store-plane server: one MVCCStore + TSO + region map behind
        # the wire protocol, shared by N stateless SQL servers
        from tidb_tpu_torch.store.remote import serve_main
        return serve_main(argv[1:])
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    log = logging.getLogger("tidb_tpu_torch.server")

    from tidb_tpu_torch import config
    if args.config:
        tree = _apply_config_file(args.config)
        for k, v in (tree.get("variables") or {}).items():
            config.set_var(k, v)
        # explicit CLI flags beat the file (main.go:257 overrideConfig)
        if args.host is None:
            args.host = tree.get("host")
        if args.port is None and "port" in tree:
            args.port = int(tree["port"])
        if args.status_port is None and "status_port" in tree:
            args.status_port = int(tree["status_port"])
    args.host = args.host or "127.0.0.1"
    args.port = 4000 if args.port is None else args.port
    args.status_port = 10080 if args.status_port is None \
        else args.status_port
    if args.slow_threshold_ms is not None:
        config.set_var("tidb_tpu_slow_query_ms", args.slow_threshold_ms)
    for kv in args.set:
        name, _, val = kv.partition("=")
        config.set_var(name, val)

    from tidb_tpu_torch.ops.runtime import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        log.error("cannot start: %s (pass --device cpu to serve on the "
                  "CPU)", e)
        return 2
    log.info("device: %s", device)
    from tidb_tpu_torch import profiler
    ks = profiler.stats()
    log.info("kernel profiler: %s (cap %d profiles)",
             "on" if ks["enabled"] else "off", ks["cap"])
    log.info("serving: scheduler inflight=%d (bytes gate %d), "
             "server mem quota=%d (admission %s, timeout %dms)",
             config.sched_inflight(), config.sched_inflight_bytes(),
             config.server_mem_quota(),
             "on" if config.server_mem_quota() else "off",
             config.admission_timeout_ms())
    from tidb_tpu_torch import devplane
    if args.no_mesh:
        devplane.disable_mesh()
    else:
        devplane.enable_mesh(args.mesh, device=device)
        log.info("device mesh: %s", devplane.active_mesh().shape)

    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.server.status import StatusServer
    if args.store:
        from tidb_tpu_torch.store.remote import connect
        h, _, pt = args.store.rpartition(":")
        storage = connect(h or "127.0.0.1", int(pt), local_cache=True,
                          device=device)
        log.info("fleet mode: store plane at %s", args.store)
    else:
        from tidb_tpu_torch.store.storage import new_mock_storage
        storage = new_mock_storage(device=device)
    server = Server(storage, host=args.host, port=args.port,
                    token_limit=args.token_limit)
    server.start()
    log.info("MySQL protocol on %s:%d", args.host, server.port)
    status = None
    if not args.no_status:
        status = StatusServer(storage, server, host=args.host,
                              port=args.status_port)
        status.start()
        log.info("status API on %s:%d", args.host, status.port)
        # fleet membership (member.py): identity = the status port peers
        # fan cluster_* queries out to. The heartbeat publishes through
        # this process's storage: the shared store plane in fleet mode,
        # the in-process store standalone
        from tidb_tpu_torch import member
        member.set_identity(args.host, status.port, "sql")
        member.start_heartbeat(storage)

    stop = threading.Event()

    def _on_signal(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)
    stop.wait()
    log.info("shutting down")
    if status is not None:
        from tidb_tpu_torch import member
        member.stop_heartbeat()
        status.close()
    server.close()
    storage.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
