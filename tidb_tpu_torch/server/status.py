"""HTTP status server: the port of the JAX package's server/status.py.

/status, /metrics (Prometheus text), /metrics/history, /profile,
/failpoint (GET lists, POST arms), /top, /shed, the trace ring (/trace
lists the retained traces, /trace/<id> serves one span tree,
/trace/<id>/chrome its Chrome trace-event JSON) and the region/MVCC
debug API. Ref: server/http_status.go (the :10080 admin API) and
server/region_handler.go:73-91 (table regions, MVCC forensics by key and
by start_ts).

The reference's fleet routes (/cluster/state, /fleet/*, /fleet/trace)
read the membership registry, which is not ported: they answer 404, as
any unknown path does. /metrics carries no member identity stamp, and
/status and /profile no XLA compile-cache counters."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tidb_tpu_torch import __version__, metrics, tablecodec

__all__ = ["StatusServer"]


def _hex(b: bytes) -> str:
    return b.hex()


def _region_json(r) -> dict:
    return {"id": r.id, "start_key": _hex(r.start), "end_key": _hex(r.end),
            "version": r.version, "conf_ver": r.conf_ver,
            "leader_store": r.leader_store,
            "peer_stores": list(r.peer_stores)}


def _jsonable(v):
    if isinstance(v, bytes):
        return _hex(v)
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def _all_regions(storage) -> list:
    cluster = storage.cluster
    fn = getattr(cluster, "all_regions", None)
    return fn() if fn is not None else []


class _Handler(BaseHTTPRequestHandler):
    server_version = "tidb-tpu-status"

    def log_message(self, fmt, *args):  # quiet
        pass

    # -- route helpers -------------------------------------------------------

    def _json(self, obj, code: int = 200) -> None:
        body = json.dumps(obj, indent=2).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _table_info(self, db: str, name: str):
        from tidb_tpu_torch.session import Domain
        dom = Domain.get(self.server.ctx_storage)
        return dom.info_schema().table(db, name)

    def _table_regions(self, db: str, name: str):
        info = self._table_info(db, name)
        lo, hi = tablecodec.table_prefix_range(info.id)
        out = []
        for r in _all_regions(self.server.ctx_storage):
            if (not r.end or r.end > lo) and (not hi or r.start < hi):
                out.append(_region_json(r))
        return {"table": f"{db}.{name}", "table_id": info.id,
                "record_prefix": _hex(tablecodec.record_prefix(info.id)),
                "regions": out}

    def _mvcc_key(self, db: str, name: str, handle: int):
        info = self._table_info(db, name)
        key = tablecodec.record_key(info.id, handle)
        st = self.server.ctx_storage
        out = st.shim.mvcc_by_key(key)
        out = _jsonable(out)
        out["table"] = f"{db}.{name}"
        out["handle"] = handle
        return out

    # -- dispatch ------------------------------------------------------------

    def do_GET(self):  # noqa: N802 - stdlib API
        st = self.server.ctx_storage
        parts = [p for p in self.path.split("/") if p]
        try:
            if self.path == "/metrics":
                body = metrics.expose().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path in ("/", "/status"):
                from tidb_tpu_torch import profiler, sched
                self._json({
                    "version": __version__,
                    "connections": len(getattr(self.server.ctx_server,
                                               "_conns", ())),
                    "regions": len(_all_regions(st)),
                    "serving": sched.stats(),
                    "kernel_profile": profiler.stats(),
                    "metrics": metrics.snapshot(),
                })
                return
            if self.path == "/profile":
                # the kernel profiling plane (profiler.py): per-kernel
                # compile/dispatch/roofline rows, the compile-cache
                # counters they attribute against, the per-digest
                # mode-history memo, and the platform roofline estimate
                # the fractions are normalized by
                from tidb_tpu_torch import perfschema, profiler
                gbps, src = profiler.platform_peak_gbps()
                self._json({
                    "stats": profiler.stats(),
                    "kernel_profile": profiler.snapshot(),
                    "statement_profile": perfschema.memo_snapshot(),
                    "roofline": {"peak_gbps": gbps, "source": src},
                })
                return
            if self.path == "/failpoint":
                # the failpoint registry + armed state (POST arms)
                from tidb_tpu_torch.util import failpoint
                self._json({"registry": failpoint.REGISTRY,
                            "armed": failpoint.armed()})
                return
            if parts and parts[0] == "trace":
                # retained statement traces (trace.py ring):
                # /trace lists summaries, /trace/<id> serves the full
                # span tree, /trace/<id>/chrome the trace-event JSON
                # for Perfetto / chrome://tracing
                from tidb_tpu_torch import trace
                if len(parts) == 1:
                    self._json({"ring": trace.ring_stats(),
                                "traces": trace.ring_snapshot()})
                    return
                rec = trace.ring_get(int(parts[1]))
                if rec is None:
                    self._json({"error": f"no trace {parts[1]} "
                                         f"(evicted or never retained)"},
                               404)
                    return
                if len(parts) == 3 and parts[2] == "chrome":
                    self._json(trace.to_chrome(rec))
                    return
                self._json({"trace_id": rec["trace_id"],
                            "sql": rec["sql"], "digest": rec["digest"],
                            "duration_ns": rec["duration_ns"],
                            "reason": rec["reason"],
                            "spans": trace.tree(rec["root"])})
                return
            if self.path.startswith("/metrics/history"):
                # the in-process time-series ring (metrics_history.py):
                # registered gauges + derived device-utilization / HBM
                # occupancy / hit-rate series sampled on the
                # tidb_tpu_metrics_history_interval_ms cadence
                from tidb_tpu_torch import metrics_history
                self._json({"history": metrics_history.stats(),
                            "series": metrics_history.series()})
                return
            if self.path.startswith("/top"):
                # live utilization: top sessions and statement digests
                # by device busy-time (meter.py) — ranked by the last
                # sampler interval, cumulative as the tiebreak
                from tidb_tpu_torch import meter
                self._json({
                    "server": meter.server_snapshot(),
                    "attributed_device_ns":
                        meter.attributed_device_ns(),
                    "sessions": meter.top_sessions(),
                    "users": meter.users_snapshot(),
                    "digests": meter.top_digests(),
                })
                return
            if self.path == "/shed":
                # administrative shed hook (the KILL-style escape hatch):
                # drives the SERVER memtrack root's registered shed chain
                # — HBM cache blocks, running statements' spill actions —
                # the same chain admission control fires on projected
                # overflow, here on operator demand
                from tidb_tpu_torch import sched
                self._json({"freed_bytes": sched.shed_server(0)})
                return
            if parts == ["regions"]:
                self._json([_region_json(r) for r in _all_regions(st)])
                return
            if len(parts) == 2 and parts[0] == "regions":
                rid = int(parts[1])
                for r in _all_regions(st):
                    if r.id == rid:
                        self._json(_region_json(r))
                        return
                self._json({"error": f"no region {rid}"}, 404)
                return
            if len(parts) == 4 and parts[0] == "tables" \
                    and parts[3] == "regions":
                self._json(self._table_regions(parts[1], parts[2]))
                return
            if len(parts) == 5 and parts[:2] == ["mvcc", "key"]:
                self._json(self._mvcc_key(parts[2], parts[3],
                                          int(parts[4])))
                return
            if len(parts) == 3 and parts[:2] == ["mvcc", "txn"]:
                hits = st.shim.mvcc_by_start_ts(int(parts[2]))
                self._json([{"key": _hex(k), "mvcc": _jsonable(m)}
                            for k, m in hits])
                return
        except Exception as e:  # noqa: BLE001 - debug API reports errors
            self._json({"error": str(e)}, 500)
            return
        self.send_error(404)

    def do_POST(self):  # noqa: N802 - stdlib API
        """POST /failpoint {"name": ..., "spec": ...} arms one declared
        failpoint (util/failpoint.py); spec null/"" disarms it. The
        HTTP face of the same registry env/SET arming drives — the
        gofail-endpoint analogue for chaos tooling."""
        if self.path != "/failpoint":
            self.send_error(404)
            return
        from tidb_tpu_torch.util import failpoint
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            name = body["name"]
            spec = body.get("spec")
            if spec:
                failpoint.enable(name, spec)
            else:
                failpoint.disable(name)
            self._json({"ok": True, "armed": failpoint.armed()})
        except failpoint.UnknownFailpointError as e:
            self._json({"error": f"unknown failpoint {e}"}, 404)
        except Exception as e:  # noqa: BLE001 - admin API reports errors
            self._json({"error": str(e)}, 400)


class StatusServer:
    def __init__(self, storage, sql_server=None, host: str = "127.0.0.1",
                 port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.ctx_storage = storage
        self._httpd.ctx_server = sql_server
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        # a status port implies an operator watching: make sure the
        # history sampler is recording for /metrics/history
        from tidb_tpu_torch import metrics_history
        metrics_history.ensure_started()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="status-http")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
