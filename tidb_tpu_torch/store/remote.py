"""Out-of-process storage: the SQL layer talks to storage over sockets.

The port's copy of the JAX package's store/remote.py. The store plane
hosts its storage, coprocessor kernels and caches on one torch device
(`StorageServer(device=...)`, `serve_main --device`, CUDA unless the
caller asks for the CPU, never a fallback); a fleet SQL server's
`RemoteStorage(local_cache=True)` keeps its own chunk and HBM caches on
its own device.

Reference: TiDB's store/tikv/client.go:36-95 (gRPC connArray of
16 conns per store address — the distributed communication backend),
tikvrpc/tikvrpc.go:31-53 (typed command envelope), region_request.go
(network-error handling + retry). The defining property this restores is
the reference's architecture: a STATELESS SQL layer connected by RPC to a
storage cluster that owns the data, the coprocessor compute, and the TSO.

Wire format: length-prefixed frames, 1-byte status, then a typed
payload encoded by store/wire.py — a closed tag-length-value contract
mirroring the reference's protobuf envelope (tikvrpc.CmdType +
kvproto/tipb messages). Requests carry `u16 Cmd` + an args/kwargs
tuple; responses carry the result value or a registered typed error.
No pickle anywhere on the wire path: decoding cannot execute code, and
malformed frames raise WireError (fuzzed in tests/test_wire.py; the
no-pickle invariant is pinned by the JAX package's `wire-discipline`
lint rule). On-disk snapshots (trusted, local
files we wrote) live in store/snapshot.py.

Streamed coprocessor replies (Cmd.COP_STREAM) are multi-frame: the
server answers one request with STATUS_STREAM_FRAME frames under the
credit-based flow control of store/wire.py — the request carries an
initial window, the server blocks at zero credit until the client
grants more, so a slow consumer backpressures the storage node instead
of buffering whole regions on either side.

Failure semantics (region_request.go's network-error split):
  * connection failure BEFORE the request is written -> retry on a fresh
    connection (nothing executed).
  * failure while awaiting the response -> idempotent commands (reads,
    coprocessor, TSO, region lookup) retry transparently; mutating
    commands surface TimeoutError_ so the 2PC layer runs its
    undetermined-commit protocol (2pc.go:421-431).
"""

from __future__ import annotations

import argparse
import io
import os
import signal
import socket
import struct
import sys
import threading
import time

from tidb_tpu_torch import kv
from tidb_tpu_torch.mockstore.rpc import TimeoutError_
from tidb_tpu_torch.store import wire

__all__ = ["StorageServer", "RemoteStorage", "connect", "serve_main"]

_STATUS_OK = wire.STATUS_OK
_STATUS_ERR = wire.STATUS_ERR
_STATUS_OK_TRACED = wire.STATUS_OK_TRACED   # payload = (result, spans)

# commands safe to re-send after an indeterminate failure
_IDEMPOTENT = {"kv_get", "kv_batch_get", "kv_scan", "kv_scan_lock",
               "coprocessor", "coprocessor_stream", "journal_window",
               "region_by_key", "tso", "kv_cleanup",
               "snapshot_batch_get", "ping", "regions_snapshot",
               # raw ops are idempotent by definition (no MVCC, repeat
               # puts/deletes converge); mvcc_* are pure reads
               "raw_get", "raw_batch_get", "raw_scan", "raw_put",
               "raw_batch_put", "raw_delete", "raw_delete_range",
               "mvcc_by_key", "mvcc_by_start_ts"}

MAX_CONNS = 16   # ref: client.go:37 MaxConnectionCount

# commands that change durable state: replicated to the backup (the
# "log" of primary/backup log shipping). Everything else is a read.
_MUTATING = {"kv_prewrite", "kv_commit", "kv_batch_rollback",
             "kv_resolve_lock", "kv_cleanup", "kv_delete_range", "kv_gc",
             "raw_put", "raw_batch_put", "raw_delete", "raw_delete_range",
             "split", "split_table", "split_region", "bulk_import"}


def _send_frame(sock: socket.socket, status: int, payload: bytes) -> None:
    sock.sendall(struct.pack("<IB", len(payload) + 1, status) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = io.BytesIO()
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("peer closed")
        buf.write(chunk)
        got += len(chunk)
    return buf.getvalue()


def _recv_frame(sock: socket.socket) -> tuple[int, bytes]:
    head = _recv_exact(sock, 5)
    (length, status) = struct.unpack("<IB", head)
    return status, _recv_exact(sock, length - 1)


# ---------------------------------------------------------------------------
# server side

def _adopt_origin(root, flags: dict) -> dict | None:
    """Map a request's forward-propagated trace context (wire.FLAG_ORIGIN)
    onto the local handler root: the originating statement's sampled/
    forced retention decision applies to the storage-side tree too, and
    the origin id/member land as tags so the retained record — and the
    span tree shipped back — carry the fleet-wide join key.
    -> the validated origin dict (None when absent/malformed)."""
    origin = flags.get(wire.FLAG_ORIGIN)
    if not isinstance(origin, dict) or "trace_id" not in origin:
        return None
    try:
        root.tags["origin_trace_id"] = int(origin["trace_id"])
    except (TypeError, ValueError):
        return None
    root.sampled = bool(origin.get("sampled"))
    root.forced = bool(origin.get("forced"))
    root.tags["origin_member"] = str(origin.get("member", ""))
    return origin


class StorageServer:
    """Hosts a full storage node (cluster topology + MVCC engine + RPC
    shim + coprocessor with its device kernels + columnar chunk cache)
    behind a socket. One thread per connection; the shim's own locking
    provides consistency exactly as with in-process threads."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 snapshot_path: str | None = None,
                 role: str = "primary", backup_addr=None,
                 primary_addr=None, device=None):
        from tidb_tpu_torch.store import snapshot as snapshot_io
        from tidb_tpu_torch.store.copr import cop_handler
        from tidb_tpu_torch.store.storage import MockStorage, new_mock_storage
        from tidb_tpu_torch.store.stream import cop_stream_handler
        self.snapshot_path = snapshot_path
        if snapshot_path and os.path.exists(snapshot_path):
            cluster, engine = snapshot_io.load(snapshot_path)
            self.storage = MockStorage(cluster, engine, device=device)
        else:
            self.storage = new_mock_storage(device=device)
        self.storage.shim.install_cop_handler(cop_handler(self.storage))
        self.storage.shim.install_cop_stream_handler(
            cop_stream_handler(self.storage))
        # -- replication (ref: the Raft-replicated TiKV store; here a
        # synchronous primary/backup log-shipping analogue) ---------------
        self.role = role
        self._ship_mu = threading.Lock()   # serializes apply+ship order
        self._backup: _Conn | None = None  # guarded-by: _ship_mu
        self._backup_addr = backup_addr
        self._backup_dead = False          # guarded-by: _ship_mu
        if role == "backup" and primary_addr is not None:
            self._attach_to_primary(primary_addr)
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self._closing = threading.Event()
        self._threads: set = set()         # guarded-by: _mu
        self._mu = threading.Lock()

    # -- replication ---------------------------------------------------------

    def _attach_to_primary(self, primary_addr) -> None:
        """Pull a full state snapshot so a fresh backup starts in sync
        (the primary then ships every mutation as it happens)."""
        conn = _Conn(primary_addr)
        try:
            state = conn.call("repl_snapshot", (), {})
            self._install_state(state)
        finally:
            conn.close()

    def _export_state(self):
        # _ship_mu orders the export against the apply+ship critical
        # section: a mutation is either fully (applied AND shipped)
        # before the snapshot, or entirely after it — never replayed on
        # top of a snapshot that already contains it
        with self._ship_mu:
            return self._export_state_locked()

    def _export_state_locked(self):
        cl, en = self.storage.cluster, self.storage.engine
        with cl._mu, en._mu:
            return {
                "id": cl._id,
                "stores": list(cl.stores.values()),
                "regions": list(cl._regions.values()),
                "tso_physical": cl._tso_physical,
                "tso_logical": cl._tso_logical,
                "entries": list(en._entries.items()),
            }

    def _install_state(self, st: dict) -> None:
        from tidb_tpu_torch.util.sorteddict import SortedDict
        cl, en = self.storage.cluster, self.storage.engine
        with cl._mu, en._mu:
            cl._id = st["id"]
            cl.stores = {s.id: s for s in st["stores"]}
            cl._regions = SortedDict(
                {r.start: r for r in st["regions"]})
            cl._tso_physical = st["tso_physical"]
            cl._tso_logical = st["tso_logical"]
            en._entries = SortedDict(
                {k: e for k, e in st["entries"]})
            en._locked_keys = {k for k, e in st["entries"]
                               if e.lock is not None}

    _RESYNC_INTERVAL = 1.0   # seconds between re-attach attempts

    def _start_resync_thread(self) -> None:
        """Degraded mode: a PERMANENT daemon monitor dials the backup
        OFF the write path (a blocking connect under _ship_mu would
        stall every mutation); once the backup answers, it takes
        _ship_mu only for the consistent snapshot push. The monitor
        never exits while the server lives, so there is no window where
        a dying thread suppresses the start of its replacement."""
        if getattr(self, "_resync_thread", None) is not None and \
                self._resync_thread.is_alive():
            return

        def loop():
            while not self._closing.is_set():
                time.sleep(self._RESYNC_INTERVAL)
                if not self._backup_dead:
                    continue
                try:
                    conn = _Conn(self._backup_addr, timeout=5)
                except OSError:
                    continue
                try:
                    with self._ship_mu:
                        if not self._backup_dead:
                            continue
                        conn.call("repl_install",
                                  (self._export_state_locked(),), {})
                        self._backup_dead = False
                    print("storage: backup re-synced, resuming "
                          "replication", flush=True)
                except (ConnectionError, OSError, wire.WireError,
                        kv.KVError):
                    continue
                finally:
                    conn.close()

        self._resync_thread = threading.Thread(
            target=loop, daemon=True, name="storage-resync")
        self._resync_thread.start()

    def _ship(self, method: str, args: tuple, kwargs: dict) -> None:
        """Synchronously replicate one applied mutation. Called under
        _ship_mu, so the backup applies in exactly primary order. If the
        backup is unreachable (or rejects a replay) the primary degrades
        to solo and RE-SYNCS it with a full state push as soon as it
        answers again (_start_resync_thread, off the write path) — the
        unreplicated window is bounded by the outage plus one resync.
        Writes acked during that window are lost only if the primary
        ALSO dies before the resync lands (the inherent 2-node
        degraded-mode caveat; a quorum design needs 3 nodes)."""
        if self._backup_dead or self._backup_addr is None:
            return
        cl = self.storage.cluster
        watermark = (cl._tso_physical << 18) | cl._tso_logical
        try:
            if self._backup is None:
                self._backup = _Conn(self._backup_addr)
            self._backup.call("repl_apply",
                              (method, args, kwargs, watermark), {})
        except (ConnectionError, OSError, wire.WireError,
                kv.KVError) as e:
            # incl. KVError: a backup that rejects a replay has diverged
            # and needs the full-state resync, and the client's write —
            # already applied locally — must NOT fail because of it
            if self._backup is not None:
                self._backup.close()
                self._backup = None
            self._backup_dead = True
            print(f"storage: backup unreachable, degrading to solo "
                  f"(re-sync thread running): {e}", flush=True)
            self._start_resync_thread()


    def _repl_apply(self, method: str, args: tuple, kwargs: dict,
                    watermark: int) -> None:
        if self.role != "backup":
            raise kv.KVError("repl_apply on a non-backup node")
        if method not in _MUTATING:
            raise kv.KVError(f"refusing to replay {method!r}")
        cl = self.storage.cluster
        with cl._mu:
            # track the primary's TSO so a promotion never goes backward
            if (watermark >> 18) > cl._tso_physical:
                cl._tso_physical = watermark >> 18
                cl._tso_logical = watermark & ((1 << 18) - 1)
        self._dispatch(method, args, kwargs)

    def _repl_promote(self) -> str:
        """Backup -> primary (failover). TSO is bumped past everything
        the dead primary could have issued."""
        if self.role == "primary":
            return "already-primary"
        cl = self.storage.cluster
        with cl._mu:
            cl._tso_physical = max(cl._tso_physical,
                                   int(time.time() * 1000)) + 1
            cl._tso_logical = 0
        self.role = "primary"
        return "promoted"

    def start(self) -> None:
        t = threading.Thread(target=self._accept, daemon=True,
                             name="storage-accept")
        t.start()

    def _accept(self) -> None:
        while not self._closing.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(sock,),
                                 daemon=True, name="storage-conn")
            with self._mu:
                self._threads.add(t)
            t.start()

    @staticmethod
    def _validate_request(req):
        """Typed request envelope: (cmd:int, args:tuple, kwargs:dict
        [, flags:dict]) — flags carry cross-process metadata like the
        trace-propagation bit."""
        if not (isinstance(req, tuple) and len(req) in (3, 4)):
            raise wire.WireError("request must be (cmd, args, kwargs"
                                 "[, flags])")
        cmd, args, kwargs = req[:3]
        flags = req[3] if len(req) == 4 else {}
        try:
            cmd = wire.Cmd(cmd)
        except ValueError:
            raise wire.WireError(f"unknown command {cmd!r}") from None
        if cmd not in wire.METHOD_BY_CMD:
            raise wire.WireError(f"unroutable command {cmd!r}")
        if not isinstance(args, tuple) or not isinstance(kwargs, dict) \
                or not isinstance(flags, dict):
            raise wire.WireError("bad args/kwargs/flags")
        if any(not isinstance(k, str) for k in kwargs):
            raise wire.WireError("kwargs keys must be strings")
        return cmd, args, kwargs, flags

    def _serve_call(self, method: str, args: tuple, kwargs: dict):
        """Top-level command entry: role gate + replication shipping."""
        if method == "ping":
            return "pong"
        if method == "repl_hello":
            return {"role": self.role,
                    "backup_dead": self._backup_dead}
        if method == "repl_apply":
            return self._repl_apply(*args)
        if method == "repl_snapshot":
            return self._export_state()
        if method == "repl_install":
            if self.role != "backup":
                raise kv.KVError("repl_install on a non-backup node")
            self._install_state(args[0])
            return "installed"
        if method == "repl_promote":
            return self._repl_promote()
        if self.role == "backup":
            # data commands only run on the primary; leader_store=-1 is
            # the "this is a replication backup" sentinel the client's
            # failover logic keys on (ref: NotLeader region errors)
            raise kv.NotLeaderError(0, -1)
        if method in _MUTATING and self._backup_addr is not None:
            # the ship lock serializes apply+ship so the backup applies
            # in primary order; standalone servers skip it entirely
            with self._ship_mu:
                result = self._dispatch(method, args, kwargs)
                self._ship(method, args, kwargs)
                return result
        return self._dispatch(method, args, kwargs)

    def _dispatch(self, method: str, args: tuple, kwargs: dict):
        st = self.storage
        if method == "ping":
            return "pong"
        if method == "tso":
            return st.cluster.tso()
        if method == "region_by_key":
            return st.cluster.region_by_key(*args)
        if method == "regions_snapshot":
            return list(st.cluster._regions.values())
        if method == "split":
            return st.cluster.split(*args)
        if method == "split_table":
            return st.cluster.split_table(*args, **kwargs)
        if method == "bulk_import":
            return st.engine.bulk_import(*args)
        if method == "snapshot_batch_get":
            # helper: batch_get without a region ctx (handles resolved
            # client-side into per-region calls normally; this is the
            # bulk row-fetch path of IndexLookUp/IndexJoin)
            raise kv.KVError("use kv_batch_get with a region ctx")
        fn = getattr(self.storage.shim, method, None)
        if fn is None or method.startswith("_") or not callable(fn):
            raise kv.KVError(f"unknown storage method {method!r}")
        return fn(*args, **kwargs)

    def _serve_stream(self, sock: socket.socket, args: tuple,
                      kwargs: dict, flags: dict | None = None) -> bool:
        """Serve one COP_STREAM request: StreamFrames under credit flow
        control (wire.py). Blocks — not buffers — when the client's
        credit window is exhausted; the blocking recv IS the
        backpressure. A traced request runs under a local root span
        whose finished tree rides back ON THE END FRAME (streams bypass
        the STATUS_OK_TRACED envelope). -> False when the connection
        died and the serve loop must exit."""
        kwargs = dict(kwargs)
        credit = kwargs.pop("credit", None)
        root = None
        origin = None
        if flags and flags.get(wire.FLAG_TRACE):
            from tidb_tpu_torch import trace as _trace
            root = _trace.begin("storage:coprocessor_stream")
            origin = _adopt_origin(root, flags)
        gen = None
        try:
            gate = wire.CreditGate(credit if credit is not None else 4)
            gen = self._serve_call("coprocessor_stream", args, kwargs)
        except Exception as e:  # noqa: BLE001 — typed errors ride back
            if root is not None:
                from tidb_tpu_torch import trace as _trace
                _trace.end(root)    # unpin the thread-local trace root
                _trace.finish_statement(root, "storage:coprocessor_stream",
                                        origin=origin)
                root = None
            return self._stream_abort(sock, e)
        try:
            it = iter(gen)
            while True:
                try:
                    frame = next(it)
                except StopIteration:
                    break
                except Exception as e:  # noqa: BLE001 — typed mid-stream
                    # mid-stream abort: the client may have grants in
                    # flight we cannot count, so the connection dies
                    # with the stream (the client closes its end too)
                    self._stream_abort(sock, e)
                    return gate.sent == 0
                if gate.credit <= 0:
                    # one stall EPISODE (matching BoundedFrameQueue's
                    # accounting), however many grant frames it takes
                    from tidb_tpu_torch.store.stream import note_credit_stall
                    note_credit_stall()
                    while gate.credit <= 0:
                        status, payload = _recv_frame(sock)
                        gate.feed_grant(status, payload)
                _send_frame(sock, wire.STATUS_STREAM_FRAME,
                            wire.encode(frame))
                gate.consume()
            if root is not None:
                from tidb_tpu_torch import trace as _trace
                _trace.end(root)
                _trace.finish_statement(root, "storage:coprocessor_stream",
                                        origin=origin)
                end_payload = wire.encode(root.to_dict())
                root = None
            else:
                end_payload = wire.encode(None)
            _send_frame(sock, wire.STATUS_STREAM_END, end_payload)
            # absorb the trailing grants (one per consumed frame) so the
            # next request on this connection isn't misread as a grant.
            # NO deadline: the client sends each grant only after its
            # consumer finishes that frame, and a consumer stall (a first
            # kernel build runs minutes) is legitimate — blocking here is
            # the same idle state this thread would be in awaiting the
            # next request, and a vanished client surfaces as
            # ConnectionError either way
            while gate.outstanding > 0:
                status, payload = _recv_frame(sock)
                gate.feed_grant(status, payload)
            return True
        except (ConnectionError, OSError):
            return False        # client went away mid-stream
        except wire.WireError as e:
            # peer protocol violation (bogus grant, etc.): abort loudly;
            # framing sync is unknown, so the connection must die
            self._stream_abort(sock, kv.KVError(f"stream protocol: {e}"))
            return False
        finally:
            if root is not None:
                from tidb_tpu_torch import trace as _trace
                _trace.end(root)    # error/disconnect path: unpin, and
                _trace.finish_statement(root, "storage:coprocessor_stream",
                                        origin=origin)  # still joinable
            if gen is not None and hasattr(gen, "close"):
                gen.close()

    @staticmethod
    def _stream_abort(sock: socket.socket, e: BaseException) -> bool:
        """Terminate a stream with a typed error frame; the connection
        returns to request/response state. -> serve-loop liveness."""
        try:
            out = wire.encode(e)
        except wire.WireError:
            out = wire.encode(kv.KVError(f"{type(e).__name__}: {e}"))
        try:
            _send_frame(sock, wire.STATUS_ERR, out)
            return True
        except (ConnectionError, OSError):
            return False

    def _serve(self, sock: socket.socket) -> None:
        try:
            while True:
                try:
                    _status, payload = _recv_frame(sock)
                except (ConnectionError, OSError):
                    return
                try:
                    req = wire.decode_frame_payload(payload)
                    cmd, args, kwargs, flags = self._validate_request(req)
                    method = wire.METHOD_BY_CMD[cmd]
                    if cmd == wire.Cmd.COP_STREAM:
                        if self._serve_stream(sock, args, kwargs, flags):
                            continue
                        return
                    if flags.get(wire.FLAG_TRACE):
                        # cross-process span propagation: run under a
                        # local root and ship the finished tree back for
                        # the client to graft into its statement trace
                        from tidb_tpu_torch import trace
                        # lint: exempt[trace-names] cross-process storage root: the method name is wire data; these roots graft via attach_remote and retain only origin-stamped
                        root = trace.begin(f"storage:{method}")
                        origin = _adopt_origin(root, flags)
                        try:
                            result = self._serve_call(method, args,
                                                      kwargs)
                        finally:
                            trace.end(root)
                            # store-plane retention: a sampled/forced/
                            # slow handler root keeps its tree in THIS
                            # process's ring, stamped with the
                            # originating statement's fleet trace id —
                            # the record cluster_statement_traces and
                            # /fleet/trace join on
                            trace.finish_statement(
                                root, f"storage:{method}",
                                origin=origin)
                        out = wire.encode((result, root.to_dict()))
                        status = _STATUS_OK_TRACED
                    else:
                        result = self._serve_call(method, args, kwargs)
                        out, status = wire.encode(result), _STATUS_OK
                except wire.WireError as e:
                    # malformed frame: reject loudly, keep serving
                    out = wire.encode(kv.KVError(f"bad request: {e}"))
                    status = _STATUS_ERR
                except Exception as e:  # noqa: BLE001 - typed errors ride back
                    try:
                        out, status = wire.encode(e), _STATUS_ERR
                    except wire.WireError:
                        out = wire.encode(
                            kv.KVError(f"{type(e).__name__}: {e}"))
                        status = _STATUS_ERR
                try:
                    _send_frame(sock, status, out)
                except (ConnectionError, OSError):
                    return
        finally:
            with self._mu:
                self._threads.discard(threading.current_thread())
            try:
                sock.close()
            except OSError:
                pass

    def save_snapshot(self) -> None:
        if not self.snapshot_path:
            return
        from tidb_tpu_torch.store import snapshot as snapshot_io
        snapshot_io.save(self.snapshot_path, self.storage.cluster,
                         self.storage.engine)

    def close(self) -> None:
        self._closing.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self.save_snapshot()


# ---------------------------------------------------------------------------
# client side

class _Conn:
    def __init__(self, addr, timeout: float = 30):
        self.sock = socket.create_connection(addr, timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    @staticmethod
    def _trace_flags(trace) -> dict:
        """Request flags of a traced call: the trace bit plus the
        originating statement's forward context (fleet-unique trace id
        + retention flags + member id) so the store plane can stamp
        whatever it retains with the statement that caused it."""
        flags = {wire.FLAG_TRACE: True}
        o = trace.origin()
        if o is not None:
            flags[wire.FLAG_ORIGIN] = o
        return flags

    def call(self, method: str, args: tuple, kwargs: dict):
        from tidb_tpu_torch import trace
        cmd = wire.CMD_BY_METHOD.get(method)
        if cmd is None:
            raise kv.KVError(f"method {method!r} has no wire command")
        req = (int(cmd), tuple(args), dict(kwargs))
        if trace.active():
            req = req + (self._trace_flags(trace),)
        payload = wire.encode(req)
        _send_frame(self.sock, _STATUS_OK, payload)
        status, body = _recv_frame(self.sock)
        result = wire.decode_frame_payload(body)
        if status == _STATUS_ERR:
            if isinstance(result, BaseException):
                raise result
            raise kv.KVError(f"storage error: {result!r}")
        if status == _STATUS_OK_TRACED:
            result, remote_span = result
            trace.attach_remote(remote_span)
        return result

    def call_stream(self, method: str, args: tuple, kwargs: dict,
                    credit: int):
        """Generator over a multi-frame streamed reply. Grants one
        credit back per consumed frame (sliding window): the server
        never has more than `credit` frames un-consumed in flight."""
        from tidb_tpu_torch import trace
        cmd = wire.CMD_BY_METHOD.get(method)
        if cmd is None:
            raise kv.KVError(f"method {method!r} has no wire command")
        req = (int(cmd), tuple(args), dict(kwargs, credit=credit))
        if trace.active():
            req = req + (self._trace_flags(trace),)
        _send_frame(self.sock, wire.STATUS_OK, wire.encode(req))
        reader = wire.StreamReader(credit)
        while True:
            status, body = _recv_frame(self.sock)
            kind, frame = reader.feed(status, body)
            if kind == "end":
                if isinstance(frame, dict):
                    # the server's span tree rode the END frame
                    trace.attach_remote(frame)
                return
            yield frame
            # consumer is done with that frame: open the window one slot
            reader.grant(1)
            _send_frame(self.sock, wire.STATUS_CREDIT, wire.encode(1))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class RemoteClient:
    """Connection pool + failure translation + replica failover (ref:
    client.go connArray + region_request.go onSendFail; the failover
    orchestration the reference delegates to PD lives here, client-side
    — documented single-host substitute).

    `addr` may be one (host, port) or a list of them: a primary plus its
    backup. On dial failure the client rotates to the next address; when
    it reaches a node answering NotLeader(leader_store=-1) (the backup
    sentinel) while the old primary is unreachable, it promotes that
    backup and retries."""

    def __init__(self, addr, max_conns: int = MAX_CONNS,
                 retry_window: float = 10.0):
        if isinstance(addr, list):
            self.addrs = list(addr)
        else:
            self.addrs = [addr]
        self.retry_window = retry_window
        self._cur = 0                      # index of believed primary
        self._pools: dict = {}             # addr -> list[_Conn]
        self._sema = threading.Semaphore(max_conns)
        self._mu = threading.Lock()
        # fired once per observed connection-level failure (dial or
        # mid-request I/O): fleet-mode storages drop stale region
        # epochs here so a reconnect re-resolves routing instead of
        # looping on interrupted streams
        self._disconnect_listeners: list = []

    def add_disconnect_listener(self, fn) -> None:
        self._disconnect_listeners.append(fn)

    def _notify_disconnect(self) -> None:
        for fn in list(self._disconnect_listeners):
            try:
                fn()
            except Exception:   # noqa: BLE001 — listeners are best-effort
                pass

    @property
    def addr(self):
        return self.addrs[self._cur]

    def _checkout(self) -> tuple:
        with self._mu:
            addr = self.addrs[self._cur]
            pool = self._pools.get(addr)
            if pool:
                return addr, pool.pop()
        return addr, _Conn(addr)

    def _checkin(self, addr, conn: _Conn) -> None:
        with self._mu:
            if addr == self.addrs[self._cur]:
                pool = self._pools.setdefault(addr, [])
                if len(pool) < MAX_CONNS:
                    pool.append(conn)
                    return
        conn.close()

    def _rotate(self, from_addr) -> None:
        with self._mu:
            if self.addrs[self._cur] == from_addr and len(self.addrs) > 1:
                self._cur = (self._cur + 1) % len(self.addrs)

    def _old_primary_unreachable(self, backup_addr) -> bool:
        for a in self.addrs:
            if a == backup_addr:
                continue
            try:
                c = _Conn(a, timeout=1.0)
            except OSError:
                continue
            try:
                if c.call("repl_hello", (), {}).get("role") == "primary":
                    return False
            except Exception:   # noqa: BLE001 — unhealthy counts as dead
                pass
            finally:
                c.close()
        return True

    def _promote(self, addr) -> None:
        c = _Conn(addr)
        try:
            c.call("repl_promote", (), {})
        finally:
            c.close()

    def call(self, method: str, *args, **kwargs):
        self._sema.acquire()
        try:
            return self._call_inner(method, args, kwargs)
        finally:
            self._sema.release()

    def _call_inner(self, method: str, args, kwargs):
        deadline = time.monotonic() + self.retry_window
        idempotent = method in _IDEMPOTENT
        while True:
            try:
                addr, conn = self._checkout()
            except OSError as e:
                self._notify_disconnect()
                self._rotate(self.addrs[self._cur])
                if time.monotonic() < deadline:
                    time.sleep(0.1)
                    continue    # storage may be restarting: keep dialing
                raise kv.ServerBusyError(
                    f"storage unreachable at {self.addr}: {e}") from None
            t0 = time.monotonic()
            try:
                result = conn.call(method, args, kwargs)
            except kv.NotLeaderError as e:
                conn.close()
                if e.leader_store == -1:
                    # reached a backup: promote it iff the primary is
                    # really gone, else go back to the primary
                    if self._old_primary_unreachable(addr):
                        try:
                            self._promote(addr)
                        except (ConnectionError, OSError) as pe:
                            raise kv.ServerBusyError(
                                f"failover promote failed: {pe}") from None
                        continue
                    self._rotate(addr)
                    continue
                raise
            except (ConnectionError, OSError, wire.WireError,
                    EOFError) as e:
                conn.close()
                self._notify_disconnect()
                self._rotate(addr)
                if idempotent and time.monotonic() < deadline:
                    time.sleep(0.05)
                    continue
                if idempotent:
                    raise kv.ServerBusyError(
                        f"storage i/o failure: {e}") from None
                # a mutating command may or may not have executed
                raise TimeoutError_(
                    f"storage i/o failure mid-request: {e}") from None
            from tidb_tpu_torch import metrics
            metrics.histogram(metrics.FLEET_RPC_SECONDS,
                              time.monotonic() - t0, {"method": method})
            self._checkin(addr, conn)
            return result

    def call_stream(self, method: str, *args, credit: int = 4, **kwargs):
        """Streamed call: yields frames as the server ships them. Any
        network/protocol failure surfaces as kv.StreamInterruptedError —
        the coprocessor client resumes from its last acked range
        boundary (store/copr.py), so no transparent re-send happens
        here (a blind replay could duplicate already-consumed frames).
        The connection returns to the pool only after a CLEAN end (or a
        typed error frame, which leaves framing intact); an abandoned or
        broken stream closes it."""
        # the sysvar is unbounded; the wire protocol is not — clamp
        # rather than spin a legal SET value through the retry budget
        credit = max(1, min(credit, wire.MAX_STREAM_CREDIT))
        self._sema.acquire()
        conn = None
        clean = False
        try:
            try:
                addr, conn = self._checkout()
            except OSError as e:
                self._notify_disconnect()
                self._rotate(self.addrs[self._cur])
                raise kv.StreamInterruptedError(
                    f"storage unreachable at {self.addr}: {e}") from None
            consumed = 0
            try:
                for frame in conn.call_stream(method, args, kwargs,
                                              credit):
                    consumed += 1
                    yield frame
                clean = True
            except kv.NotLeaderError as e:
                # typed error frame. Framing is intact ONLY if no frame
                # was consumed yet (no grants in flight the server
                # cannot account for); else both ends drop the conn.
                clean = consumed == 0
                if e.leader_store == -1 and \
                        self._old_primary_unreachable(addr):
                    # reached a backup with the primary gone: promote,
                    # then let the caller's resume loop retry against it
                    try:
                        self._promote(addr)
                    except (ConnectionError, OSError) as pe:
                        raise kv.ServerBusyError(
                            f"failover promote failed: {pe}") from None
                    raise kv.StreamInterruptedError(
                        "backup promoted; resume stream") from None
                if e.leader_store == -1:
                    self._rotate(addr)
                raise
            except kv.KVError:
                clean = consumed == 0   # see NotLeaderError note above
                raise
            except (ConnectionError, OSError, wire.WireError,
                    EOFError) as e:
                self._notify_disconnect()
                self._rotate(addr)
                raise kv.StreamInterruptedError(
                    f"stream i/o failure: {e}") from None
        finally:
            if conn is not None:
                if clean:
                    self._checkin(addr, conn)
                else:
                    conn.close()
            self._sema.release()

    def close(self) -> None:
        with self._mu:
            for pool in self._pools.values():
                for c in pool:
                    c.close()
            self._pools.clear()


class _RemotePD:
    """Cluster-lookalike for RegionCache + PDOracle: region routing and
    TSO served by the storage process (the PD role)."""

    def __init__(self, client: RemoteClient):
        self.client = client

    def region_by_key(self, key: bytes):
        return self.client.call("region_by_key", key)

    def tso(self) -> int:
        return self.client.call("tso")

    def all_regions(self):
        return self.client.call("regions_snapshot")

    # test/benchmark topology control
    def split(self, key: bytes):
        return self.client.call("split", key)

    def split_table(self, table_id: int, count: int,
                    max_handle: int = 1 << 20):
        return self.client.call("split_table", table_id, count,
                                max_handle=max_handle)


class _RemoteShim:
    """RPCShim-lookalike: every kv_*/coprocessor call rides the wire."""

    def __init__(self, client: RemoteClient):
        self.client = client

    def __getattr__(self, name: str):
        if name.startswith(("kv_", "raw_", "mvcc_")) or \
                name in ("coprocessor", "split_region", "journal_window"):
            def call(*args, **kwargs):
                return self.client.call(name, *args, **kwargs)
            return call
        raise AttributeError(name)

    def coprocessor_stream(self, ctx, req, credit=None, frame_bytes=None):
        """Streamed coprocessor over the wire: lazy frame generator
        under the credit window (see StorageServer._serve_stream). The
        client's frame cap ships with the request — the storage
        process's own sysvar must not override this session's memory
        bound."""
        kwargs = {}
        if frame_bytes is not None:
            kwargs["frame_bytes"] = frame_bytes
        return self.client.call_stream("coprocessor_stream", ctx, req,
                                       credit=credit or 4, **kwargs)


class _FleetShim(_RemoteShim):
    """Fleet-mode shim: coprocessor tasks are first offered to this
    SQL-server process's OWN cache hierarchy (store/fleetcop.py — a
    journal-window pull primes the serve), and fall through to the
    store plane when not locally servable. Everything else rides the
    wire unchanged."""

    def __init__(self, client: RemoteClient, storage):
        super().__init__(client)
        self._storage = storage

    def coprocessor(self, ctx, req):
        from tidb_tpu_torch import metrics
        from tidb_tpu_torch.store import fleetcop
        res = fleetcop.exec_local(self._storage, self, ctx, req)
        if res is not None:
            return res[0]
        metrics.counter(metrics.FLEET_LOCAL_COP, {"path": "store"})
        return self.client.call("coprocessor", ctx, req)

    def coprocessor_stream(self, ctx, req, credit=None, frame_bytes=None):
        """Streamed flavor of the local-first offer: a locally served
        task ships as ONE synthesized final frame (the cached block is
        already resident — framing it would only re-buffer it), with
        `range` covering the clamped task range so the client's cursor
        and cross-region continuation work unchanged. The offer runs
        lazily on first next(), inside the cop client's per-frame retry
        scope, so region errors from the journal-window pull re-locate
        exactly like mid-stream region errors."""
        def frames():
            from tidb_tpu_torch import metrics
            from tidb_tpu_torch.store import fleetcop
            from tidb_tpu_torch.store.stream import StreamFrame
            res = fleetcop.exec_local(self._storage, self, ctx, req)
            if res is None:
                metrics.counter(metrics.FLEET_LOCAL_COP,
                                {"path": "store"})
                yield from _RemoteShim.coprocessor_stream(
                    self, ctx, req, credit=credit,
                    frame_bytes=frame_bytes)
                return
            out, s, e = res
            rng = kv.KVRange(s, e)
            if not out:
                yield StreamFrame(chunk=None, range=rng, last=True)
                return
            for i, resp in enumerate(out):
                yield StreamFrame(chunk=resp.chunk, range=rng,
                                  last=i == len(out) - 1)
        return frames()


class _RemoteEngine:
    """Offline-import surface of the remote engine (bulkload)."""

    def __init__(self, client: RemoteClient):
        self.client = client

    def bulk_import(self, pairs, start_ts: int, commit_ts: int) -> int:
        return self.client.call("bulk_import", list(pairs), start_ts,
                                commit_ts)


class RemoteStorage(kv.Storage):
    """kv.Storage whose shim/PD/TSO live in another process. Drop-in for
    MockStorage at the session layer: txns, snapshots, coprocessor
    fan-out, GC all run their existing client logic over the wire."""

    def __init__(self, addr, local_cache: bool = False, device=None):
        from tidb_tpu_torch.ops.runtime import resolve_device
        from tidb_tpu_torch.store.oracle import PDOracle
        from tidb_tpu_torch.store.region_cache import RegionCache
        from tidb_tpu_torch.store.txn import KVTxn, LockResolver, TxnSnapshot
        # the device this SQL server's coprocessor kernels and HBM cache
        # run on (exec_cached_cop reads it off the storage)
        self.device = resolve_device(device)
        self._txn_cls = KVTxn
        self._snap_cls = TxnSnapshot
        self.rpc = RemoteClient(addr)
        self.pd = _RemotePD(self.rpc)
        self.cluster = self.pd              # topology ops for tests/bench
        self.engine = _RemoteEngine(self.rpc)
        self.region_cache = RegionCache(self.pd)
        if local_cache:
            # fleet mode: this SQL server keeps its own columnar chunk
            # cache + HBM device cache, kept coherent with the store
            # plane by journal-window pulls (store/fleetcop.py)
            from tidb_tpu_torch.store.chunk_cache import ChunkCache
            from tidb_tpu_torch.store.device_cache import DeviceCache
            self.chunk_cache = ChunkCache()
            self.device_cache = DeviceCache(self.device)
            self.shim = _FleetShim(self.rpc, self)
            # a dropped store connection invalidates every cached
            # region epoch: the reconnected plane may have split/moved
            # regions while we were gone, and resuming with stale
            # routing loops on interrupted streams
            self.rpc.add_disconnect_listener(
                self.region_cache.invalidate_all)
        else:
            self.shim = _RemoteShim(self.rpc)
        self.oracle = PDOracle(self.pd)
        self.resolver = LockResolver(self.shim, self.region_cache,
                                     self.oracle)
        self.async_commit_secondaries = True
        self._client = None
        self.safepoint = 0

    def begin(self, start_ts: int | None = None):
        return self._txn_cls(self, start_ts if start_ts is not None
                             else self.oracle.get_timestamp())

    def snapshot(self, ts: int):
        return self._snap_cls(self.shim, self.region_cache, self.resolver,
                              ts, storage=self)

    def current_ts(self) -> int:
        return self.oracle.get_timestamp()

    def check_visibility(self, ts: int) -> None:
        if ts < self.safepoint:
            raise kv.GCTooEarlyError(
                f"snapshot ts {ts} is below GC safepoint {self.safepoint}")

    def update_safepoint(self, sp: int) -> None:
        self.safepoint = max(self.safepoint, sp)

    def client(self):
        if self._client is None:
            from tidb_tpu_torch.store.copr import CopClient
            self._client = CopClient(self)
        return self._client

    def ping(self) -> bool:
        return self.rpc.call("ping") == "pong"

    def close(self) -> None:
        self.oracle.close()
        dc = getattr(self, "device_cache", None)
        if dc is not None:
            dc.shed()   # return the HBM ledger share eagerly
        self.rpc.close()


def connect(host: str, port: int, *backups, local_cache: bool = False,
            device=None) -> RemoteStorage:
    """backups: extra (host, port) pairs forming the replica set.
    local_cache=True enables fleet mode (per-process coherent caches on
    `device`, CUDA unless the caller asks for another)."""
    addrs = [(host, port)] + [tuple(b) for b in backups]
    return RemoteStorage(addrs if len(addrs) > 1 else addrs[0],
                         local_cache=local_cache, device=device)


# ---------------------------------------------------------------------------
# process entry: python -m tidb_tpu_torch storeserve --port N

def serve_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tidb_tpu_torch.store.remote",
                                description="storage node process")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--status-port", type=int, default=0)
    p.add_argument("--no-status", action="store_true",
                   help="disable the HTTP status server (and with it "
                        "this node's fleet membership registration)")
    p.add_argument("--snapshot", default=None,
                   help="state snapshot file (loaded at start, saved on "
                        "graceful shutdown)")
    p.add_argument("--role", choices=["primary", "backup"],
                   default="primary")
    p.add_argument("--backup", default=None, metavar="HOST:PORT",
                   help="(primary) ship every mutation here synchronously")
    p.add_argument("--primary", default=None, metavar="HOST:PORT",
                   help="(backup) pull initial state from this primary")
    p.add_argument("--device", default="cuda",
                   help="torch device of the store plane's coprocessor "
                        "(default cuda; cpu runs the host path)")
    p.add_argument("--retain-ms", type=int, default=None,
                   help="delta-journal retention window in ms "
                        "(tidb_tpu_delta_retain_ms): keep this much "
                        "journal behind now so fleet SQL servers can "
                        "pull coherence windows")

    def _addr(s):
        h, _, pt = s.rpartition(":")
        return (h or "127.0.0.1", int(pt))

    args = p.parse_args(argv)
    from tidb_tpu_torch.ops.runtime import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"storage: cannot start: {e} (pass --device cpu to serve "
              "on the CPU)", file=sys.stderr, flush=True)
        return 2
    if args.retain_ms is not None:
        from tidb_tpu_torch import config
        config.set_var("tidb_tpu_delta_retain_ms", args.retain_ms)
    server = StorageServer(
        args.host, args.port, snapshot_path=args.snapshot,
        role=args.role,
        backup_addr=_addr(args.backup) if args.backup else None,
        primary_addr=_addr(args.primary) if args.primary else None,
        device=device)
    server.start()
    print(f"storage listening on {args.host}:{server.port}", flush=True)
    status = None
    if not args.no_status:
        # the store plane is a first-class fleet member: it serves the
        # same status surface (metrics, traces, /cluster/state) and
        # registers in the membership registry it hosts, so any SQL
        # member's cluster_* queries include store-plane rows — and the
        # store-retained traces become reachable fleet-wide
        from tidb_tpu_torch import member
        from tidb_tpu_torch.server.status import StatusServer
        status = StatusServer(server.storage, None, host=args.host,
                              port=args.status_port)
        status.start()
        member.set_identity(args.host, status.port, "store")
        member.start_heartbeat(server.storage)
        print(f"status API on {args.host}:{status.port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    if status is not None:
        from tidb_tpu_torch import member
        member.stop_heartbeat()
        status.close()
    server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(serve_main())
