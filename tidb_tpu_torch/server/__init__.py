"""MySQL wire protocol server: the port of the JAX package's
server/__init__.py.

Reference: TiDB's server/ — accept loop + connection tokens
(server.go:234-295), handshake/auth + command dispatch (conn.go:401-610),
textual resultset writer (conn.go:932 writeChunks), the binary protocol
of prepared statements (conn_stmt.go), error packets.

The compute path stays unchanged: each connection owns a Session over the
shared storage, and its statements run on the storage's device (CUDA
unless the storage was made on another device); this layer only speaks
the protocol. The handshake verifies mysql_native_password credentials
against the mysql.user grant table (privilege.py; ref: privileges.go
ConnectionVerification), bootstrapping the system catalog on first
server start. ERR packets carry errcode.classify's code and SQLSTATE."""

from __future__ import annotations

import os
import socket
import struct
import threading
from decimal import Decimal

from tidb_tpu_torch.server.packet import (PacketIO, lenenc_bytes, lenenc_int,
                                    lenenc_str, read_lenenc_bytes,
                                    read_nullterm)
from tidb_tpu_torch.config import SERVER_VERSION
from tidb_tpu_torch.errcode import (ER_ACCESS_DENIED_ERROR as ER_ACCESS_DENIED,
                                    ER_UNKNOWN, classify)
from tidb_tpu_torch.session import ResultSet, Session, SQLError
from tidb_tpu_torch.sqltypes import TypeCode

__all__ = ["Server", "SERVER_VERSION"]
PROTOCOL_VERSION = 10
CHARSET_UTF8MB4 = 33

# capability bits (mysql/const.go)
CLIENT_LONG_PASSWORD = 1
CLIENT_FOUND_ROWS = 2
CLIENT_LONG_FLAG = 4
CLIENT_CONNECT_WITH_DB = 8
CLIENT_PROTOCOL_41 = 0x200
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_MULTI_STATEMENTS = 0x10000
CLIENT_PLUGIN_AUTH = 0x80000
CLIENT_PLUGIN_AUTH_LENENC = 0x200000

# CLIENT_MULTI_STATEMENTS is deliberately NOT advertised: _handle_query
# writes exactly one response per COM_QUERY (no MORE_RESULTS chaining yet)
SERVER_CAPS = (CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS | CLIENT_LONG_FLAG
               | CLIENT_CONNECT_WITH_DB | CLIENT_PROTOCOL_41
               | CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION
               | CLIENT_PLUGIN_AUTH)

SERVER_STATUS_AUTOCOMMIT = 0x0002

# commands (mysql/const.go ComXxx)
COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19
COM_STMT_RESET = 0x1A


class Server:
    """Accept loop with a connection-token limiter (ref: server.go:234)."""

    def __init__(self, storage, host: str = "127.0.0.1", port: int = 0,
                 token_limit: int = 1000):
        self.storage = storage
        from tidb_tpu_torch.bootstrap import bootstrap, load_global_variables
        bootstrap(storage)   # system catalog + root account (idempotent)
        load_global_variables(storage)
        from tidb_tpu_torch.session import Domain
        Domain.get(storage).start_stats_worker()
        Domain.get(storage).start_schema_worker()
        self._listener = socket.create_server((host, port))
        self.addr = self._listener.getsockname()
        self._tokens = threading.Semaphore(token_limit)
        self._closing = threading.Event()
        self._thread: threading.Thread | None = None
        self._conn_id = 0
        self._conns: set = set()
        self._conn_threads: set = set()
        self._mu = threading.Lock()

    @property
    def port(self) -> int:
        return self.addr[1]

    def start(self) -> None:
        # a serving process keeps its metrics history recording (the
        # supervised sampler in metrics_history.py; idempotent)
        from tidb_tpu_torch import metrics_history
        metrics_history.ensure_started()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mysql-accept")
        self._thread.start()

    def _run(self) -> None:
        while not self._closing.is_set():
            try:
                sock, _peer = self._listener.accept()
            except OSError:
                return   # listener closed
            # token acquired in the ACCEPT loop so thread/socket count is
            # actually bounded (ref: server.go:295 getToken before onConn)
            self._tokens.acquire()
            with self._mu:
                self._conn_id += 1
                cid = self._conn_id
            t = threading.Thread(target=self._serve_conn, args=(sock, cid),
                                 daemon=True, name=f"mysql-conn-{cid}")
            with self._mu:
                self._conn_threads.add(t)
            t.start()

    def _serve_conn(self, sock: socket.socket, conn_id: int) -> None:
        from tidb_tpu_torch import metrics
        conn = ClientConn(self, sock, conn_id)
        with self._mu:
            self._conns.add(conn)
            # gauge published under _mu: racing connect/disconnect must
            # not let a stale count overwrite a newer one (metrics._lock
            # is a leaf — see docs/CONCURRENCY.md)
            metrics.gauge(metrics.CONNECTIONS_CURRENT, len(self._conns))
        metrics.counter(metrics.CONNECTIONS)
        try:
            conn.run()
        except (ConnectionError, OSError):
            pass   # peer went away; engine errors surface via ERR packets
        finally:
            with self._mu:
                self._conns.discard(conn)
                self._conn_threads.discard(threading.current_thread())
                metrics.gauge(metrics.CONNECTIONS_CURRENT,
                              len(self._conns))
            conn.close()
            self._tokens.release()

    def close(self) -> None:
        self._closing.set()
        from tidb_tpu_torch.session import Domain
        Domain.get(self.storage).stop_stats_worker()
        Domain.get(self.storage).stop_schema_worker()
        try:
            # shutdown wakes the accept() blocked in _run; a bare close
            # does not on Linux, and the join below would wait it out
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._mu:
            conns = list(self._conns)
            threads = list(self._conn_threads)
        for c in conns:
            # only unblock the socket; the connection thread owns the
            # session and cleans it up in its finally block
            c.shutdown()
        # drain before the caller tears down shared state (the storage)
        if self._thread is not None:
            self._thread.join(timeout=5)
        for t in threads:
            t.join(timeout=5)


def _binary_datetime(s: str) -> bytes:
    """'YYYY-MM-DD[ HH:MM:SS[.ffffff]]' -> binary date/datetime value."""
    date_part, _, time_part = s.partition(" ")
    y, mo, d = (int(x) for x in date_part.split("-"))
    if not time_part:
        return bytes([4]) + struct.pack("<HBB", y, mo, d)
    hms, _, frac = time_part.partition(".")
    h, mi, sec = (int(x) for x in hms.split(":"))
    if frac:
        micros = int(frac.ljust(6, "0")[:6])
        return bytes([11]) + struct.pack("<HBBBBBI", y, mo, d, h, mi, sec,
                                         micros)
    return bytes([7]) + struct.pack("<HBBBBB", y, mo, d, h, mi, sec)


class ClientConn:
    """One connection: handshake, then dispatch loop (ref: conn.go:401)."""

    def __init__(self, server: Server, sock: socket.socket, conn_id: int):
        self.server = server
        self.sock = sock
        self.pkt = PacketIO(sock)
        self.conn_id = conn_id
        self.session: Session | None = None
        self.capabilities = 0
        self._close_mu = threading.Lock()
        self._param_counts: dict[int, int] = {}   # stmt_id -> num params
        self._param_types: dict[int, list] = {}   # stmt_id -> bound types

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> None:
        try:
            if not self._handshake():
                return   # auth failed (ERR already written)
        except (ValueError, IndexError, struct.error):
            return   # malformed handshake (port scanner / non-MySQL peer)
        self.session = Session(self.server.storage, user=self.user,
                               host=self.peer_host)
        # KILL CONNECTION unblocks this conn's read and ends the loop
        # (ref: server.go:333 Kill -> cancel + close)
        self.session.kill_hook = self.shutdown
        while True:
            self.pkt.reset_seq()
            try:
                payload = self.pkt.read_packet()
            except ConnectionError:
                return
            if not payload:
                continue
            cmd, data = payload[0], payload[1:]
            if cmd == COM_QUIT:
                return
            try:
                self._dispatch(cmd, data)
            except Exception as e:  # noqa: BLE001 - never kill the conn
                # typed errors carry standard MySQL codes on the wire
                # (ref: terror.go:152 error-class -> code mapping)
                code, state, msg = classify(e)
                if code == ER_UNKNOWN and not isinstance(e, SQLError):
                    msg = f"internal error: {msg}"
                self._write_err(msg, code=code, sqlstate=state)

    def shutdown(self) -> None:
        """Unblock the connection thread's read; safe from any thread."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def close(self) -> None:
        with self._close_mu:
            session, self.session = self.session, None
        if session is not None:
            session.close()
        try:
            self.sock.close()
        except OSError:
            pass

    # -- handshake (conn.go writeInitialHandshake/readHandshakeResponse) ----

    def _handshake(self) -> bool:
        # 20-byte random salt; NUL bytes would truncate the wire encoding
        salt = bytes(b % 255 + 1 for b in os.urandom(20))
        pkt = bytes([PROTOCOL_VERSION])
        pkt += SERVER_VERSION.encode() + b"\0"
        pkt += struct.pack("<I", self.conn_id)
        pkt += salt[:8] + b"\0"
        pkt += struct.pack("<H", SERVER_CAPS & 0xFFFF)
        pkt += bytes([CHARSET_UTF8MB4])
        pkt += struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
        pkt += struct.pack("<H", (SERVER_CAPS >> 16) & 0xFFFF)
        pkt += bytes([21])                        # auth data length
        pkt += b"\0" * 10
        pkt += salt[8:] + b"\0"
        pkt += b"mysql_native_password\0"
        self.pkt.write_packet(pkt)

        resp = self.pkt.read_packet()
        caps = struct.unpack_from("<I", resp, 0)[0]
        self.capabilities = caps
        off = 4 + 4 + 1 + 23                      # caps, maxpkt, charset, fill
        user, off = read_nullterm(resp, off)
        if caps & CLIENT_PLUGIN_AUTH_LENENC:
            auth, off = read_lenenc_bytes(resp, off)
        else:
            alen = resp[off]
            off += 1
            auth, off = resp[off:off + alen], off + alen
        db = b""
        if caps & CLIENT_CONNECT_WITH_DB and off < len(resp):
            db, off = read_nullterm(resp, off)
        self.user = user.decode()
        try:
            self.peer_host = self.sock.getpeername()[0]
        except OSError:
            self.peer_host = "localhost"
        # verify against mysql.user (ref: session.go:928 Auth ->
        # privileges.go ConnectionVerification)
        cache = self.session_domain().priv_cache()
        if not cache.connection_verify(self.user, self.peer_host,
                                       bytes(auth), salt):
            self._write_err(
                f"Access denied for user '{self.user}'@"
                f"'{self.peer_host}' (using password: "
                f"{'YES' if auth else 'NO'})", code=ER_ACCESS_DENIED,
                sqlstate="28000")
            return False
        self._write_ok(0, 0)
        if db:
            # select the startup database once the session exists
            self._pending_db = db.decode()
        else:
            self._pending_db = None
        return True

    def session_domain(self):
        from tidb_tpu_torch.session import Domain
        return Domain.get(self.server.storage)

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, cmd: int, data: bytes) -> None:
        if self.session is not None and self._pending_db:
            self.session.execute(f"USE `{self._pending_db}`")
            self._pending_db = None
        if cmd == COM_PING:
            self._write_ok(0, 0)
        elif cmd == COM_INIT_DB:
            self.session.execute(f"USE `{data.decode()}`")
            self._write_ok(0, 0)
        elif cmd == COM_QUERY:
            self._handle_query(data.decode())
        elif cmd == COM_FIELD_LIST:
            self._write_eof()
        elif cmd == COM_STMT_PREPARE:
            self._handle_stmt_prepare(data.decode())
        elif cmd == COM_STMT_EXECUTE:
            self._handle_stmt_execute(data)
        elif cmd == COM_STMT_CLOSE:
            sid = struct.unpack_from("<I", data, 0)[0]
            self.session.deallocate_prepared(sid)
            self._param_counts.pop(sid, None)   # no response per protocol
            self._param_types.pop(sid, None)
        elif cmd == COM_STMT_RESET:
            self._write_ok(0, 0)
        else:
            self._write_err(f"unsupported command 0x{cmd:02x}")

    def _handle_query(self, sql: str) -> None:
        results = self.session.execute(sql)
        # one response per query packet: the first resultset wins, else an
        # OK carrying the last affected-rows count
        rs = next((r for r in results if isinstance(r, ResultSet)), None)
        if rs is not None:
            self._write_resultset(rs)
            return
        affected = 0
        for r in results:
            if isinstance(r, int):
                affected = r
        self._write_ok(affected, 0)

    # -- prepared statements / binary protocol (conn_stmt.go) ----------------

    def _handle_stmt_prepare(self, sql: str) -> None:
        sid, nparams = self.session.prepare(sql)
        self._param_counts[sid] = nparams
        # COM_STMT_PREPARE_OK with real prepare-time column definitions:
        # standard drivers (libmysqlclient, Connector/J) read result
        # metadata here, not at execute time (conn_stmt.go).
        names, fts = self.session.prepared_columns(sid)
        ncols = len(names) if names else 0
        pkt = b"\x00" + struct.pack("<I", sid)
        pkt += struct.pack("<H", ncols)
        pkt += struct.pack("<H", nparams)
        pkt += b"\x00" + struct.pack("<H", 0)    # filler, warnings
        self.pkt.write_packet(pkt)
        if nparams:
            for _ in range(nparams):
                self.pkt.write_packet(self._column_def("?", None))
            self._write_eof()
        if ncols:
            for i, name in enumerate(names):
                self.pkt.write_packet(self._column_def(
                    name, fts[i] if fts else None))
            self._write_eof()

    def _handle_stmt_execute(self, data: bytes) -> None:
        sid = struct.unpack_from("<I", data, 0)[0]
        nparams = self._param_counts.get(sid)
        if nparams is None:
            self._write_err(f"unknown statement handler {sid}")
            return
        params = self._decode_params(data, sid, nparams)
        results = self.session.execute_prepared(sid, params)
        rs = results if isinstance(results, ResultSet) else None
        if rs is None:
            self._write_ok(results if isinstance(results, int) else 0, 0)
            return
        self.pkt.write_packet(lenenc_int(len(rs.columns)))
        fts = rs.field_types
        for i, name in enumerate(rs.columns):
            self.pkt.write_packet(self._column_def(
                name, fts[i] if fts else None))
        self._write_eof()
        for row in rs.rows:
            self.pkt.write_packet(self._encode_binary_row(row, fts))
        self._write_eof()

    def _decode_params(self, data: bytes, sid: int, nparams: int) -> list:
        """Binary parameter values (conn_stmt.go parseStmtArgs). Types
        arrive only when new_params_bound_flag is set; later executes
        reuse the types cached per statement (boundParams semantics)."""
        if nparams == 0:
            return []
        off = 4 + 1 + 4                      # stmt_id, flags, iterations
        nb = (nparams + 7) // 8
        null_bitmap = data[off:off + nb]
        off += nb
        new_bound = data[off]
        off += 1
        if new_bound:
            types = []
            for _ in range(nparams):
                types.append((data[off], data[off + 1]))
                off += 2
            self._param_types[sid] = types
        else:
            types = self._param_types.get(sid)
            if types is None:
                raise SQLError("parameter types were never bound")
        params: list = []
        for i in range(nparams):
            if null_bitmap[i // 8] & (1 << (i % 8)):
                params.append(None)
                continue
            tp, flag = types[i]
            unsigned = bool(flag & 0x80)
            if tp in (int(TypeCode.LONGLONG),):
                v = struct.unpack_from("<Q" if unsigned else "<q",
                                       data, off)[0]
                off += 8
            elif tp in (int(TypeCode.LONG), int(TypeCode.INT24)):
                v = struct.unpack_from("<I" if unsigned else "<i",
                                       data, off)[0]
                off += 4
            elif tp in (int(TypeCode.SHORT), int(TypeCode.YEAR)):
                v = struct.unpack_from("<H" if unsigned else "<h",
                                       data, off)[0]
                off += 2
            elif tp == int(TypeCode.TINY):
                v = data[off] if unsigned else \
                    struct.unpack_from("<b", data, off)[0]
                off += 1
            elif tp == int(TypeCode.DOUBLE):
                v = struct.unpack_from("<d", data, off)[0]
                off += 8
            elif tp == int(TypeCode.FLOAT):
                v = struct.unpack_from("<f", data, off)[0]
                off += 4
            elif tp in (int(TypeCode.DATE), int(TypeCode.DATETIME),
                        int(TypeCode.TIMESTAMP)):
                ln = data[off]
                off += 1
                y = mo = d = h = mi = s = 0
                if ln >= 4:
                    y, mo, d = struct.unpack_from("<HBB", data, off)
                if ln >= 7:
                    h, mi, s = struct.unpack_from("<BBB", data, off + 4)
                off += ln
                v = f"{y:04d}-{mo:02d}-{d:02d} {h:02d}:{mi:02d}:{s:02d}"
            else:                            # strings / decimals / blobs
                raw, off = read_lenenc_bytes(data, off)
                v = raw.decode("utf8", "replace")
            params.append(v)
        return params

    @staticmethod
    def _encode_binary_row(row, fts) -> bytes:
        """Binary resultset row (conn.go writeBinaryRow)."""
        ncols = len(row)
        null_bitmap = bytearray((ncols + 9) // 8)
        out = b""
        for i, v in enumerate(row):
            if v is None:
                null_bitmap[(i + 2) // 8] |= 1 << ((i + 2) % 8)
                continue
            tp = int(fts[i].tp) if fts else int(TypeCode.VARCHAR)
            # width follows the DECLARED column type (protocol rule)
            if tp == int(TypeCode.LONGLONG):
                out += struct.pack("<q", int(v))
            elif tp in (int(TypeCode.LONG), int(TypeCode.INT24)):
                out += struct.pack("<i", int(v))
            elif tp in (int(TypeCode.SHORT), int(TypeCode.YEAR)):
                out += struct.pack("<h", int(v))
            elif tp == int(TypeCode.TINY):
                out += struct.pack("<b", int(v))
            elif tp == int(TypeCode.DOUBLE):
                out += struct.pack("<d", float(v))
            elif tp == int(TypeCode.FLOAT):
                out += struct.pack("<f", float(v))
            elif tp in (int(TypeCode.DATE), int(TypeCode.DATETIME),
                        int(TypeCode.TIMESTAMP)):
                out += _binary_datetime(str(v))
            else:                            # varchar/char/blob/decimal
                s = v if isinstance(v, bytes) else str(v).encode("utf8")
                out += lenenc_bytes(s)
        return b"\x00" + bytes(null_bitmap) + out

    # -- response writers (conn.go writeOK/writeError/writeResultset) -------

    def _write_ok(self, affected: int, last_insert_id: int) -> None:
        pkt = b"\x00" + lenenc_int(affected) + lenenc_int(last_insert_id)
        pkt += struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
        pkt += struct.pack("<H", 0)               # warnings
        self.pkt.write_packet(pkt)

    def _write_eof(self) -> None:
        self.pkt.write_packet(
            b"\xfe" + struct.pack("<H", 0)
            + struct.pack("<H", SERVER_STATUS_AUTOCOMMIT))

    def _write_err(self, msg: str, code: int = ER_UNKNOWN,
                   sqlstate: str = "HY000") -> None:
        pkt = b"\xff" + struct.pack("<H", code) + b"#" + \
            sqlstate.encode()[:5].ljust(5, b"0")
        pkt += msg.encode("utf8", "replace")
        self.pkt.write_packet(pkt)

    def _write_resultset(self, rs: ResultSet) -> None:
        from tidb_tpu_torch.util import failpoint
        self.pkt.write_packet(lenenc_int(len(rs.columns)))
        fts = getattr(rs, "field_types", None)
        for i, name in enumerate(rs.columns):
            self.pkt.write_packet(self._column_def(
                name, fts[i] if fts else None))
        self._write_eof()
        for n, row in enumerate(rs.rows):
            # injectable connection teardown MID-resultset (after the
            # header, between rows): a callable action can close the
            # socket / raise, proving a half-shipped resultset tears
            # the connection down without wedging the session's slots
            # or ledgers
            failpoint.eval("wire/resultset", self, n)
            self.pkt.write_packet(self._encode_row(row))
        self._write_eof()

    @staticmethod
    def _column_def(name: str, ft) -> bytes:
        tp = int(ft.tp) if ft is not None else int(TypeCode.VARCHAR)
        flen = (ft.flen if ft is not None and ft.flen > 0 else 255)
        dec = (ft.frac if ft is not None and 0 <= ft.frac <= 30 else 0)
        pkt = lenenc_str("def")                   # catalog
        pkt += lenenc_str("") * 3                 # schema, table, org_table
        pkt += lenenc_str(name) + lenenc_str(name)
        pkt += bytes([0x0C])
        pkt += struct.pack("<H", CHARSET_UTF8MB4)
        pkt += struct.pack("<I", flen)
        pkt += bytes([tp])
        pkt += struct.pack("<H", 0)               # flags
        pkt += bytes([dec])
        pkt += b"\0\0"
        return pkt

    @staticmethod
    def _encode_row(row) -> bytes:
        out = b""
        for v in row:
            if v is None:
                out += b"\xfb"
            elif isinstance(v, bytes):
                out += lenenc_bytes(v)
            elif isinstance(v, bool):
                out += lenenc_str("1" if v else "0")
            elif isinstance(v, float):
                out += lenenc_str(repr(v))
            elif isinstance(v, Decimal):
                out += lenenc_str(str(v))
            else:
                out += lenenc_str(str(v))
        return out
