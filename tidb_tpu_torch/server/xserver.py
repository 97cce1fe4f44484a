"""MySQL X-Protocol server skeleton.

Reference: TiDB's x-server/server.go (275 LoC, vestigial in the
reference too: an accept loop importing the X-protocol protobufs blank,
never wired to a session). Parity skeleton: accepts connections, parses
the X-Protocol frame header (little-endian u32 length + u8 message
type), answers CON_CAPABILITIES_GET with an empty capabilities frame
and everything else with an X-Protocol ERROR frame stating the protocol
is not implemented, then closes on CON_CLOSE. Exists so X-Protocol
clients fail fast with a protocol-level message instead of a hang."""

from __future__ import annotations

import socket
import struct
import threading

__all__ = ["XServer"]

# X Protocol client message types (Mysqlx.ClientMessages.Type)
CON_CAPABILITIES_GET = 1
CON_CLOSE = 3

MAX_FRAME = 1 << 16     # nothing legitimate is bigger on this skeleton

# server message types (Mysqlx.ServerMessages.Type)
SV_OK = 0
SV_ERROR = 1
SV_CONN_CAPABILITIES = 2


def _frame(tp: int, payload: bytes = b"") -> bytes:
    return struct.pack("<IB", len(payload) + 1, tp) + payload


class XServer:
    """Accept loop only (matching the reference's x-server scope)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._closing = threading.Event()

    def start(self) -> None:
        threading.Thread(target=self._accept, daemon=True,
                         name="x-server-accept").start()

    def _accept(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True, name="x-server-conn").start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(30)
            while True:
                hdr = self._read_exact(conn, 5)
                if hdr is None:
                    return
                length, tp = struct.unpack("<IB", hdr)
                if length > MAX_FRAME:   # don't buffer attacker-sized frames
                    return
                payload = self._read_exact(conn, length - 1) \
                    if length > 1 else b""
                if payload is None:
                    return
                if tp == CON_CLOSE:
                    conn.sendall(_frame(SV_OK))
                    return
                if tp == CON_CAPABILITIES_GET:
                    # empty Capabilities message (no fields set)
                    conn.sendall(_frame(SV_CONN_CAPABILITIES))
                    continue
                conn.sendall(_frame(SV_ERROR,
                                    b"X Protocol not implemented; "
                                    b"use the classic MySQL protocol"))
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _read_exact(conn: socket.socket, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            part = conn.recv(n - len(buf))
            if not part:
                return None
            buf += part
        return buf

    def close(self) -> None:
        self._closing.set()
        try:
            self._sock.close()
        except OSError:
            pass
