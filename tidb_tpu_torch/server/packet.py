"""MySQL wire packet layer.

Reference: TiDB's server/packetio.go (4-byte header framing:
3-byte little-endian length + 1-byte sequence) and server/util.go
(length-encoded integers/strings). Pure host control-plane code.
"""

from __future__ import annotations

import socket
import struct

MAX_PAYLOAD = 0xFFFFFF


class PacketIO:
    """Framed packet reader/writer over a socket with sequence tracking."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.seq = 0

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed connection")
            buf += chunk
        return buf

    def read_packet(self) -> bytes:
        payload = b""
        while True:
            header = self._recv_exact(4)
            length = header[0] | (header[1] << 8) | (header[2] << 16)
            self.seq = (header[3] + 1) & 0xFF
            payload += self._recv_exact(length)
            if length < MAX_PAYLOAD:
                return payload

    def write_packet(self, payload: bytes) -> None:
        off = 0
        while True:
            chunk = payload[off:off + MAX_PAYLOAD]
            header = struct.pack("<I", len(chunk))[:3] + bytes([self.seq])
            self.sock.sendall(header + chunk)
            self.seq = (self.seq + 1) & 0xFF
            off += len(chunk)
            if len(chunk) < MAX_PAYLOAD:
                return

    def reset_seq(self) -> None:
        self.seq = 0


# -- length-encoded primitives (server/util.go) ------------------------------


def lenenc_int(v: int) -> bytes:
    if v < 251:
        return bytes([v])
    if v < 1 << 16:
        return b"\xfc" + struct.pack("<H", v)
    if v < 1 << 24:
        return b"\xfd" + struct.pack("<I", v)[:3]
    return b"\xfe" + struct.pack("<Q", v)


def read_lenenc_int(b: bytes, off: int) -> tuple[int, int]:
    first = b[off]
    if first < 251:
        return first, off + 1
    if first == 0xFC:
        return struct.unpack_from("<H", b, off + 1)[0], off + 3
    if first == 0xFD:
        return int.from_bytes(b[off + 1:off + 4], "little"), off + 4
    return struct.unpack_from("<Q", b, off + 1)[0], off + 9


def lenenc_bytes(v: bytes) -> bytes:
    return lenenc_int(len(v)) + v


def lenenc_str(v: str) -> bytes:
    return lenenc_bytes(v.encode("utf8"))


def read_lenenc_bytes(b: bytes, off: int) -> tuple[bytes, int]:
    n, off = read_lenenc_int(b, off)
    return b[off:off + n], off + n


def read_nullterm(b: bytes, off: int) -> tuple[bytes, int]:
    end = b.index(0, off)
    return b[off:end], end + 1
