"""Minimal MySQL client: the handshake response 41 with
mysql_native_password, COM_QUERY / INIT_DB / PING / QUIT with text
resultsets, COM_STMT_PREPARE / EXECUTE / CLOSE with binary rows.

The port's own copy of the JAX package's test client, over the port's
`server/packet.py`: what `Fleet.client` hands out, and no external
driver is needed to talk to a member.
"""

from __future__ import annotations

import hashlib
import socket
import struct

from tidb_tpu_torch.server.packet import (PacketIO, read_lenenc_bytes,
                                          read_lenenc_int)


def native_scramble(password: str, salt: bytes) -> bytes:
    """mysql_native_password client scramble:
    SHA1(pwd) XOR SHA1(salt + SHA1(SHA1(pwd)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    mask = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, mask))

CLIENT_PROTOCOL_41 = 0x200
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_CONNECT_WITH_DB = 8
CLIENT_PLUGIN_AUTH = 0x80000


class MySQLError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(f"({code}) {msg}")
        self.code = code


class MiniClient:
    def __init__(self, host: str, port: int, db: str = "",
                 user: str = "root", password: str = ""):
        self.sock = socket.create_connection((host, port), timeout=10)
        self.pkt = PacketIO(self.sock)
        self._handshake(user, db, password)

    @staticmethod
    def _parse_salt(greeting: bytes) -> bytes:
        # protocol v10: version\0, conn id (4), salt1 (8), \0, caps_lo (2),
        # charset (1), status (2), caps_hi (2), auth len (1), 10 zeros,
        # salt2 (12), \0
        off = 1
        off = greeting.index(b"\0", off) + 1     # server version
        off += 4
        salt1 = greeting[off:off + 8]
        off += 8 + 1 + 2 + 1 + 2 + 2 + 1 + 10
        salt2 = greeting[off:off + 12]
        return salt1 + salt2

    def _handshake(self, user: str, db: str, password: str) -> None:
        greeting = self.pkt.read_packet()
        assert greeting[0] == 10, "expected protocol v10"
        auth = native_scramble(password, self._parse_salt(greeting))
        caps = CLIENT_PROTOCOL_41 | CLIENT_SECURE_CONNECTION \
            | CLIENT_PLUGIN_AUTH
        if db:
            caps |= CLIENT_CONNECT_WITH_DB
        resp = struct.pack("<I", caps)
        resp += struct.pack("<I", 1 << 24)
        resp += bytes([33]) + b"\0" * 23
        resp += user.encode() + b"\0"
        resp += bytes([len(auth)]) + auth
        if db:
            resp += db.encode() + b"\0"
        resp += b"mysql_native_password\0"
        self.pkt.write_packet(resp)
        ok = self.pkt.read_packet()
        if ok and ok[0] == 0xFF:
            raise self._err(ok)

    @staticmethod
    def _err(pkt: bytes) -> MySQLError:
        code = struct.unpack_from("<H", pkt, 1)[0]
        return MySQLError(code, pkt[9:].decode("utf8", "replace"))

    def _command(self, cmd: int, data: bytes) -> bytes:
        self.pkt.reset_seq()
        self.pkt.write_packet(bytes([cmd]) + data)
        return self.pkt.read_packet()

    def ping(self) -> None:
        first = self._command(0x0E, b"")
        if first[0] == 0xFF:
            raise self._err(first)

    def use(self, db: str) -> None:
        first = self._command(0x02, db.encode())
        if first[0] == 0xFF:
            raise self._err(first)

    def query(self, sql: str):
        """-> (columns, rows) for resultsets, affected-rows int for OK."""
        first = self._command(0x03, sql.encode())
        if first[0] == 0xFF:
            raise self._err(first)
        if first[0] == 0x00:
            affected, _ = read_lenenc_int(first, 1)
            return affected
        ncols, _ = read_lenenc_int(first, 0)
        cols = []
        for _ in range(ncols):
            cols.append(self._parse_coldef(self.pkt.read_packet()))
        eof = self.pkt.read_packet()
        assert eof[0] == 0xFE
        rows = []
        while True:
            pkt = self.pkt.read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            rows.append(self._parse_row(pkt, ncols))
        return [c for c, _t in cols], rows

    @staticmethod
    def _parse_coldef(pkt: bytes) -> tuple[str, int]:
        off = 0
        for _ in range(4):                       # catalog schema table org
            _v, off = read_lenenc_bytes(pkt, off)
        name, off = read_lenenc_bytes(pkt, off)
        _org, off = read_lenenc_bytes(pkt, off)
        off += 1 + 2 + 4                         # 0x0c, charset, length
        tp = pkt[off]
        return name.decode(), tp

    @staticmethod
    def _parse_row(pkt: bytes, ncols: int) -> tuple:
        out = []
        off = 0
        for _ in range(ncols):
            if pkt[off] == 0xFB:
                out.append(None)
                off += 1
            else:
                v, off = read_lenenc_bytes(pkt, off)
                out.append(v.decode())
        return tuple(out)

    # -- binary protocol (prepared statements) ------------------------------

    def stmt_prepare(self, sql: str):
        """-> (stmt_id, num_params)"""
        first = self._command(0x16, sql.encode())
        if first[0] == 0xFF:
            raise self._err(first)
        sid = struct.unpack_from("<I", first, 1)[0]
        ncols = struct.unpack_from("<H", first, 5)[0]
        nparams = struct.unpack_from("<H", first, 7)[0]
        for _ in range(nparams):
            self.pkt.read_packet()           # param definitions
        if nparams:
            self.pkt.read_packet()           # EOF
        self.last_prepare_columns = []
        for _ in range(ncols):
            self.last_prepare_columns.append(
                self._parse_coldef(self.pkt.read_packet()))
        if ncols:
            self.pkt.read_packet()
        return sid, nparams

    def stmt_execute(self, sid: int, params=()):
        """-> (columns, rows) or affected-rows int. Params typed by python
        value: int -> LONGLONG, float -> DOUBLE, else VARCHAR."""
        body = struct.pack("<IBI", sid, 0, 1)
        n = len(params)
        null_bitmap = bytearray((n + 7) // 8)
        types = b""
        values = b""
        for i, p in enumerate(params):
            if p is None:
                null_bitmap[i // 8] |= 1 << (i % 8)
                types += bytes([6, 0])       # MYSQL_TYPE_NULL
            elif isinstance(p, int):
                types += bytes([8, 0])       # LONGLONG
                values += struct.pack("<q", p)
            elif isinstance(p, float):
                types += bytes([5, 0])       # DOUBLE
                values += struct.pack("<d", p)
            else:
                types += bytes([15, 0])      # VARCHAR
                raw = str(p).encode("utf8")
                values += bytes([len(raw)]) if len(raw) < 251 else b""
                if len(raw) >= 251:
                    raise ValueError("long param strings unsupported here")
                values += raw
        if n:
            body += bytes(null_bitmap) + b"\x01" + types + values
        first = self._command(0x17, body)
        if first[0] == 0xFF:
            raise self._err(first)
        if first[0] == 0x00:                 # OK packet (no resultset)
            affected, _ = read_lenenc_int(first, 1)
            return affected
        ncols, _ = read_lenenc_int(first, 0)
        cols = []
        for _ in range(ncols):
            cols.append(self._parse_coldef(self.pkt.read_packet()))
        eof = self.pkt.read_packet()
        assert eof[0] == 0xFE
        rows = []
        while True:
            pkt = self.pkt.read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            rows.append(self._parse_binary_row(pkt, cols))
        return [c for c, _t in cols], rows

    def stmt_close(self, sid: int) -> None:
        self.pkt.reset_seq()
        self.pkt.write_packet(bytes([0x19]) + struct.pack("<I", sid))

    @staticmethod
    def _parse_binary_row(pkt: bytes, cols) -> tuple:
        ncols = len(cols)
        nb = (ncols + 9) // 8
        bitmap = pkt[1:1 + nb]
        off = 1 + nb
        out = []
        for i, (_name, tp) in enumerate(cols):
            if bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                out.append(None)
                continue
            if tp == 8:                      # LONGLONG
                out.append(struct.unpack_from("<q", pkt, off)[0])
                off += 8
            elif tp in (3, 9):               # LONG / INT24
                out.append(struct.unpack_from("<i", pkt, off)[0])
                off += 4
            elif tp in (2, 13):
                out.append(struct.unpack_from("<h", pkt, off)[0])
                off += 2
            elif tp == 1:
                out.append(struct.unpack_from("<b", pkt, off)[0])
                off += 1
            elif tp == 5:                    # DOUBLE
                out.append(struct.unpack_from("<d", pkt, off)[0])
                off += 8
            elif tp == 4:                    # FLOAT
                out.append(struct.unpack_from("<f", pkt, off)[0])
                off += 4
            elif tp in (7, 10, 12):          # TIMESTAMP/DATE/DATETIME
                ln = pkt[off]
                off += 1
                y = mo = d = h = mi = s = 0
                if ln >= 4:
                    y, mo, d = struct.unpack_from("<HBB", pkt, off)
                if ln >= 7:
                    h, mi, s = struct.unpack_from("<BBB", pkt, off + 4)
                off += ln
                if ln <= 4:
                    out.append(f"{y:04d}-{mo:02d}-{d:02d}")
                else:
                    out.append(f"{y:04d}-{mo:02d}-{d:02d} "
                               f"{h:02d}:{mi:02d}:{s:02d}")
            else:                            # lenenc string
                raw, off = read_lenenc_bytes(pkt, off)
                out.append(raw.decode())
        return tuple(out)

    def close(self) -> None:
        try:
            self.pkt.reset_seq()
            self.pkt.write_packet(b"\x01")       # COM_QUIT
        except OSError:
            pass
        self.sock.close()
