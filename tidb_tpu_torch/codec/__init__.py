"""Memcomparable datum codec: byte strings whose lexicographic order equals
datum order.

Reference: TiDB's util/codec/ — EncodeKey codec/codec.go:165, the
MyRocks-style byte-group stuffing codec/bytes.go:45, int sign-bit flip
codec/number.go. The wire format here follows the same public scheme
(8-byte groups + pad-count marker; sign-flipped big-endian ints; IEEE754
bit tricks for floats) so ordering properties match, but is written fresh.

Flags (1 byte before each datum):
    0x00 NULL        sorts before everything
    0x01 BYTES       group-stuffed, order-preserving
    0x03 INT         big-endian uint64 of (v XOR 1<<63)
    0x04 UINT        big-endian uint64
    0x05 FLOAT       IEEE754 with sign-dependent bit flip
    0x06 DECIMAL     frac byte + INT encoding of scaled value (per-column
                     frac is constant, so order holds within a column)
    0x02 WDEC_NEG    wide decimal, scaled < -2^63: frac byte + inverted
                     length byte + complemented big-endian magnitude
    0x07 WDEC_POS    wide decimal, scaled >= 2^63: frac byte + length
                     byte + big-endian magnitude
                     (0x02 < 0x06 < 0x07, so a column mixing narrow and
                     wide scaled values still orders correctly — ref:
                     types/mydecimal.go's sortable binary form)
    0xFF MAX         sorts after everything (range upper bounds)

Descending order: `encode_desc` inverts every payload byte.
"""

from __future__ import annotations

import struct

__all__ = [
    "NIL_FLAG", "BYTES_FLAG", "INT_FLAG", "UINT_FLAG", "FLOAT_FLAG",
    "DECIMAL_FLAG", "MAX_FLAG",
    "encode_int", "decode_int", "encode_uint", "decode_uint",
    "encode_bytes", "decode_bytes", "encode_float", "decode_float",
    "encode_datum", "encode_key", "decode_key", "decode_one",
    "key_max", "key_next",
]

NIL_FLAG = 0x00
BYTES_FLAG = 0x01
WDEC_NEG_FLAG = 0x02
INT_FLAG = 0x03
UINT_FLAG = 0x04
FLOAT_FLAG = 0x05
DECIMAL_FLAG = 0x06
WDEC_POS_FLAG = 0x07
NIL_DESC_FLAG = 0xFE  # NULL under DESC order: sorts after every value
MAX_FLAG = 0xFF

_SIGN_MASK = 0x8000000000000000
_GROUP = 8
_MARKER = 0xFF
_PAD = 0x00


# -- primitives --------------------------------------------------------------

def _unpack_u64(b: bytes, off: int) -> int:
    if off + 8 > len(b):
        raise ValueError("truncated 8-byte datum")
    (u,) = struct.unpack_from(">Q", b, off)
    return u


def encode_int(v: int) -> bytes:
    """Sign-flipped big-endian: order-preserving over int64."""
    if not (-(1 << 63) <= v < (1 << 63)):
        raise OverflowError(f"{v} outside int64")
    return struct.pack(">Q", (v ^ _SIGN_MASK) & 0xFFFFFFFFFFFFFFFF)


def decode_int(b: bytes, off: int = 0) -> tuple[int, int]:
    u = _unpack_u64(b, off) ^ _SIGN_MASK
    if u >= 1 << 63:
        u -= 1 << 64
    return u, off + 8


def encode_uint(v: int) -> bytes:
    if not (0 <= v < (1 << 64)):
        raise OverflowError(f"{v} outside uint64")
    return struct.pack(">Q", v)


def decode_uint(b: bytes, off: int = 0) -> tuple[int, int]:
    return _unpack_u64(b, off), off + 8


def encode_float(v: float) -> bytes:
    (u,) = struct.unpack(">Q", struct.pack(">d", v))
    # value test (not sign-bit test) so -0.0 encodes identically to +0.0,
    # matching the reference (util/codec/float.go uses `f >= 0`)
    if v >= 0:
        u |= _SIGN_MASK               # non-negative: set sign bit
    else:
        u = ~u & 0xFFFFFFFFFFFFFFFF   # negative: flip all bits
    return struct.pack(">Q", u)


def decode_float(b: bytes, off: int = 0) -> tuple[float, int]:
    u = _unpack_u64(b, off)
    if u & _SIGN_MASK:
        u &= ~_SIGN_MASK & 0xFFFFFFFFFFFFFFFF
    else:
        u = ~u & 0xFFFFFFFFFFFFFFFF
    (v,) = struct.unpack(">d", struct.pack(">Q", u))
    return v, off + 8


def encode_bytes(data: bytes) -> bytes:
    """Group-stuffing: emit 8-byte groups each followed by a marker byte.

    Marker = 0xFF - pad_count; a full group's marker is 0xFF (continue), the
    final (possibly empty) group's marker is < 0xFF (stop). Lexicographic
    order over encodings equals order over the original byte strings.
    """
    out = bytearray()
    i = 0
    n = len(data)
    while True:
        group = data[i:i + _GROUP]
        pad = _GROUP - len(group)
        out += group
        out += bytes([_PAD]) * pad
        out.append(_MARKER - pad)
        i += _GROUP
        if pad > 0:
            break
        if i == n:
            # data ended exactly on a boundary: emit terminating all-pad group
            out += bytes([_PAD]) * _GROUP
            out.append(_MARKER - _GROUP)
            break
    return bytes(out)


def decode_bytes(b: bytes, off: int = 0, desc: bool = False) -> tuple[bytes, int]:
    """Decode a group-stuffed byte string. With desc=True, inverts each
    9-byte group as it is consumed (no whole-tail copies)."""
    out = bytearray()
    while True:
        if off + _GROUP + 1 > len(b):
            raise ValueError("malformed bytes encoding")
        group = b[off:off + _GROUP]
        marker = b[off + _GROUP]
        if desc:
            group = bytes(0xFF - x for x in group)
            marker = 0xFF - marker
        off += _GROUP + 1
        pad = _MARKER - marker
        if pad == 0:
            out += group
            continue
        if pad > _GROUP:
            raise ValueError("malformed bytes marker")
        real = _GROUP - pad
        if any(x != _PAD for x in group[real:]):
            raise ValueError("nonzero padding")
        out += group[:real]
        return bytes(out), off


# -- datums ------------------------------------------------------------------

_I64_LO, _I64_HI = -(1 << 63), (1 << 63) - 1


def _encode_decimal(frac: int, scaled: int) -> bytes:
    """(frac, scaled) -> flagged bytes. Scaled values inside int64 use
    the fixed 8-byte DECIMAL form; wider ones use the variable-length
    WDEC forms whose flags straddle DECIMAL so mixed-width columns stay
    memcomparable (see the module docstring)."""
    if _I64_LO <= scaled <= _I64_HI:
        return bytes([DECIMAL_FLAG, frac]) + encode_int(scaled)
    if scaled > 0:
        mag = scaled.to_bytes((scaled.bit_length() + 7) // 8, "big")
        if len(mag) > 255:
            raise OverflowError("decimal magnitude too large")
        return bytes([WDEC_POS_FLAG, frac, len(mag)]) + mag
    m = -scaled
    mag = m.to_bytes((m.bit_length() + 7) // 8, "big")
    if len(mag) > 255:
        raise OverflowError("decimal magnitude too large")
    return bytes([WDEC_NEG_FLAG, frac, 255 - len(mag)]) + \
        bytes(0xFF - x for x in mag)


def encode_datum(v, desc: bool = False) -> bytes:
    """Encode one python-level value with a type flag.

    int -> INT; float -> FLOAT; str/bytes -> BYTES; None -> NULL;
    (frac, scaled) tuple -> DECIMAL. Datetimes arrive as int micros (INT).
    """
    if v is None:
        # DESC NULL gets its own high flag so it sorts after all values
        return bytes([NIL_DESC_FLAG if desc else NIL_FLAG])
    elif isinstance(v, bool):
        raw = bytes([INT_FLAG]) + encode_int(int(v))
    elif isinstance(v, int):
        if v >= 1 << 63:
            # unsigned BIGINT upper half: UINT flag sorts after all INTs,
            # keeping total order correct for unsigned columns
            raw = bytes([UINT_FLAG]) + encode_uint(v)
        else:
            raw = bytes([INT_FLAG]) + encode_int(v)
    elif isinstance(v, float):
        raw = bytes([FLOAT_FLAG]) + encode_float(v)
    elif isinstance(v, str):
        raw = bytes([BYTES_FLAG]) + encode_bytes(v.encode("utf8"))
    elif isinstance(v, (bytes, bytearray)):
        raw = bytes([BYTES_FLAG]) + encode_bytes(bytes(v))
    elif isinstance(v, tuple) and len(v) == 2:
        frac, scaled = v
        raw = _encode_decimal(frac, scaled)
    else:
        import decimal as _d
        if isinstance(v, _d.Decimal):
            from tidb_tpu_torch.sqltypes import decimal_to_scaled
            frac = max(0, -v.as_tuple().exponent)
            raw = _encode_decimal(
                frac, decimal_to_scaled(v, frac, wide=True))
        else:
            raise TypeError(f"cannot encode datum {v!r} ({type(v)})")
    if desc:
        return bytes([raw[0]]) + bytes(0xFF - x for x in raw[1:])
    return raw


def decode_one(b: bytes, off: int = 0, desc: bool = False):
    """Decode one datum; returns (value, new_offset)."""
    flag = b[off]
    off += 1

    def inv8():
        if off + 8 > len(b):
            raise ValueError("truncated 8-byte datum")
        return bytes(0xFF - x for x in b[off:off + 8])

    if flag == NIL_FLAG or flag == NIL_DESC_FLAG:
        return None, off
    if flag == MAX_FLAG:
        raise ValueError("MAX flag is not decodable")
    if flag == INT_FLAG:
        if desc:
            return decode_int(inv8(), 0)[0], off + 8
        return decode_int(b, off)
    if flag == UINT_FLAG:
        if desc:
            return decode_uint(inv8(), 0)[0], off + 8
        return decode_uint(b, off)
    if flag == FLOAT_FLAG:
        if desc:
            return decode_float(inv8(), 0)[0], off + 8
        return decode_float(b, off)
    if flag == DECIMAL_FLAG:
        frac = b[off] if not desc else 0xFF - b[off]
        off += 1
        if desc:
            return (frac, decode_int(inv8(), 0)[0]), off + 8
        v, off = decode_int(b, off)
        return (frac, v), off
    if flag in (WDEC_POS_FLAG, WDEC_NEG_FLAG):
        def u8(x):
            return (0xFF - x) if desc else x
        frac = u8(b[off])
        ln = u8(b[off + 1])
        off += 2
        neg = flag == WDEC_NEG_FLAG
        if neg:
            ln = 255 - ln
        if off + ln > len(b):
            raise ValueError("truncated wide decimal")
        mag = bytes(u8(x) for x in b[off:off + ln])
        if neg:
            mag = bytes(0xFF - x for x in mag)
        v = int.from_bytes(mag, "big")
        return (frac, -v if neg else v), off + ln
    if flag == BYTES_FLAG:
        return decode_bytes(b, off, desc=desc)
    raise ValueError(f"unknown flag {flag:#x}")


def encode_key(values, desc_flags=None) -> bytes:
    """Encode a sequence of datums into one memcomparable key."""
    out = bytearray()
    for i, v in enumerate(values):
        desc = bool(desc_flags[i]) if desc_flags else False
        out += encode_datum(v, desc)
    return bytes(out)


def decode_key(b: bytes, desc_flags=None) -> list:
    out = []
    off = 0
    i = 0
    while off < len(b):
        desc = bool(desc_flags[i]) if desc_flags else False
        v, off = decode_one(b, off, desc)
        out.append(v)
        i += 1
    return out


def key_max() -> bytes:
    return bytes([MAX_FLAG])


def key_next(key: bytes) -> bytes:
    """Smallest key strictly greater than `key` (append 0x00)."""
    return key + b"\x00"


def prefix_next(prefix: bytes) -> bytes:
    """Smallest key strictly greater than every key starting with `prefix`
    (increment with carry). Raises for all-0xFF prefixes: no strict upper
    bound exists; callers must treat that range as unbounded."""
    b = bytearray(prefix)
    for i in range(len(b) - 1, -1, -1):
        if b[i] != 0xFF:
            b[i] += 1
            return bytes(b[:i + 1])
    raise ValueError("all-0xFF prefix has no strict upper bound")
