"""SQL type system: field types, eval types, numpy/torch dtype mapping.

Reference: TiDB's types/ (FieldType types/field_type.go, EvalType
types/eval_type.go, Datum types/datum.go:57-65, MyDecimal types/mydecimal.go,
Time types/time.go).

Columnar design departures from the reference:

* No tagged-union Datum in the hot path. Columns are numpy arrays with a
  validity bitmap (Arrow convention); a light `Datum`-like Python value is
  used only on the row-at-a-time control plane (codec, membuffer, DDL).
* DECIMAL is a scaled int64 on the compute path ("decimal-as-scaled-int",
  SURVEY.md §7 stage 1): value = unscaled // 10**frac. Exact arithmetic
  beyond int64 range falls back to the host path (python decimal).
* DATETIME/DATE/TIMESTAMP are int64 microseconds since unix epoch;
  DURATION is int64 microseconds. All fixed-width -> device-transferable.
"""

from __future__ import annotations

import datetime as _dt
import decimal as _pydec
from dataclasses import dataclass, field, replace
from enum import IntEnum

import numpy as np

__all__ = [
    "TypeCode", "EvalType", "FieldType", "Flag",
    "new_int_field", "new_uint_field", "new_double_field",
    "new_decimal_field", "new_string_field", "new_datetime_field",
    "new_date_field", "new_duration_field",
    "np_dtype_for", "eval_type_of",
    "decimal_to_scaled", "scaled_to_decimal",
    "datetime_to_micros", "micros_to_datetime", "date_to_micros",
    "parse_datetime", "format_datetime",
    "parse_duration", "format_duration",
    "collation_key", "fold_column", "bytes_to_str",
    "NULL",
]


class TypeCode(IntEnum):
    """MySQL column type codes (subset). Ref: mysql/type.go."""

    NULL = 6
    TINY = 1
    SHORT = 2
    LONG = 3
    LONGLONG = 8
    INT24 = 9
    FLOAT = 4
    DOUBLE = 5
    NEWDECIMAL = 246
    VARCHAR = 15
    STRING = 254
    VARSTRING = 253
    BLOB = 252
    DATE = 10
    DATETIME = 12
    TIMESTAMP = 7
    DURATION = 11
    YEAR = 13
    BIT = 16
    ENUM = 247
    SET = 248
    JSON = 245


class Flag(IntEnum):
    """Column flags (subset of mysql/const.go flag bits)."""

    NOT_NULL = 1
    PRI_KEY = 2
    UNIQUE_KEY = 4
    MULTIPLE_KEY = 8
    UNSIGNED = 32
    BINARY = 128
    AUTO_INCREMENT = 512


class EvalType(IntEnum):
    """Evaluation type classes. Ref: types/eval_type.go."""

    INT = 0
    REAL = 1
    DECIMAL = 2
    STRING = 3
    DATETIME = 4
    DURATION = 5
    JSON = 6


_INT_TYPES = {TypeCode.TINY, TypeCode.SHORT, TypeCode.LONG, TypeCode.LONGLONG,
              TypeCode.INT24, TypeCode.YEAR, TypeCode.BIT}
_REAL_TYPES = {TypeCode.FLOAT, TypeCode.DOUBLE}
_STRING_TYPES = {TypeCode.VARCHAR, TypeCode.STRING, TypeCode.VARSTRING,
                 TypeCode.BLOB, TypeCode.ENUM, TypeCode.SET}
_TIME_TYPES = {TypeCode.DATE, TypeCode.DATETIME, TypeCode.TIMESTAMP}


NULL = None  # SQL NULL is Python None throughout the row-wise host code


@dataclass(frozen=True)
class FieldType:
    """Column type descriptor. Ref: types/field_type.go FieldType."""

    tp: TypeCode
    flags: int = 0
    flen: int = -1       # display length / max bytes for strings
    frac: int = -1       # decimal digits after the point (NEWDECIMAL, DURATION)
    charset: str = "utf8"
    elems: tuple = ()    # ENUM/SET members
    # collation drives compare/group/sort/unique for string columns
    # (ref: util/charset/charset.go; _ci approximated by str.casefold —
    # unicode simple case folding, docs/DEVIATIONS.md)
    collation: str = "utf8mb4_bin"

    @property
    def is_unsigned(self) -> bool:
        return bool(self.flags & Flag.UNSIGNED)

    @property
    def is_ci(self) -> bool:
        """Case-insensitive collation on a string-typed column."""
        return self.collation.endswith("_ci") and \
            self.eval_type == EvalType.STRING

    @property
    def is_wide_decimal(self) -> bool:
        """DECIMAL(p>18): scaled PYTHON ints in an object column — the
        exact host lane (arbitrary precision, like mydecimal.go's
        9-digit words but with bignum arithmetic); p<=18 stays the
        int64 device fast path."""
        return self.tp == TypeCode.NEWDECIMAL and self.flen > 18

    @property
    def not_null(self) -> bool:
        return bool(self.flags & Flag.NOT_NULL)

    @property
    def eval_type(self) -> EvalType:
        return eval_type_of(self.tp)

    def with_flags(self, extra: int) -> "FieldType":
        return replace(self, flags=self.flags | extra)

    def np_dtype(self):
        return np_dtype_for(self.tp, self.flen)

    @property
    def fixed_width(self) -> bool:
        """True if values are a fixed-width numeric representation
        (device-transferable without dictionary encoding)."""
        return self.eval_type != EvalType.STRING and \
            self.tp != TypeCode.JSON and not self.is_wide_decimal


def object_fill(ft) -> object:
    """Dead-slot filler for object-dtype columns: wide decimals hold
    scaled python ints (0), varlen strings hold ''."""
    return 0 if ft.tp == TypeCode.NEWDECIMAL else ""


def bytes_to_str(x) -> str:
    """Total byte/str-to-str conversion: utf-8 when valid, latin-1
    otherwise (1 byte per char, so LENGTH() still counts bytes and byte
    ordering is preserved). Single home for the binary-string decode
    policy used by builtins and string ops."""
    if isinstance(x, str):
        return x
    if isinstance(x, (bytes, bytearray)):
        try:
            return bytes(x).decode("utf-8")
        except UnicodeDecodeError:
            return bytes(x).decode("latin-1")
    return str(x)


def collation_key(x):
    """The comparison key of one string value under a _ci collation
    (approximates utf8mb4_general_ci by unicode simple case folding —
    docs/DEVIATIONS.md). Non-strings pass through."""
    if isinstance(x, str):
        return x.casefold()
    if isinstance(x, bytes):
        try:
            return x.decode("utf8").casefold()
        except UnicodeDecodeError:
            return x
    return x


def fold_column(d):
    """Vectorized collation_key over an object column."""
    out = np.empty(len(d), dtype=object)
    for i, x in enumerate(d):
        out[i] = collation_key(x)
    return out


def eval_type_of(tp: TypeCode) -> EvalType:
    if tp in _INT_TYPES:
        return EvalType.INT
    if tp in _REAL_TYPES:
        return EvalType.REAL
    if tp == TypeCode.NEWDECIMAL:
        return EvalType.DECIMAL
    if tp in _TIME_TYPES:
        return EvalType.DATETIME
    if tp == TypeCode.DURATION:
        return EvalType.DURATION
    if tp == TypeCode.JSON:
        return EvalType.JSON
    return EvalType.STRING


def np_dtype_for(tp: TypeCode, flen: int = -1):
    """Fixed storage dtype per type (ref: util/chunk/chunk.go:81-97 chooses
    fixed widths per MySQL type; we use 8-byte lanes uniformly so columns map
    directly onto device-friendly int64/float64/float32 arrays). DECIMAL with
    p>18 (pass `flen`) overflows int64: object lane of scaled python ints."""
    if tp == TypeCode.NEWDECIMAL and flen > 18:
        return np.dtype(object)
    et = eval_type_of(tp)
    if et in (EvalType.INT, EvalType.DECIMAL, EvalType.DATETIME, EvalType.DURATION):
        return np.dtype(np.int64)
    if et == EvalType.REAL:
        return np.dtype(np.float64)
    return np.dtype(object)  # varlen: held host-side / dictionary-encoded


# ---------------------------------------------------------------------------
# Constructors

def new_int_field(flags: int = 0) -> FieldType:
    return FieldType(TypeCode.LONGLONG, flags=flags, flen=20)


def new_uint_field(flags: int = 0) -> FieldType:
    return FieldType(TypeCode.LONGLONG, flags=flags | Flag.UNSIGNED, flen=20)


def new_double_field(flags: int = 0) -> FieldType:
    return FieldType(TypeCode.DOUBLE, flags=flags, flen=22)


def new_decimal_field(flen: int = 15, frac: int = 2, flags: int = 0) -> FieldType:
    return FieldType(TypeCode.NEWDECIMAL, flags=flags, flen=flen, frac=frac)


def new_string_field(flen: int = 255, flags: int = 0) -> FieldType:
    return FieldType(TypeCode.VARCHAR, flags=flags, flen=flen)


def new_datetime_field(flags: int = 0) -> FieldType:
    return FieldType(TypeCode.DATETIME, flags=flags, flen=19)


def new_date_field(flags: int = 0) -> FieldType:
    return FieldType(TypeCode.DATE, flags=flags, flen=10)


def new_duration_field(flags: int = 0, frac: int = 0) -> FieldType:
    return FieldType(TypeCode.DURATION, flags=flags, flen=10, frac=frac)


# ---------------------------------------------------------------------------
# Decimal <-> scaled int64

def decimal_to_scaled(v, frac: int, wide: bool = False) -> int:
    """Encode a decimal value as an unscaled int with `frac` fractional
    digits.

    Replaces the reference's MyDecimal 9-digit-word representation
    (types/mydecimal.go) with a single int64 lane for the device path.
    Raises OverflowError outside int64 unless `wide` (DECIMAL(p>18)
    columns keep exact scaled PYTHON ints on the host object lane) —
    narrow callers fall back to host decimal on overflow.
    """
    if isinstance(v, float):
        d = _pydec.Decimal(repr(v))
    elif isinstance(v, _pydec.Decimal):
        d = v
    else:
        d = _pydec.Decimal(str(v))
    try:
        with _pydec.localcontext() as ctx:
            ctx.prec = 70        # MySQL max precision is 65 digits
            q = d.scaleb(frac).quantize(_pydec.Decimal(1),
                                        rounding=_pydec.ROUND_HALF_UP)
    except _pydec.InvalidOperation as e:
        raise OverflowError(
            f"decimal {v} does not fit frac={frac}") from e
    i = int(q)
    if not wide and not (-(1 << 63) <= i < (1 << 63)):
        raise OverflowError(f"decimal {v} does not fit scaled int64 frac={frac}")
    return i


def scaled_to_decimal(i: int, frac: int) -> _pydec.Decimal:
    with _pydec.localcontext() as ctx:
        ctx.prec = 70            # wide lane: don't round at 28 digits
        return _pydec.Decimal(int(i)).scaleb(-frac)


# ---------------------------------------------------------------------------
# Time <-> int64 microseconds (ref: types/time.go packs into a custom uint64;
# we use unix-epoch micros so device arithmetic is plain int64 ops)

_EPOCH = _dt.datetime(1970, 1, 1)


def datetime_to_micros(dt: _dt.datetime) -> int:
    # exact integer arithmetic — total_seconds() is float64 and corrupts µs
    return (dt - _EPOCH) // _dt.timedelta(microseconds=1)


def date_to_micros(d: _dt.date) -> int:
    return (d - _EPOCH.date()).days * 86_400_000_000


def micros_to_datetime(us: int) -> _dt.datetime:
    return _EPOCH + _dt.timedelta(microseconds=int(us))


def parse_datetime(s: str) -> int:
    """Parse 'YYYY-MM-DD[ HH:MM:SS[.ffffff]]' to epoch micros."""
    s = s.strip()
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            return datetime_to_micros(_dt.datetime.strptime(s, fmt))
        except ValueError:
            continue
    raise ValueError(f"invalid datetime literal: {s!r}")


def format_datetime(us: int, tp: TypeCode = TypeCode.DATETIME) -> str:
    dt = micros_to_datetime(us)
    if tp == TypeCode.DATE:
        return dt.strftime("%Y-%m-%d")
    if dt.microsecond:
        return dt.strftime("%Y-%m-%d %H:%M:%S.%f")
    return dt.strftime("%Y-%m-%d %H:%M:%S")


# MySQL TIME range is [-838:59:59, 838:59:59] (ref: types/time.go MaxTime)
MAX_DURATION_US = ((838 * 3600 + 59 * 60 + 59) * 1_000_000)


def clamp_duration(us: int) -> int:
    return max(-MAX_DURATION_US, min(MAX_DURATION_US, int(us)))


def parse_duration(s: str) -> int:
    """MySQL TIME literal -> signed microseconds.
    Accepts '[-][D ]HH:MM:SS[.ffffff]', 'HH:MM', 'SS', and the packed
    numeric form HHMMSS (ref: types/time.go ParseDuration)."""
    s = s.strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:].strip()
    days = 0
    if " " in s:
        d, s = s.split(" ", 1)
        days = int(d)
    frac_us = 0
    if "." in s:
        s, f = s.split(".", 1)
        frac_us = int((f + "000000")[:6]) if f else 0
    if ":" in s:
        parts = [int(p or 0) for p in s.split(":")]
        if len(parts) == 2:
            h, m, sec = parts[0], parts[1], 0
        elif len(parts) == 3:
            h, m, sec = parts
        else:
            raise ValueError(f"invalid time literal: {s!r}")
    else:
        packed = int(s or 0)        # HHMMSS
        h, m, sec = packed // 10000, (packed // 100) % 100, packed % 100
    if m > 59 or sec > 59:
        raise ValueError(f"invalid time literal: {s!r}")
    us = ((days * 24 + h) * 3600 + m * 60 + sec) * 1_000_000 + frac_us
    return clamp_duration(-us if neg else us)


def format_duration(us: int, frac: int = -1) -> str:
    """Signed microseconds -> 'HH:MM:SS[.ffffff]'."""
    us = int(us)
    sign = "-" if us < 0 else ""
    us = abs(us)
    micro = us % 1_000_000
    sec = us // 1_000_000
    h, m, s = sec // 3600, (sec // 60) % 60, sec % 60
    out = f"{sign}{h:02d}:{m:02d}:{s:02d}"
    if frac > 0:
        out += "." + f"{micro:06d}"[:frac]
    elif frac < 0 and micro:
        out += f".{micro:06d}"
    return out
