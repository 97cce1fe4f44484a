"""Builtin registry extension — the rest of the reference's function table.

Reference: TiDB's expression/builtin.go:270 (the `funcs` map) and
the family files builtin_time.go, builtin_string.go, builtin_info.go,
builtin_miscellaneous.go, builtin_encryption.go, builtin_json.go.
Same contract as builtins.py: whole-column host evaluators registered by
name; NULL rules per function (MySQL semantics, asserted for the JAX
package in tests/test_builtins_ext.py and held against it for this copy
in tests/test_torch_builtins.py).

Functions the reference itself rejects with `errFunctionNotExists`
(DECODE/ENCODE/DES_*/ENCRYPT/OLD_PASSWORD/VALIDATE_PASSWORD_STRENGTH,
builtin_encryption.go:163-199) stay unregistered here too — a loud
"unsupported function" error is exact parity.
"""

from __future__ import annotations

import base64
import calendar
import datetime as _dt
import ipaddress
import struct
import threading
import time as _time
import uuid as _uuid
import zlib

import numpy as np

from tidb_tpu_torch.expression.builtins import (REGISTRY, _jdump, _jload, _json_ft,
                                          _micros, _mysql_fmt_to_strftime,
                                          _parse_path, _reg, _s, _to_us,
                                          _valid_all, _vec, _walk,
                                          _wrap_path_errors)
from tidb_tpu_torch.sqltypes import (MAX_DURATION_US, clamp_duration,
                               datetime_to_micros, format_datetime,
                               format_duration, micros_to_datetime,
                               new_datetime_field, new_date_field,
                               new_duration_field, new_int_field,
                               new_string_field, parse_datetime,
                               parse_duration)

_US_PER_DAY = 86_400_000_000
_EPOCH_DAYS = 719528          # days from year 0 to 1970-01-01 (TO_DAYS)


def _dur(x) -> int:
    """Duration-ish arg (int micros / TIME string) -> signed micros."""
    if isinstance(x, (int, np.integer)):
        return int(x)
    return parse_duration(_s(x))


def _numf(x, expr) -> float:
    """Numeric arg -> float, unscaling DECIMAL's scaled-int lane."""
    from tidb_tpu_torch.sqltypes import EvalType
    if expr.ft.eval_type == EvalType.DECIMAL:
        return float(x) / (10.0 ** max(expr.ft.frac, 0))
    return float(x)


def _const_valid(n):
    return np.ones(n, dtype=bool)


def _nullable(out, v, n, fill=""):
    """Per-row None in `out` -> NULL; keeps the rest of `v`."""
    bad = np.array([out[i] is None for i in range(n)], dtype=bool)
    v2 = v & ~bad
    for i in range(n):
        if out[i] is None:
            out[i] = fill
    return out, v2


# -- time: current-moment functions (volatile, like RAND) ---------------------
# The resolver folds NOW()/CURRENT_TIMESTAMP at plan time and marks the plan
# volatile; these are registered directly and re-evaluate per execution.

def _now_us() -> int:
    return datetime_to_micros(_dt.datetime.now())


def _utc_us() -> int:
    return datetime_to_micros(
        _dt.datetime.now(_dt.timezone.utc).replace(tzinfo=None))


def _reg_now(name, value_fn, ret_field):
    def fn(args, argv, n):
        return np.full(n, value_fn(), np.int64), _const_valid(n)
    _reg(name, 0, 1 if name in ("SYSDATE", "UTC_TIME", "UTC_TIMESTAMP",
                                "CURTIME", "CURRENT_TIME") else 0,
         lambda args: ret_field(), fn)


_reg_now("CURDATE", lambda: _now_us() // _US_PER_DAY * _US_PER_DAY,
         new_date_field)
_reg_now("CURRENT_DATE", lambda: _now_us() // _US_PER_DAY * _US_PER_DAY,
         new_date_field)
_reg_now("UTC_DATE", lambda: _utc_us() // _US_PER_DAY * _US_PER_DAY,
         new_date_field)
_reg_now("SYSDATE", _now_us, new_datetime_field)
# NOW()/CURRENT_TIMESTAMP fold at plan time in the resolver; these two
# synonyms (ref: nowFunctionClass) evaluate per execution like SYSDATE
_reg_now("LOCALTIME", _now_us, new_datetime_field)
_reg_now("LOCALTIMESTAMP", _now_us, new_datetime_field)
_reg_now("UTC_TIMESTAMP", _utc_us, new_datetime_field)
_reg_now("CURTIME", lambda: _now_us() % _US_PER_DAY, new_duration_field)
_reg_now("CURRENT_TIME", lambda: _now_us() % _US_PER_DAY, new_duration_field)
_reg_now("UTC_TIME", lambda: _utc_us() % _US_PER_DAY, new_duration_field)


# -- time: conversions --------------------------------------------------------

def _str_to_date(args, argv, n):
    """STR_TO_DATE(str, fmt): inverse DATE_FORMAT; unparseable -> NULL
    (ref: builtin_time.go strToDateFunctionClass)."""
    (sd, sv), (fd, fv) = argv
    v = sv & fv

    def one(x, fmt):
        py = _mysql_fmt_to_strftime(_s(fmt)).replace("%-", "%")
        try:
            dt = _dt.datetime.strptime(_s(x).strip(), py)
        except ValueError:
            return None
        return datetime_to_micros(dt)

    out = _vec(one, v, n, sd, fd, dtype=object)
    bad = np.array([out[i] is None for i in range(n)], dtype=bool)
    v2 = v & ~bad
    res = np.zeros(n, dtype=np.int64)
    for i in range(n):
        if v2[i]:
            res[i] = out[i]
    return res, v2


_reg("STR_TO_DATE", 2, 2, "datetime", _str_to_date)


def _time_format(args, argv, n):
    (td, tv), (fd, fv) = argv
    v = tv & fv

    def one(t, fmt):
        us = abs(_dur(t))
        sign = "-" if _dur(t) < 0 else ""
        sec = us // 1_000_000
        h, m, s = sec // 3600, (sec // 60) % 60, sec % 60
        micro = us % 1_000_000
        f = _s(fmt)
        rep = {"%H": f"{h:02d}", "%k": str(h), "%h": f"{(h % 12) or 12:02d}",
               "%I": f"{(h % 12) or 12:02d}", "%i": f"{m:02d}",
               "%s": f"{s:02d}", "%S": f"{s:02d}", "%f": f"{micro:06d}",
               "%p": "AM" if h % 24 < 12 else "PM",
               "%T": f"{h:02d}:{m:02d}:{s:02d}"}
        out = []
        i = 0
        while i < len(f):
            if f[i] == "%" and i + 1 < len(f):
                spec = f[i:i + 2]
                out.append(rep.get(spec, spec[1]))
                i += 2
            else:
                out.append(f[i])
                i += 1
        return sign + "".join(out)

    return _vec(one, v, n, td, fd), v


_reg("TIME_FORMAT", 2, 2, "string", _time_format)

_reg("FROM_DAYS", 1, 1, lambda args: new_date_field(),
     lambda a, argv, n: (
         (np.asarray(argv[0][0], np.int64) - _EPOCH_DAYS) * _US_PER_DAY,
         _valid_all(argv, n)))

_reg("TO_SECONDS", 1, 1, "int",
     lambda a, argv, n: (
         _micros(argv[0][0]) // 1_000_000 + _EPOCH_DAYS * 86400,
         _valid_all(argv, n)))


def _makedate(args, argv, n):
    (yd, yv), (dd, dv) = argv
    v = yv & dv

    def one(y, d):
        y, d = int(y), int(d)
        if d <= 0:
            return None
        if y < 70:
            y += 2000
        elif y < 100:
            y += 1900
        try:
            base = _dt.date(y, 1, 1) + _dt.timedelta(days=d - 1)
        except (ValueError, OverflowError):
            return None
        if base.year > 9999:
            return None
        return int(base.toordinal() - _dt.date(1970, 1, 1).toordinal()) \
            * _US_PER_DAY

    out = _vec(one, v, n, yd, dd, dtype=object)
    out, v2 = _nullable(out, v, n, fill=0)
    return np.array([int(x) for x in out], dtype=np.int64), v2


_reg("MAKEDATE", 2, 2, lambda args: new_date_field(), _makedate)


def _maketime(args, argv, n):
    (hd, hv), (md, mv), (sd, sv) = argv
    v = hv & mv & sv

    def one(h, m, s):
        h, m, s = int(h), int(m), _numf(s, args[2])
        if m < 0 or m > 59 or s < 0 or s >= 60:
            return None
        us = (abs(h) * 3600 + m * 60) * 1_000_000 + int(round(s * 1e6))
        return clamp_duration(-us if h < 0 else us)

    out = _vec(one, v, n, hd, md, sd, dtype=object)
    out, v2 = _nullable(out, v, n, fill=0)
    return np.array([int(x) for x in out], dtype=np.int64), v2


_reg("MAKETIME", 3, 3, lambda args: new_duration_field(frac=6), _maketime)

def _sec_to_time_ft(args):
    # fsp follows the argument: INT -> 0, DECIMAL -> its scale, REAL -> 6
    et = args[0].ft.eval_type.name
    if et == "DECIMAL":
        return new_duration_field(frac=min(max(args[0].ft.frac, 0), 6))
    return new_duration_field(frac=6 if et == "REAL" else 0)


_reg("SEC_TO_TIME", 1, 1, _sec_to_time_ft,
     lambda a, argv, n: (
         np.array([clamp_duration(int(_numf(x, a[0]) * 1e6))
                   for x in np.where(_valid_all(argv, n), argv[0][0], 0)],
                  dtype=np.int64),
         _valid_all(argv, n)))


def _time_to_sec(args, argv, n):
    d, v = argv[0]
    out = np.zeros(n, dtype=np.int64)
    ok = v.copy()
    for i in range(n):
        if not v[i]:
            continue
        try:
            out[i] = _dur(d[i]) // 1_000_000
        except ValueError:
            ok[i] = False        # unparseable time -> NULL (MySQL warns)
    return out, ok


_reg("TIME_TO_SEC", 1, 1, "int", _time_to_sec)


def _time_fn(args, argv, n):
    """TIME(expr): time part of a datetime/duration (ref: timeFunctionClass)."""
    d, v = argv[0]
    from tidb_tpu_torch.sqltypes import EvalType
    et = args[0].ft.eval_type

    def one(x):
        if et == EvalType.DURATION:
            return int(x)
        if et == EvalType.DATETIME:
            return int(x) % _US_PER_DAY
        s = _s(x)
        if "-" in s.lstrip("-"):
            try:
                return parse_datetime(s) % _US_PER_DAY
            except ValueError:
                return None
        try:
            return parse_duration(s)   # incl. the 'D HH:MM:SS' day form
        except ValueError:
            return None

    out = _vec(one, v, n, d, dtype=object)
    out, v2 = _nullable(out, v, n, fill=0)
    return np.array([int(x) for x in out], dtype=np.int64), v2


_reg("TIME", 1, 1, lambda args: new_duration_field(frac=6), _time_fn)


def _timestamp_fn(args, argv, n):
    v = _valid_all(argv, n)
    base = _micros(argv[0][0])
    if len(argv) == 2:
        add = np.zeros(n, dtype=np.int64)
        for i in range(n):
            if not v[i]:
                continue
            try:
                add[i] = _dur(argv[1][0][i])
            except ValueError:
                v = v.copy()
                v[i] = False     # unparseable time -> NULL (MySQL warns)
        base = base + add
    return base, v


_reg("TIMESTAMP", 1, 2, "datetime", _timestamp_fn)


def _timediff(args, argv, n):
    """TIMEDIFF(a, b) -> duration; mixed datetime/time args -> NULL
    (MySQL requires same types; ref: timeDiffFunctionClass)."""
    from tidb_tpu_torch.sqltypes import EvalType
    v = _valid_all(argv, n)
    ets = [a.ft.eval_type for a in args]

    def classify(x, et):
        if et == EvalType.DURATION:
            return ("t", int(x))
        if et == EvalType.DATETIME:
            return ("d", int(x))
        s = _s(x)
        if "-" in s.lstrip("-") and ":" in s or s.count("-") >= 2:
            try:
                return ("d", parse_datetime(s))
            except ValueError:
                return (None, 0)
        try:
            return ("t", parse_duration(s))
        except ValueError:
            return (None, 0)

    out = np.zeros(n, dtype=np.int64)
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        if not v[i]:
            continue
        k1, a = classify(argv[0][0][i], ets[0])
        k2, b = classify(argv[1][0][i], ets[1])
        if k1 is None or k2 is None or k1 != k2:
            continue
        ok[i] = True
        out[i] = clamp_duration(a - b)
    return out, ok


_reg("TIMEDIFF", 2, 2, lambda args: new_duration_field(frac=6), _timediff)


def _addtime(sign):
    def fn(args, argv, n):
        from tidb_tpu_torch.sqltypes import EvalType
        v = _valid_all(argv, n)
        et0 = args[0].ft.eval_type
        out = np.zeros(n, dtype=np.int64) if et0 != EvalType.STRING \
            else np.empty(n, dtype=object)
        ok = v.copy()
        for i in range(n):
            if not v[i]:
                if et0 == EvalType.STRING:
                    out[i] = ""
                continue
            try:
                delta = sign * _dur(argv[1][0][i])
            except ValueError:
                ok[i] = False
                if et0 == EvalType.STRING:
                    out[i] = ""
                continue
            if et0 == EvalType.DATETIME:
                out[i] = int(argv[0][0][i]) + delta
            elif et0 == EvalType.DURATION:
                out[i] = clamp_duration(int(argv[0][0][i]) + delta)
            else:
                s = _s(argv[0][0][i])
                try:
                    if s.count("-") >= 2:      # datetime-shaped string
                        us = parse_datetime(s) + delta
                        out[i] = format_datetime(us)
                    else:
                        us = clamp_duration(parse_duration(s) + delta)
                        out[i] = format_duration(us)
                except ValueError:
                    ok[i] = False
                    out[i] = ""
        return out, ok

    def ret(args):
        from tidb_tpu_torch.sqltypes import EvalType
        et0 = args[0].ft.eval_type
        if et0 == EvalType.DATETIME:
            return new_datetime_field()
        if et0 == EvalType.DURATION:
            return new_duration_field(frac=6)
        return new_string_field()
    return fn, ret


for _name, _sgn in [("ADDTIME", 1), ("SUBTIME", -1)]:
    _f, _r = _addtime(_sgn)
    _reg(_name, 2, 2, _r, _f)


def _weekofyear(args, argv, n):
    v = _valid_all(argv, n)

    def one(us):
        return micros_to_datetime(_to_us(us)).date().isocalendar()[1]

    return _vec(one, v, n, argv[0][0], dtype=np.int64), v


_reg("WEEKOFYEAR", 1, 1, "int", _weekofyear)


def _period_to_months(p: int) -> int:
    y, m = p // 100, p % 100
    if y < 70:
        y += 2000
    elif y < 100:
        y += 1900
    return y * 12 + m - 1


def _months_to_period(months: int) -> int:
    return (months // 12) * 100 + months % 12 + 1


_reg("PERIOD_ADD", 2, 2, "int",
     lambda a, argv, n: (
         np.array([_months_to_period(
             _period_to_months(int(p)) + int(k)) if ok else 0
             for p, k, ok in zip(argv[0][0], argv[1][0],
                                 _valid_all(argv, n))], dtype=np.int64),
         _valid_all(argv, n)))
_reg("PERIOD_DIFF", 2, 2, "int",
     lambda a, argv, n: (
         np.array([_period_to_months(int(p1)) - _period_to_months(int(p2))
                   if ok else 0
                   for p1, p2, ok in zip(argv[0][0], argv[1][0],
                                         _valid_all(argv, n))],
                  dtype=np.int64),
         _valid_all(argv, n)))


def _convert_tz(args, argv, n):
    """CONVERT_TZ(dt, from, to): numeric '+HH:MM' offsets only; named
    zones -> NULL (parity: MySQL without tz tables loaded)."""
    v = _valid_all(argv, n)

    def off(s):
        s = _s(s).strip()
        if s in ("SYSTEM", "UTC"):
            return 0
        if s and s[0] in "+-" and ":" in s:
            sign = -1 if s[0] == "-" else 1
            h, m = s[1:].split(":")
            return sign * (int(h) * 3600 + int(m) * 60) * 1_000_000
        return None

    out = np.zeros(n, dtype=np.int64)
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        if not v[i]:
            continue
        o1, o2 = off(argv[1][0][i]), off(argv[2][0][i])
        if o1 is None or o2 is None:
            continue
        ok[i] = True
        out[i] = _to_us(argv[0][0][i]) - o1 + o2
    return out, ok


_reg("CONVERT_TZ", 3, 3, "datetime", _convert_tz)

_GET_FORMATS = {
    ("DATE", "USA"): "%m.%d.%Y", ("DATE", "JIS"): "%Y-%m-%d",
    ("DATE", "ISO"): "%Y-%m-%d", ("DATE", "EUR"): "%d.%m.%Y",
    ("DATE", "INTERNAL"): "%Y%m%d",
    ("DATETIME", "USA"): "%Y-%m-%d %H.%i.%s",
    ("DATETIME", "JIS"): "%Y-%m-%d %H:%i:%s",
    ("DATETIME", "ISO"): "%Y-%m-%d %H:%i:%s",
    ("DATETIME", "EUR"): "%Y-%m-%d %H.%i.%s",
    ("DATETIME", "INTERNAL"): "%Y%m%d%H%i%s",
    ("TIME", "USA"): "%h:%i:%s %p", ("TIME", "JIS"): "%H:%i:%s",
    ("TIME", "ISO"): "%H:%i:%s", ("TIME", "EUR"): "%H.%i.%s",
    ("TIME", "INTERNAL"): "%H%i%s",
}
# TIMESTAMP is a synonym for DATETIME here (MySQL docs GET_FORMAT)
for _loc in ("USA", "JIS", "ISO", "EUR", "INTERNAL"):
    _GET_FORMATS[("TIMESTAMP", _loc)] = _GET_FORMATS[("DATETIME", _loc)]


def _get_format(args, argv, n):
    v = _valid_all(argv, n)
    out = _vec(lambda t, loc: _GET_FORMATS.get(
        (_s(t).upper(), _s(loc).upper())), v, n, argv[0][0], argv[1][0])
    return _nullable(out, v, n)


_reg("GET_FORMAT", 2, 2, "string", _get_format)


# -- string -------------------------------------------------------------------

def _format_number(args, argv, n):
    """FORMAT(x, d): thousands separators, rounded to d decimals."""
    from tidb_tpu_torch.sqltypes import EvalType
    v = _valid_all(argv, n)
    et = args[0].ft.eval_type

    def one(x, d):
        d = max(int(d), 0)
        if et == EvalType.DECIMAL:
            from tidb_tpu_torch.sqltypes import scaled_to_decimal
            val = scaled_to_decimal(int(x), max(args[0].ft.frac, 0))
        else:
            val = float(x) if et == EvalType.REAL else int(x)
        return f"{val:,.{d}f}"

    return _vec(one, v, n, argv[0][0], argv[1][0]), v


_reg("FORMAT", 2, 2, "string", _format_number)

_reg("TO_BASE64", 1, 1, "string",
     lambda a, argv, n: (
         _vec(lambda x: base64.b64encode(
             x if isinstance(x, bytes) else _s(x).encode()).decode(),
             argv[0][1], n, argv[0][0]), argv[0][1]))


def _from_base64(args, argv, n):
    d, v = argv[0]

    def one(x):
        try:
            return base64.b64decode(_s(x), validate=True).decode(
                "utf-8", "replace")
        except Exception:
            return None

    out = _vec(one, v, n, d)
    return _nullable(out, v, n)


_reg("FROM_BASE64", 1, 1, "string", _from_base64)


def _insert_str(args, argv, n):
    v = _valid_all(argv, n)

    def one(x, pos, ln, new):
        x, new, pos, ln = _s(x), _s(new), int(pos), int(ln)
        if pos < 1 or pos > len(x):
            return x
        if ln < 0 or pos + ln - 1 >= len(x):
            return x[:pos - 1] + new
        return x[:pos - 1] + new + x[pos - 1 + ln:]

    return _vec(one, v, n, *[d for d, _ in argv]), v


_reg("INSERT", 4, 4, "string", _insert_str)


def _export_set(args, argv, n):
    v = _valid_all(argv, n)

    def one(bits, on, off, sep=",", count=64):
        bits = int(bits) & ((1 << 64) - 1)
        count = min(max(int(count), 0), 64)
        return _s(sep).join(
            _s(on) if bits & (1 << i) else _s(off)
            for i in range(count))

    return _vec(one, v, n, *[d for d, _ in argv]), v


_reg("EXPORT_SET", 3, 5, "string", _export_set)


def _make_set(args, argv, n):
    bd, bv = argv[0]
    out = np.empty(n, dtype=object)
    for i in range(n):
        if not bv[i]:
            out[i] = ""
            continue
        bits = int(bd[i])
        parts = []
        for k in range(1, len(argv)):
            d, av = argv[k]
            if bits & (1 << (k - 1)) and av[i]:
                parts.append(_s(d[i]))
        out[i] = ",".join(parts)
    return out, bv


_reg("MAKE_SET", 2, 64, "string", _make_set)

# ORD: leading utf8 bytes of the first character as a base-256 number
_reg("ORD", 1, 1, "int",
     lambda a, argv, n: (
         _vec(lambda x: int.from_bytes(_s(x)[:1].encode("utf8"), "big")
              if _s(x) else 0, argv[0][1], n, argv[0][0],
              dtype=np.int64), argv[0][1]))


def _char_fn(args, argv, n):
    """CHAR(n, ...): each int contributes its bytes (base-256); NULL args
    are skipped; result interpreted as utf8 (ref: charFunctionClass)."""
    out = np.empty(n, dtype=object)
    for i in range(n):
        bs = b""
        for (d, av), arg in zip(argv, args):
            if not av[i]:
                continue
            try:
                x = int(round(_numf(d[i], arg))) & 0xFFFFFFFF
            except (ValueError, TypeError):
                x = 0            # non-numeric -> 0 (MySQL warns)
            nb = max(1, (x.bit_length() + 7) // 8)
            bs += x.to_bytes(nb, "big")
        out[i] = bs.decode("utf-8", "replace")
    return out, _const_valid(n)


_reg("CHAR", 1, 64, "string", _char_fn)

# LOAD_FILE: NULL without FILE privilege — always NULL here, like a locked-
# down MySQL (ref: loadFileFunctionClass)
_reg("LOAD_FILE", 1, 1, "string",
     lambda a, argv, n: (np.full(n, "", dtype=object),
                         np.zeros(n, dtype=bool)))


# -- information --------------------------------------------------------------

_reg("CHARSET", 1, 1, "string",
     lambda a, argv, n: (np.full(n, "utf8mb4", dtype=object),
                         _const_valid(n)))


def _collation_of(args, argv, n):
    coll = getattr(args[0].ft, "collation", None) or "utf8mb4_bin"
    return np.full(n, coll, dtype=object), _const_valid(n)


_reg("COLLATION", 1, 1, "string", _collation_of)
# constants are coercibility 4, columns 2 (ref: builtin_info.go Coercibility)
_reg("COERCIBILITY", 1, 1, "int",
     lambda a, argv, n: (
         np.full(n, 4 if not a[0].columns_used() else 2, np.int64),
         _const_valid(n)))


def _tidb_version(args, argv, n):
    from tidb_tpu_torch.config import SERVER_VERSION
    return (np.full(n, f"tidb_tpu-{SERVER_VERSION}", dtype=object),
            _const_valid(n))


_reg("TIDB_VERSION", 0, 0, "string", _tidb_version)


# -- miscellaneous ------------------------------------------------------------

def _inet_aton(args, argv, n):
    d, v = argv[0]

    def one(x):
        # MySQL: 'a.b' == a<<24 | b ; short forms fill from the right
        parts = _s(x).split(".")
        if not 1 <= len(parts) <= 4 or not all(p.isdigit() for p in parts):
            return None
        vals = [int(p) for p in parts]
        if any(p > 255 for p in vals[:-1]) or vals[-1] >= 256 ** (
                5 - len(vals)):
            return None
        out = 0
        for p in vals[:-1]:
            out = (out << 8) | p
        return (out << (8 * (4 - len(vals) + 1))) | vals[-1]

    out = _vec(one, v, n, d, dtype=object)
    out, v2 = _nullable(out, v, n, fill=0)
    return np.array([int(x) for x in out], dtype=np.int64), v2


_reg("INET_ATON", 1, 1, "int", _inet_aton)


def _inet_ntoa(args, argv, n):
    d, v = argv[0]

    def one(x):
        x = int(x)
        if x < 0 or x > 0xFFFFFFFF:
            return None
        return ".".join(str((x >> s) & 0xFF) for s in (24, 16, 8, 0))

    out = _vec(one, v, n, d)
    return _nullable(out, v, n)


_reg("INET_NTOA", 1, 1, "string", _inet_ntoa)


def _inet6_aton(args, argv, n):
    d, v = argv[0]

    def one(x):
        try:
            return ipaddress.ip_address(_s(x)).packed
        except ValueError:
            return None

    out = _vec(one, v, n, d)
    return _nullable(out, v, n)


_reg("INET6_ATON", 1, 1, "string", _inet6_aton)


def _inet6_ntoa(args, argv, n):
    d, v = argv[0]

    def one(x):
        b = x if isinstance(x, bytes) else _s(x).encode("latin1")
        if len(b) == 4:
            return str(ipaddress.IPv4Address(b))
        if len(b) == 16:
            return str(ipaddress.IPv6Address(b))
        return None

    out = _vec(one, v, n, d)
    return _nullable(out, v, n)


_reg("INET6_NTOA", 1, 1, "string", _inet6_ntoa)


def _ip_pred(test):
    def fn(args, argv, n):
        d, v = argv[0]
        return _vec(lambda x: 1 if test(x) else 0, v, n, d,
                    dtype=np.int64), v
    return fn


def _is_ipv4(x):
    try:
        ipaddress.IPv4Address(_s(x))
        return True
    except ValueError:
        return False


def _is_ipv6(x):
    try:
        ipaddress.IPv6Address(_s(x))
        return True
    except ValueError:
        return False


def _packed16(x):
    b = x if isinstance(x, bytes) else _s(x).encode("latin1")
    return b if len(b) == 16 else None


_reg("IS_IPV4", 1, 1, "int", _ip_pred(_is_ipv4))
_reg("IS_IPV6", 1, 1, "int", _ip_pred(_is_ipv6))
_reg("IS_IPV4_COMPAT", 1, 1, "int", _ip_pred(
    lambda x: (lambda b: b is not None and b[:12] == b"\x00" * 12 and
               b[12:] != b"\x00\x00\x00\x00")(_packed16(x))))
_reg("IS_IPV4_MAPPED", 1, 1, "int", _ip_pred(
    lambda x: (lambda b: b is not None and
               b[:12] == b"\x00" * 10 + b"\xff\xff")(_packed16(x))))

_reg("UUID", 0, 0, "string",
     lambda a, argv, n: (np.array([str(_uuid.uuid1()) for _ in range(n)],
                                  dtype=object), _const_valid(n)))

_uuid_short_lock = threading.Lock()
_uuid_short_counter = [int(_time.time()) << 24]


def _uuid_short(args, argv, n):
    out = np.empty(n, dtype=np.int64)
    with _uuid_short_lock:
        for i in range(n):
            _uuid_short_counter[0] += 1
            out[i] = _uuid_short_counter[0] & 0x7FFFFFFFFFFFFFFF
    return out, _const_valid(n)


_reg("UUID_SHORT", 0, 0, "int", _uuid_short)

_reg("ANY_VALUE", 1, 1, "first",
     lambda a, argv, n: argv[0])


def _sleep(args, argv, n):
    d, v = argv[0]
    try:
        total = float(sum(_numf(d[i], args[0])
                          for i in range(n) if v[i]))
    except (TypeError, ValueError):
        from tidb_tpu_torch.executor import ExecError
        raise ExecError(
            "Incorrect arguments to sleep") from None
    _time.sleep(min(max(total, 0.0), 10.0))   # bounded: KILL still works
    return np.zeros(n, dtype=np.int64), _const_valid(n)


_reg("SLEEP", 1, 1, "int", _sleep)

# args are evaluated once per chunk already; BENCHMARK just returns 0
_reg("BENCHMARK", 2, 2, "int",
     lambda a, argv, n: (np.zeros(n, dtype=np.int64), _const_valid(n)))

_reg("NAME_CONST", 2, 2, lambda args: args[1].ft,
     lambda a, argv, n: argv[1])


def _bit_count(args, argv, n):
    d, v = argv[0]
    return (_vec(lambda x: bin(int(x) & ((1 << 64) - 1)).count("1"),
                 v, n, d, dtype=np.int64), v)


_reg("BIT_COUNT", 1, 1, "int", _bit_count)

# advisory locks parse-and-succeed, like the reference's lockFunctionClass
# (builtin.go:470-473: "parsed but do nothing")
_reg("GET_LOCK", 2, 2, "int",
     lambda a, argv, n: (np.ones(n, dtype=np.int64), _const_valid(n)))
_reg("RELEASE_LOCK", 1, 1, "int",
     lambda a, argv, n: (np.ones(n, dtype=np.int64), _const_valid(n)))
_reg("IS_FREE_LOCK", 1, 1, "int",
     lambda a, argv, n: (np.ones(n, dtype=np.int64), _const_valid(n)))
_reg("IS_USED_LOCK", 1, 1, "int",
     lambda a, argv, n: (np.zeros(n, dtype=np.int64),
                         np.zeros(n, dtype=bool)))   # always NULL
_reg("RELEASE_ALL_LOCKS", 0, 0, "int",
     lambda a, argv, n: (np.zeros(n, dtype=np.int64), _const_valid(n)))


def _interval_fn(args, argv, n):
    """INTERVAL(n, a1, a2, ...): index of the last ai <= n (binary-search
    semantics; NULL n -> -1). Ref: intervalFunctionClass."""
    nd, nv = argv[0]
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        if not nv[i]:
            out[i] = -1
            continue
        x = _numf(nd[i], args[0])
        k = 0
        for j in range(1, len(argv)):
            d, av = argv[j]
            if av[i] and _numf(d[i], args[j]) <= x:
                k = j
            elif av[i]:
                break
        out[i] = k
    return out, _const_valid(n)


_reg("INTERVAL", 2, 64, "int", _interval_fn)


# -- compression / password (builtin_encryption.go) ---------------------------

def _compress(args, argv, n):
    d, v = argv[0]

    def one(x):
        b = x if isinstance(x, bytes) else _s(x).encode()
        if not b:
            return b""
        return struct.pack("<I", len(b)) + zlib.compress(b)

    return _vec(one, v, n, d), v


def _uncompress(args, argv, n):
    d, v = argv[0]

    def one(x):
        b = x if isinstance(x, bytes) else _s(x).encode("latin1")
        if not b:
            return ""
        if len(b) <= 4:
            return None
        try:
            out = zlib.decompress(b[4:])
        except zlib.error:
            return None
        if len(out) != struct.unpack("<I", b[:4])[0]:
            return None
        return out.decode("utf-8", "replace")

    out = _vec(one, v, n, d)
    return _nullable(out, v, n)


def _uncompressed_length(args, argv, n):
    d, v = argv[0]

    def one(x):
        b = x if isinstance(x, bytes) else _s(x).encode("latin1")
        if not b:
            return 0
        if len(b) <= 4:
            return 0
        return struct.unpack("<I", b[:4])[0]

    return _vec(one, v, n, d, dtype=np.int64), v


_reg("COMPRESS", 1, 1, "string", _compress)
_reg("UNCOMPRESS", 1, 1, "string", _uncompress)
_reg("UNCOMPRESSED_LENGTH", 1, 1, "int", _uncompressed_length)


def _password(args, argv, n):
    import hashlib
    d, v = argv[0]

    def one(x):
        s = _s(x)
        if not s:
            return ""
        return "*" + hashlib.sha1(
            hashlib.sha1(s.encode()).digest()).hexdigest().upper()

    return _vec(one, v, n, d), v


_reg("PASSWORD", 1, 1, "string", _password)


def _random_bytes(args, argv, n):
    import os
    d, v = argv[0]

    def one(x):
        k = int(x)
        if not 1 <= k <= 1024:
            raise ValueError("length argument to random_bytes "
                             "out of range (1..1024)")
        return os.urandom(k)

    try:
        return _vec(one, v, n, d), v
    except ValueError as e:
        from tidb_tpu_torch.executor import ExecError
        raise ExecError(str(e)) from None


_reg("RANDOM_BYTES", 1, 1, "string", _random_bytes)


def _mysql_aes_key(key: bytes) -> bytes:
    """MySQL key folding: XOR the key bytes cyclically into 16 bytes."""
    out = bytearray(16)
    for i, b in enumerate(key):
        out[i % 16] ^= b
    return bytes(out)


_AES_HAVE_CRYPTOGRAPHY = None   # backend choice cached after first call


def _aes_ecb(k: bytes, data: bytes, encrypt: bool) -> bytes:
    """AES-128 ECB over full blocks: the `cryptography` package when the
    image ships it, else the pure-python fallback (util/aes128.py) —
    identical bytes either way (both FIPS-197). This runs per ROW, so
    the backend probe must happen once, not as a failed import per
    call (failed imports are never cached in sys.modules)."""
    global _AES_HAVE_CRYPTOGRAPHY
    if _AES_HAVE_CRYPTOGRAPHY is None:
        try:
            import cryptography.hazmat.primitives.ciphers  # noqa: F401
            _AES_HAVE_CRYPTOGRAPHY = True
        except ImportError:
            _AES_HAVE_CRYPTOGRAPHY = False
    if not _AES_HAVE_CRYPTOGRAPHY:
        from tidb_tpu_torch.util.aes128 import decrypt_block, encrypt_block
        op = encrypt_block if encrypt else decrypt_block
        return b"".join(op(k, data[i:i + 16])
                        for i in range(0, len(data), 16))
    from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                        algorithms,
                                                        modes)
    cipher = Cipher(algorithms.AES(k), modes.ECB())
    ctx = cipher.encryptor() if encrypt else cipher.decryptor()
    return ctx.update(data) + ctx.finalize()


def _aes(encrypt: bool):
    def fn(args, argv, n):
        v = _valid_all(argv, n)

        def one(x, key):
            k = _mysql_aes_key(
                key if isinstance(key, bytes) else _s(key).encode())
            data = x if isinstance(x, bytes) else _s(x).encode()
            if encrypt:
                pad = 16 - len(data) % 16
                data += bytes([pad]) * pad
                return _aes_ecb(k, data, encrypt=True)
            if len(data) % 16 or not data:
                return None
            out = _aes_ecb(k, data, encrypt=False)
            pad = out[-1]
            if not 1 <= pad <= 16 or out[-pad:] != bytes([pad]) * pad:
                return None
            try:
                return out[:-pad].decode("utf8")
            except UnicodeDecodeError:
                return out[:-pad]

        out = _vec(one, v, n, argv[0][0], argv[1][0])
        return _nullable(out, v, n)
    return fn


_reg("AES_ENCRYPT", 2, 2, "string", _aes(True))
_reg("AES_DECRYPT", 2, 2, "string", _aes(False))


# -- JSON modify/search (builtin_json.go) -------------------------------------

def _json_quote(args, argv, n):
    d, v = argv[0]
    return _vec(lambda x: _jdump(_s(x)), v, n, d), v


_reg("JSON_QUOTE", 1, 1, "string", _json_quote)


def _set_path(doc, steps, value, create, replace):
    """In-place path set. `create`: may add a new leaf; `replace`: may
    overwrite an existing one (JSON_SET: both; INSERT: create only;
    REPLACE: replace only)."""
    if not steps:
        return value if replace else doc
    cur = doc
    for s in steps[:-1]:
        if isinstance(s, int):
            if not isinstance(cur, list) or not (0 <= s < len(cur)):
                return doc
            cur = cur[s]
        else:
            if not isinstance(cur, dict) or s not in cur:
                return doc
            cur = cur[s]
    last = steps[-1]
    if isinstance(last, int):
        if not isinstance(cur, list):
            # MySQL: autowrap scalar -> array when appending at [N]
            return doc
        if 0 <= last < len(cur):
            if replace:
                cur[last] = value
        elif create:
            cur.append(value)
    else:
        if isinstance(cur, dict):
            if last in cur:
                if replace:
                    cur[last] = value
            elif create:
                cur[last] = value
    return doc


def _json_modify(create, replace):
    def fn(args, argv, n):
        if len(argv) % 2 == 0:
            from tidb_tpu_torch.executor import ExecError
            raise ExecError("Incorrect parameter count")
        from tidb_tpu_torch.expression.builtins import _arg_to_json
        dv, docv = argv[0]
        out = np.empty(n, dtype=object)
        ok = docv.copy()
        for i in range(n):
            if not docv[i]:
                out[i] = ""
                continue
            doc = _jload(dv[i])
            null_path = False
            for k in range(1, len(argv), 2):
                pd_, pv = argv[k]
                vd, vv = argv[k + 1]
                if not pv[i]:
                    null_path = True
                    break
                val = _arg_to_json(vd[i], vv[i], args[k + 1])
                doc = _set_path(doc, list(_parse_path(_s(pd_[i]))),
                                val, create, replace)
            if null_path:
                ok[i] = False
                out[i] = ""
            else:
                out[i] = _jdump(doc)
        return out, ok
    return fn


_reg("JSON_SET", 3, 32, _json_ft,
     _wrap_path_errors(_json_modify(True, True)))
_reg("JSON_INSERT", 3, 32, _json_ft,
     _wrap_path_errors(_json_modify(True, False)))
_reg("JSON_REPLACE", 3, 32, _json_ft,
     _wrap_path_errors(_json_modify(False, True)))


def _remove_path(doc, steps):
    if not steps:
        return doc
    cur = doc
    for s in steps[:-1]:
        if isinstance(s, int):
            if not isinstance(cur, list) or not (0 <= s < len(cur)):
                return doc
            cur = cur[s]
        else:
            if not isinstance(cur, dict) or s not in cur:
                return doc
            cur = cur[s]
    last = steps[-1]
    if isinstance(last, int):
        if isinstance(cur, list) and 0 <= last < len(cur):
            del cur[last]
    elif isinstance(cur, dict) and last in cur:
        del cur[last]
    return doc


def _json_remove(args, argv, n):
    dv, docv = argv[0]
    v = _valid_all(argv, n)
    out = np.empty(n, dtype=object)
    for i in range(n):
        if not v[i]:
            out[i] = ""
            continue
        doc = _jload(dv[i])
        for k in range(1, len(argv)):
            doc = _remove_path(doc, list(_parse_path(_s(argv[k][0][i]))))
        out[i] = _jdump(doc)
    return out, v


_reg("JSON_REMOVE", 2, 32, _json_ft, _wrap_path_errors(_json_remove))


def _merge_two(a, b):
    """MySQL 5.7 JSON_MERGE: arrays concat; objects merge recursively;
    scalars wrap into arrays."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v2 in b.items():
            out[k] = _merge_two(out[k], v2) if k in out else v2
        return out
    la = a if isinstance(a, list) else [a]
    lb = b if isinstance(b, list) else [b]
    return la + lb


def _json_merge(args, argv, n):
    v = _valid_all(argv, n)
    out = np.empty(n, dtype=object)
    for i in range(n):
        if not v[i]:
            out[i] = ""
            continue
        doc = _jload(argv[0][0][i])
        for k in range(1, len(argv)):
            doc = _merge_two(doc, _jload(argv[k][0][i]))
        out[i] = _jdump(doc)
    return out, v


_reg("JSON_MERGE", 2, 32, _json_ft, _json_merge)


def _json_array_append(args, argv, n):
    if len(argv) % 2 == 0:
        from tidb_tpu_torch.executor import ExecError
        raise ExecError("Incorrect parameter count")
    from tidb_tpu_torch.expression.builtins import _arg_to_json
    dv, docv = argv[0]
    v = _valid_all(argv, n)
    out = np.empty(n, dtype=object)
    for i in range(n):
        if not v[i]:
            out[i] = ""
            continue
        doc = _jload(dv[i])
        for k in range(1, len(argv), 2):
            steps = list(_parse_path(_s(argv[k][0][i])))
            val = _arg_to_json(argv[k + 1][0][i], argv[k + 1][1][i],
                               args[k + 1])
            found, target = _walk(doc, steps)
            if not found:
                continue
            wrapped = target + [val] if isinstance(target, list) \
                else [target, val]
            if steps:
                doc = _set_path(doc, steps, wrapped, False, True)
            else:
                doc = wrapped
        out[i] = _jdump(doc)
    return out, v


_reg("JSON_ARRAY_APPEND", 3, 32, _json_ft,
     _wrap_path_errors(_json_array_append))


def _json_contains_path(args, argv, n):
    v = _valid_all(argv, n)
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        if not v[i]:
            continue
        doc = _jload(argv[0][0][i])
        mode = _s(argv[1][0][i]).lower()
        if mode not in ("one", "all"):
            from tidb_tpu_torch.executor import ExecError
            raise ExecError(
                "The oneOrAll argument to json_contains_path may take "
                "these values: 'one' or 'all'")
        hits = [
            _walk(doc, _parse_path(_s(argv[k][0][i])))[0]
            for k in range(2, len(argv))]
        out[i] = int(all(hits) if mode == "all" else any(hits))
    return out, v


_reg("JSON_CONTAINS_PATH", 3, 32, "int",
     _wrap_path_errors(_json_contains_path))


def _depth(doc) -> int:
    if isinstance(doc, dict):
        return 1 + max((_depth(v) for v in doc.values()), default=0)
    if isinstance(doc, list):
        return 1 + max((_depth(v) for v in doc), default=0)
    return 1


_reg("JSON_DEPTH", 1, 1, "int",
     lambda a, argv, n: (
         _vec(lambda x: _depth(_jload(x)), argv[0][1], n, argv[0][0],
              dtype=np.int64), argv[0][1]))


def _like_match(pat: str, s: str) -> bool:
    import re
    rx = re.escape(pat).replace("%", ".*").replace("_", ".")
    return re.fullmatch(rx, s, re.S) is not None


def _search_paths(doc, pat, prefix="$"):
    hits = []
    if isinstance(doc, str):
        if _like_match(pat, doc):
            hits.append(prefix)
    elif isinstance(doc, dict):
        for k, v2 in doc.items():
            hits.extend(_search_paths(v2, pat, f'{prefix}.{k}'))
    elif isinstance(doc, list):
        for j, v2 in enumerate(doc):
            hits.extend(_search_paths(v2, pat, f"{prefix}[{j}]"))
    return hits


def _json_search(args, argv, n):
    v = _valid_all(argv, n)
    out = np.empty(n, dtype=object)
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        out[i] = ""
        if not v[i]:
            continue
        doc = _jload(argv[0][0][i])
        mode = _s(argv[1][0][i]).lower()
        if mode not in ("one", "all"):
            from tidb_tpu_torch.executor import ExecError
            raise ExecError(
                "The oneOrAll argument to json_search may take these "
                "values: 'one' or 'all'")
        hits = _search_paths(doc, _s(argv[2][0][i]))
        if not hits:
            continue
        ok[i] = True
        out[i] = _jdump(hits[0]) if mode == "one" or len(hits) == 1 \
            else _jdump(hits)
    return out, ok


_reg("JSON_SEARCH", 3, 3, _json_ft, _json_search)
