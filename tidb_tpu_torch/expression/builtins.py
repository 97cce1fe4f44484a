"""Builtin scalar function registry — the breadth families (the port's
copy of the JAX package's module; host-only there and here; held
against it through SQL in tests/test_torch_builtins.py).

Reference: TiDB's expression/builtin_math.go, builtin_string.go,
builtin_time.go, builtin_encryption.go, builtin_compare.go (the builtin
families that make up most of the reference's 40.9k expression LoC).
The high-traffic TPC-H operators live as first-class Ops in core.py with
device paths; everything here is the long tail: registered by name
in one table, evaluated whole-column on the host (numpy), with a handful
of pure-numeric ones marked device-safe (none yet: GENERIC builtins
always take the host path; promote hot ones to core Ops when needed).

Each FnSpec:
  * arity check at resolve time (min/max args);
  * result typing (`ret`: fixed eval kind or a callable over arg exprs);
  * `fn(args, argv, n)` whole-column evaluator -> (data, valid) where
    argv is [(data, valid)] numpy pairs;
  * NULL handling is each fn's own job: most AND their args' validity
    masks; CONCAT_WS/ELT/FIELD implement MySQL's special NULL rules.
"""

from __future__ import annotations

import calendar
import datetime as _dt
import hashlib
import math
import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

from tidb_tpu_torch.sqltypes import (micros_to_datetime, new_datetime_field,
                               new_double_field, new_int_field,
                               new_string_field)

__all__ = ["REGISTRY", "FnSpec", "lookup"]

_US_PER_DAY = 86_400_000_000


@dataclass(frozen=True)
class FnSpec:
    name: str
    min_args: int
    max_args: int
    ret: object                  # "int"|"real"|"string"|"datetime"|"first"|callable
    fn: Callable

    def result_ft(self, args):
        if callable(self.ret):
            return self.ret(args)
        from tidb_tpu_torch.sqltypes import new_duration_field
        return {"int": new_int_field, "real": new_double_field,
                "string": lambda: new_string_field(),
                # VARBINARY producers (UNHEX): compare layers use the
                # binary collation marker to lift bytes for ordering
                "binary": _new_binary_field,
                "datetime": new_datetime_field,
                "duration": new_duration_field,
                "first": lambda: args[0].ft}[self.ret]()

    def __hash__(self):
        return hash(self.name)

    def __reduce__(self):
        # registry fns are closures; pickle by NAME and rehydrate from
        # the registry, so expressions holding a spec cross the storage
        # RPC (host_filter pushdown to the out-of-process coprocessor)
        return (_restore_spec, (self.name,))


def _restore_spec(name: str) -> "FnSpec":
    return REGISTRY[name]


def _new_binary_field():
    import dataclasses
    return dataclasses.replace(new_string_field(), collation="binary")


REGISTRY: dict[str, FnSpec] = {}


def _reg(name, min_args, max_args, ret, fn, **kw):
    REGISTRY[name] = FnSpec(name, min_args, max_args, ret, fn, **kw)


def lookup(name: str) -> FnSpec | None:
    return REGISTRY.get(name)


# -- helpers -----------------------------------------------------------------

def _s(x) -> str:
    from tidb_tpu_torch.sqltypes import bytes_to_str
    return bytes_to_str(x)


def _valid_all(argv, n):
    v = np.ones(n, dtype=bool)
    for _d, av in argv:
        v = v & av
    return v


def _vec(fn, valid, n, *arrs, dtype=object):
    out = np.empty(n, dtype=dtype)
    fill = "" if dtype == object else 0
    for i in range(n):
        out[i] = fn(*(a[i] for a in arrs)) if valid[i] else fill
    return out


def _num(argv):
    return [np.asarray(d, dtype=np.float64) for d, _v in argv]


def _micros(d) -> np.ndarray:
    """Datetime arg -> epoch-micros int64; string datetime literals (and
    object columns) parse with MySQL semantics."""
    arr = np.asarray(d)
    if arr.dtype == object:
        from tidb_tpu_torch.sqltypes import parse_datetime
        out = np.zeros(len(arr), dtype=np.int64)
        for i, x in enumerate(arr):
            if x is None or x == "":
                continue
            out[i] = int(x) if isinstance(x, (int, np.integer)) \
                else parse_datetime(_s(x))
        return out
    return arr.astype(np.int64)


def _dtarr(d):
    """epoch-micros -> numpy datetime64[us] (vectorized calendar)."""
    return _micros(d).view("datetime64[us]")


# -- math (builtin_math.go) --------------------------------------------------

def _unary_math(mfn):
    def fn(args, argv, n):
        (d,) = _num(argv)
        with np.errstate(all="ignore"):
            out = mfn(d)
        v = _valid_all(argv, n) & np.isfinite(out)
        return np.where(v, out, 0.0), v
    return fn


for _name, _m in [("SIN", np.sin), ("COS", np.cos), ("TAN", np.tan),
                  ("ASIN", np.arcsin), ("ACOS", np.arccos),
                  ("LOG10", np.log10), ("RADIANS", np.radians),
                  ("DEGREES", np.degrees)]:
    _reg(_name, 1, 1, "real", _unary_math(_m))


def _cot(args, argv, n):
    (d,) = _num(argv)
    with np.errstate(all="ignore"):
        out = 1.0 / np.tan(d)
    v = _valid_all(argv, n) & np.isfinite(out)
    return np.where(v, out, 0.0), v


_reg("COT", 1, 1, "real", _cot)


def _atan(args, argv, n):
    nums = _num(argv)
    out = np.arctan2(nums[0], nums[1]) if len(nums) == 2 \
        else np.arctan(nums[0])
    return out, _valid_all(argv, n)


_reg("ATAN", 1, 2, "real", _atan)
_reg("ATAN2", 2, 2, "real",
     lambda a, argv, n: (np.arctan2(*_num(argv)), _valid_all(argv, n)))


def _log(args, argv, n):
    nums = _num(argv)
    with np.errstate(all="ignore"):
        if len(nums) == 2:          # LOG(b, x)
            out = np.log(nums[1]) / np.log(nums[0])
        else:
            out = np.log(nums[0])
    v = _valid_all(argv, n) & np.isfinite(out)
    return np.where(v, out, 0.0), v


_reg("LOG", 1, 2, "real", _log)
_reg("PI", 0, 0, "real",
     lambda a, argv, n: (np.full(n, math.pi), np.ones(n, dtype=bool)))


def _truncate(args, argv, n):
    from tidb_tpu_torch.sqltypes import EvalType
    (xd, xv), (dd, dv) = argv
    v = xv & dv
    if args[0].ft.eval_type == EvalType.INT:
        # negative D zeroes low digits TOWARD zero; D >= 0 is identity
        p = np.power(10, -np.minimum(np.asarray(dd, np.int64), 0)
                     ).astype(np.int64)
        x = np.asarray(xd, np.int64)
        out = np.sign(x) * ((np.abs(x) // p) * p)
        return out, v
    x = np.asarray(xd, np.float64)
    if args[0].ft.eval_type == EvalType.DECIMAL:
        x = x / (10.0 ** max(args[0].ft.frac, 0))   # unscale
    p = np.power(10.0, np.asarray(dd, np.float64))
    return np.trunc(x * p) / p, v


_reg("TRUNCATE", 2, 2,
     lambda args: args[0].ft if args[0].ft.eval_type.name == "INT"
     else new_double_field(), _truncate)


def _crc32(args, argv, n):
    d, v = argv[0]
    return _vec(lambda x: zlib.crc32(_s(x).encode()), v, n, d,
                dtype=np.int64), v


_reg("CRC32", 1, 1, "int", _crc32)


def _rand(args, argv, n):
    if argv:
        seed = int(argv[0][0][0]) if len(argv[0][0]) else 0
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
    else:
        rng = np.random
    return rng.random_sample(n), np.ones(n, dtype=bool)


_reg("RAND", 0, 1, "real", _rand)


def _conv_base(args, argv, n):
    (xd, xv), (fd, fv), (td, tv) = argv
    v = xv & fv & tv

    def one(x, f, t):
        try:
            val = int(_s(x), int(f))
        except ValueError:
            return ""
        t = int(t)
        if val == 0:
            return "0"
        digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        neg, val = val < 0, abs(val)
        out = []
        while val:
            out.append(digits[val % t])
            val //= t
        return ("-" if neg else "") + "".join(reversed(out))

    return _vec(one, v, n, xd, fd, td), v


_reg("CONV", 3, 3, "string", _conv_base)
# negatives render as 64-bit two's complement, as MySQL does
_U64 = (1 << 64) - 1
_reg("BIN", 1, 1, "string",
     lambda a, argv, n: (_vec(lambda x: format(int(x) & _U64, "b"),
                              argv[0][1], n, argv[0][0]), argv[0][1]))
_reg("OCT", 1, 1, "string",
     lambda a, argv, n: (_vec(lambda x: format(int(x) & _U64, "o"),
                              argv[0][1], n, argv[0][0]), argv[0][1]))


def _hex(args, argv, n):
    from tidb_tpu_torch.sqltypes import EvalType
    d, v = argv[0]
    if args[0].ft.eval_type == EvalType.STRING:
        return _vec(
            lambda x: (x if isinstance(x, bytes)
                       else _s(x).encode()).hex().upper(), v, n, d), v
    return _vec(lambda x: format(int(x) & _U64, "X"), v, n, d), v


_reg("HEX", 1, 1, "string", _hex)


def _unhex(args, argv, n):
    d, v = argv[0]

    def one(x):
        try:
            # VARBINARY result (MySQL): always bytes, never a lossy str
            # decode — keeps the column type-homogeneous for sort/compare
            return bytes.fromhex(_s(x))
        except ValueError:
            return None          # odd length / non-hex -> NULL (MySQL)

    out = _vec(one, v, n, d)
    v2 = v & np.array([out[i] is not None for i in range(n)], dtype=bool)
    out = np.where(v2, out, "")
    return out, v2


_reg("UNHEX", 1, 1, "binary", _unhex)


# -- strings (builtin_string.go) ---------------------------------------------

def _sfn(name, min_a, max_a, pyfn, ret="string", **kw):
    def fn(args, argv, n):
        v = _valid_all(argv, n)
        dtype = np.int64 if ret == "int" else object
        out = _vec(pyfn, v, n, *[d for d, _v in argv], dtype=dtype)
        return out, v
    _reg(name, min_a, max_a, ret, fn, **kw)


_sfn("CHAR_LENGTH", 1, 1, lambda x: len(_s(x)), ret="int")
_sfn("CHARACTER_LENGTH", 1, 1, lambda x: len(_s(x)), ret="int")
_sfn("BIT_LENGTH", 1, 1, lambda x: len(_s(x).encode()) * 8, ret="int")
def _pad(left: bool):
    def fn(args, argv, n):
        (xd, xv), (kd, kv), (pd_, pv) = argv
        v = xv & kv & pv
        k = np.asarray(kd, np.int64)
        v = v & (k >= 0)              # negative length is NULL in MySQL

        def one(x, k, p):
            x, p, k = _s(x), _s(p), int(k)
            if len(x) >= k:
                return x[:k]
            if not p:
                return x[:k]
            pad = (p * k)[:k - len(x)]
            return pad + x if left else x + pad

        return _vec(one, v, n, xd, kd, pd_), v
    return fn


_reg("LPAD", 3, 3, "string", _pad(True))
_reg("RPAD", 3, 3, "string", _pad(False))
_sfn("REPEAT", 2, 2, lambda x, k: _s(x) * max(int(k), 0))
_sfn("REVERSE", 1, 1, lambda x: _s(x)[::-1])
_sfn("SPACE", 1, 1, lambda k: " " * max(int(k), 0))
_sfn("STRCMP", 2, 2,
     lambda a, b: (_s(a) > _s(b)) - (_s(a) < _s(b)), ret="int")
_sfn("LOCATE", 2, 3,
     lambda sub, x, pos=1: (_s(x).find(_s(sub), max(int(pos) - 1, 0)) + 1)
     if int(pos) > 0 else 0, ret="int")
_sfn("POSITION", 2, 2,
     lambda sub, x: _s(x).find(_s(sub)) + 1, ret="int")
_sfn("LTRIM", 1, 1, lambda x: _s(x).lstrip(" "))
_sfn("RTRIM", 1, 1, lambda x: _s(x).rstrip(" "))
_sfn("QUOTE", 1, 1,
     lambda x: "'" + _s(x).replace("\\", "\\\\").replace("'", "\\'") + "'")
_sfn("SUBSTRING_INDEX", 3, 3,
     lambda x, d, k: (_s(d).join(_s(x).split(_s(d))[:int(k)])
                      if int(k) >= 0
                      else _s(d).join(_s(x).split(_s(d))[int(k):]))
     if _s(d) else "")
_sfn("FIND_IN_SET", 2, 2,
     lambda x, lst: (_s(lst).split(",").index(_s(x)) + 1
                     if _s(x) in _s(lst).split(",") else 0), ret="int")


def _concat_ws(args, argv, n):
    sep_d, sep_v = argv[0]
    out = np.empty(n, dtype=object)
    v = sep_v.copy()
    for i in range(n):
        if not sep_v[i]:
            out[i] = ""
            continue
        parts = [_s(d[i]) for d, av in argv[1:] if av[i]]
        out[i] = _s(sep_d[i]).join(parts)
    return out, v


_reg("CONCAT_WS", 2, 64, "string", _concat_ws)


def _elt(args, argv, n):
    kd, kv = argv[0]
    out = np.empty(n, dtype=object)
    v = np.zeros(n, dtype=bool)
    for i in range(n):
        out[i] = ""
        if not kv[i]:
            continue
        k = int(kd[i])
        if 1 <= k < len(argv):
            d, av = argv[k]
            if av[i]:
                out[i] = _s(d[i])
                v[i] = True
    return out, v


_reg("ELT", 2, 64, "string", _elt)


def _field(args, argv, n):
    xd, xv = argv[0]
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        if not xv[i]:
            continue
        for k in range(1, len(argv)):
            d, av = argv[k]
            if av[i] and _s(d[i]) == _s(xd[i]):
                out[i] = k
                break
    return out, np.ones(n, dtype=bool)


_reg("FIELD", 2, 64, "int", _field)


# -- greatest/least (builtin_compare.go) -------------------------------------

def _minmax(is_max):
    def fn(args, argv, n):
        from tidb_tpu_torch.sqltypes import EvalType
        v = _valid_all(argv, n)
        if any(a.ft.eval_type == EvalType.STRING for a in args):
            pick = max if is_max else min
            out = _vec(lambda *xs: pick(_s(x) for x in xs), v, n,
                       *[d for d, _ in argv])
            return out, v
        red = np.maximum if is_max else np.minimum
        out = np.asarray(argv[0][0])
        for d, _av in argv[1:]:
            out = red(out, np.asarray(d))
        return out, v
    return fn


def _minmax_ft(args):
    from tidb_tpu_torch.expression.core import ScalarFunc
    f = ScalarFunc.__new__(ScalarFunc)
    f.args = list(args)
    return f._merge_types(args)


_reg("GREATEST", 2, 64, _minmax_ft, _minmax(True))
_reg("LEAST", 2, 64, _minmax_ft, _minmax(False))


# -- date/time (builtin_time.go); all on epoch-micros int64 ------------------

def _days(argv):
    return _micros(argv[0][0]) // _US_PER_DAY


def _ifn(name, min_a, max_a, fn, ret="int", **kw):
    _reg(name, min_a, max_a, ret, fn, **kw)


_ifn("DAYOFWEEK", 1, 1,
     lambda a, argv, n: ((((_days(argv) + 4) % 7) + 1),
                         _valid_all(argv, n)))
_ifn("WEEKDAY", 1, 1,
     lambda a, argv, n: ((_days(argv) + 3) % 7, _valid_all(argv, n)))
_ifn("TO_DAYS", 1, 1,
     lambda a, argv, n: (_days(argv) + 719528, _valid_all(argv, n)))
_ifn("UNIX_TIMESTAMP", 0, 1,
     lambda a, argv, n: (
         (_micros(argv[0][0]) // 1_000_000,
          _valid_all(argv, n)) if argv else
         (np.full(n, int(_dt.datetime.now().timestamp()), np.int64),
          np.ones(n, dtype=bool))),
)
_ifn("MICROSECOND", 1, 1,
     lambda a, argv, n: (_micros(argv[0][0]) % 1_000_000,
                         _valid_all(argv, n)))


def _from_unixtime(args, argv, n):
    d, v = argv[0]
    return np.asarray(d, np.int64) * 1_000_000, v


_reg("FROM_UNIXTIME", 1, 1, "datetime", _from_unixtime)


def _cal_int(extract):
    def fn(args, argv, n):
        v = _valid_all(argv, n)
        dt = _dtarr(np.where(v, argv[0][0], 0))
        return extract(dt).astype(np.int64), v
    return fn


_reg("DAYOFYEAR", 1, 1, "int", _cal_int(
    lambda dt: (dt.astype("datetime64[D]") -
                dt.astype("datetime64[Y]").astype("datetime64[D]")) /
    np.timedelta64(1, "D") + 1))
_reg("QUARTER", 1, 1, "int", _cal_int(
    lambda dt: (dt.astype("datetime64[M]").astype(np.int64) % 12) // 3 + 1))
def _week0(d: _dt.date) -> int:
    """MySQL WEEK mode 0: Sunday-first, 0-53 (days before the year's
    first Sunday are week 0)."""
    jan1 = _dt.date(d.year, 1, 1)
    first_sunday = jan1 + _dt.timedelta((6 - jan1.weekday()) % 7)
    if d < first_sunday:
        return 0
    return (d - first_sunday).days // 7 + 1


def _to_us(x) -> int:
    if isinstance(x, (int, np.integer)):
        return int(x)
    from tidb_tpu_torch.sqltypes import parse_datetime
    return parse_datetime(_s(x))


def _week(args, argv, n):
    v = _valid_all(argv, n)           # NULL date OR NULL mode -> NULL

    def one(us, m=0):
        mode = int(m)
        if mode not in (0, 1, 3):
            from tidb_tpu_torch.executor import ExecError
            raise ExecError(f"unsupported WEEK mode {mode}")
        d = micros_to_datetime(_to_us(us)).date()
        if mode == 0:
            return _week0(d)
        iso_y, iso_w, _ = d.isocalendar()
        if mode == 3:                 # ISO 8601: 1-53
            return iso_w
        # mode 1: Monday-first, 0-53, no rollover across years
        if iso_y < d.year:
            return 0
        if iso_y > d.year:            # Dec tail of the NEXT iso year
            return (d - _dt.timedelta(7)).isocalendar()[1] + 1
        return iso_w

    arrs = [argv[0][0]] + ([argv[1][0]] if len(argv) == 2 else [])
    return _vec(one, v, n, *arrs, dtype=np.int64), v


def _yearweek(args, argv, n):
    v = _valid_all(argv, n)

    def one(us):
        d = micros_to_datetime(_to_us(us)).date()
        w = _week0(d)
        if w == 0:                    # belongs to the prior year's tail
            prev = _dt.date(d.year - 1, 12, 31)
            return (d.year - 1) * 100 + _week0(prev)
        return d.year * 100 + w

    return _vec(one, v, n, argv[0][0], dtype=np.int64), v


_reg("WEEK", 1, 2, "int", _week)
_reg("YEARWEEK", 1, 1, "int", _yearweek)

_MONTHS = ["January", "February", "March", "April", "May", "June", "July",
           "August", "September", "October", "November", "December"]
_DAYS_OF_WEEK = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
                 "Saturday", "Sunday"]


def _monthname(args, argv, n):
    v = _valid_all(argv, n)
    m = _dtarr(np.where(v, argv[0][0], 0)).astype(
        "datetime64[M]").astype(np.int64) % 12
    return np.array([_MONTHS[i] for i in m], dtype=object), v


def _dayname(args, argv, n):
    v = _valid_all(argv, n)
    wd = (_days(argv) + 3) % 7
    return np.array([_DAYS_OF_WEEK[i] for i in wd], dtype=object), v


_reg("MONTHNAME", 1, 1, "string", _monthname)
_reg("DAYNAME", 1, 1, "string", _dayname)


def _last_day(args, argv, n):
    d, v = argv[0]

    def one(us):
        dt = micros_to_datetime(_to_us(us))
        last = calendar.monthrange(dt.year, dt.month)[1]
        return int(_dt.datetime(dt.year, dt.month, last)
                   .replace(tzinfo=_dt.timezone.utc).timestamp() * 1e6)

    return _vec(one, v, n, d, dtype=np.int64), v


_reg("LAST_DAY", 1, 1, "datetime", _last_day)

# MySQL DATE_FORMAT specifier -> strftime (the common subset)
_FMT_MAP = {"%Y": "%Y", "%y": "%y", "%m": "%m", "%c": "%-m", "%d": "%d",
            "%e": "%-d", "%H": "%H", "%k": "%-H", "%h": "%I", "%i": "%M",
            "%s": "%S", "%S": "%S", "%f": "%f", "%p": "%p", "%W": "%A",
            "%a": "%a", "%b": "%b", "%M": "%B", "%j": "%j", "%%": "%%",
            "%T": "%H:%M:%S"}


def _mysql_fmt_to_strftime(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt):
            spec = fmt[i:i + 2]
            out.append(_FMT_MAP.get(spec, spec[1]))
            i += 2
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


def _date_format(args, argv, n):
    (dd, dv), (fd, fv) = argv
    v = dv & fv

    def one(us, fmt):
        py = _mysql_fmt_to_strftime(_s(fmt))
        return micros_to_datetime(_to_us(us)).strftime(
            py.replace("%-", "%"))

    return _vec(one, v, n, dd, fd), v


_reg("DATE_FORMAT", 2, 2, "string", _date_format)


# -- crypto / checksum (builtin_encryption.go) -------------------------------

def _digest(algo):
    def fn(args, argv, n):
        d, v = argv[0]
        return _vec(lambda x: algo(_s(x).encode()).hexdigest(),
                    v, n, d), v
    return fn


_reg("MD5", 1, 1, "string", _digest(hashlib.md5))
_reg("SHA1", 1, 1, "string", _digest(hashlib.sha1))
_reg("SHA", 1, 1, "string", _digest(hashlib.sha1))


def _sha2(args, argv, n):
    (xd, xv), (bd, bv) = argv
    v = xv & bv
    algos = {0: hashlib.sha256, 224: hashlib.sha224, 256: hashlib.sha256,
             384: hashlib.sha384, 512: hashlib.sha512}

    def one(x, bits):
        a = algos.get(int(bits))
        return a(_s(x).encode()).hexdigest() if a else None

    out = _vec(one, v, n, xd, bd)
    v2 = v & np.array([out[i] is not None for i in range(n)], dtype=bool)
    return np.where(v2, out, ""), v2


_reg("SHA2", 2, 2, "string", _sha2)


# -- JSON (ref: types/json/binary.go; expression/builtin_json.go) ------------
# Documents live as canonical compact text; functions parse per row.

import json as _json


class _PathError(ValueError):
    pass


import functools


@functools.lru_cache(maxsize=1024)
def _parse_path(path: str) -> tuple:
    """'$.a.b[0]' -> ['a', 'b', 0]. Subset: member access and array
    index (no wildcards/ranges)."""
    p = path.strip()
    if not p.startswith("$"):
        raise _PathError(f"Invalid JSON path expression: {path!r}")
    out: list = []
    i = 1
    n = len(p)
    while i < n:
        c = p[i]
        if c == ".":
            i += 1
            if i < n and p[i] == '"':
                j = p.find('"', i + 1)
                if j < 0:
                    raise _PathError(f"Invalid JSON path: {path!r}")
                out.append(p[i + 1:j])
                i = j + 1
                continue
            j = i
            while j < n and (p[j].isalnum() or p[j] == "_"):
                j += 1
            if j == i:
                raise _PathError(f"Invalid JSON path: {path!r}")
            out.append(p[i:j])
            i = j
        elif c == "[":
            j = p.find("]", i)
            if j < 0:
                raise _PathError(f"Invalid JSON path: {path!r}")
            idx_s = p[i + 1:j].strip()
            if not idx_s.isdigit():      # no wildcards/negatives/last
                raise _PathError(f"Invalid JSON path: {path!r}")
            out.append(int(idx_s))
            i = j + 1
        else:
            raise _PathError(f"Invalid JSON path: {path!r}")
    return tuple(out)


def _walk(doc, steps):
    """-> (found, value)."""
    cur = doc
    for s in steps:
        if isinstance(s, int):
            if not isinstance(cur, list) or not (0 <= s < len(cur)):
                return False, None
            cur = cur[s]
        else:
            if not isinstance(cur, dict) or s not in cur:
                return False, None
            cur = cur[s]
    return True, cur


def _jload(x):
    return _json.loads(_s(x))


def _jdump(v) -> str:
    return _json.dumps(v, separators=(",", ":"))


def _json_extract(args, argv, n):
    v = _valid_all(argv, n)
    out = np.empty(n, dtype=object)
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        out[i] = ""
        if not v[i]:
            continue
        doc = _jload(argv[0][0][i])
        hits = []
        for pd_, _pv in argv[1:]:
            found, val = _walk(doc, _parse_path(_s(pd_[i])))
            if found:
                hits.append(val)
        if not hits:
            continue            # no match -> NULL (MySQL)
        ok[i] = True
        # one path -> the value; several -> wrapped in an array
        out[i] = _jdump(hits[0] if len(argv) == 2 else hits)
    return out, ok


def _json_ft(args):
    from tidb_tpu_torch.sqltypes import FieldType, TypeCode
    return FieldType(TypeCode.JSON)


def _wrap_path_errors(fn):
    """Malformed path arguments surface as clean SQL errors, never raw
    int()/parse tracebacks."""
    def wrapped(args, argv, n):
        from tidb_tpu_torch.executor import ExecError
        try:
            return fn(args, argv, n)
        except _PathError as e:
            raise ExecError(str(e)) from None
    return wrapped


_reg("JSON_EXTRACT", 2, 16, _json_ft, _wrap_path_errors(_json_extract))


def _json_unquote(args, argv, n):
    d, v = argv[0]

    def one(x):
        s = _s(x)
        if s.startswith('"') and s.endswith('"') and len(s) >= 2:
            try:
                u = _json.loads(s)
                if isinstance(u, str):
                    return u
            except ValueError:
                pass
        return s

    return _vec(one, v, n, d), v


_reg("JSON_UNQUOTE", 1, 1, "string", _json_unquote)


def _json_type(args, argv, n):
    d, v = argv[0]
    names = {dict: "OBJECT", list: "ARRAY", str: "STRING", bool: "BOOLEAN",
             int: "INTEGER", float: "DOUBLE", type(None): "NULL"}
    return _vec(lambda x: names[type(_jload(x))], v, n, d), v


_reg("JSON_TYPE", 1, 1, "string", _json_type)


def _json_valid(args, argv, n):
    d, v = argv[0]

    def one(x):
        try:
            _jload(x)
            return 1
        except ValueError:
            return 0

    return _vec(one, v, n, d, dtype=np.int64), v


_reg("JSON_VALID", 1, 1, "int", _json_valid)


def _json_length(args, argv, n):
    v = _valid_all(argv, n)
    out = np.zeros(n, dtype=np.int64)
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        if not v[i]:
            continue
        doc = _jload(argv[0][0][i])
        if len(argv) == 2:
            found, doc = _walk(doc, _parse_path(_s(argv[1][0][i])))
            if not found:
                continue
        ok[i] = True
        out[i] = len(doc) if isinstance(doc, (dict, list)) else 1
    return out, ok


_reg("JSON_LENGTH", 1, 2, "int", _wrap_path_errors(_json_length))


def _json_keys(args, argv, n):
    d, v = argv[0]
    out = np.empty(n, dtype=object)
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        out[i] = ""
        if not v[i]:
            continue
        doc = _jload(d[i])
        if isinstance(doc, dict):
            out[i] = _jdump(list(doc.keys()))
            ok[i] = True
    return out, ok


_reg("JSON_KEYS", 1, 1, _json_ft, _json_keys)


def _json_contains_value(hay, needle) -> bool:
    """MySQL containment: a candidate array is contained in a target
    array iff EVERY candidate element is contained in some target
    element; a non-array candidate iff SOME element contains it; object
    containment is per-key; scalars compare with numeric coercion."""
    if isinstance(hay, list):
        if isinstance(needle, list):
            return all(_json_contains_value(hay, e) for e in needle)
        return any(_json_contains_value(e, needle) for e in hay)
    if isinstance(hay, dict):
        if isinstance(needle, dict):
            return all(k in hay and _json_contains_value(hay[k], nv)
                       for k, nv in needle.items())
        return False
    if isinstance(needle, (list, dict)):
        return False
    if isinstance(hay, bool) != isinstance(needle, bool):
        return False
    if isinstance(hay, (int, float)) and isinstance(needle, (int, float)):
        return float(hay) == float(needle)
    return hay == needle


def _json_contains(args, argv, n):
    v = _valid_all(argv, n)

    def one(doc, cand, *path):
        d = _jload(doc)
        if path:
            found, d = _walk(d, _parse_path(_s(path[0])))
            if not found:
                return 0
        return 1 if _json_contains_value(d, _jload(cand)) else 0

    return _vec(one, v, n, *[a[0] for a in argv], dtype=np.int64), v


_reg("JSON_CONTAINS", 2, 3, "int",
     _wrap_path_errors(_json_contains))


def _json_array(args, argv, n):
    out = np.empty(n, dtype=object)
    for i in range(n):
        vals = []
        for (d, av), a in zip(argv, args):
            vals.append(_arg_to_json(d[i], av[i], a))
        out[i] = _jdump(vals)
    return out, np.ones(n, dtype=bool)


def _json_object(args, argv, n):
    if len(argv) % 2:
        from tidb_tpu_torch.executor import ExecError
        raise ExecError("JSON_OBJECT needs an even number of arguments")
    out = np.empty(n, dtype=object)
    for i in range(n):
        obj = {}
        for k in range(0, len(argv), 2):
            (kd, kv_), (vd, vv) = argv[k], argv[k + 1]
            if not kv_[i]:
                from tidb_tpu_torch.executor import ExecError
                raise ExecError("JSON_OBJECT key cannot be NULL")
            obj[_s(kd[i])] = _arg_to_json(vd[i], vv[i], args[k + 1])
        out[i] = _jdump(obj)
    return out, np.ones(n, dtype=bool)


def _arg_to_json(x, valid, expr):
    from tidb_tpu_torch.sqltypes import EvalType, TypeCode
    if not valid:
        return None
    if expr.ft.tp == TypeCode.JSON:
        return _jload(x)
    et = expr.ft.eval_type
    if et == EvalType.INT:
        return int(x)
    if et == EvalType.REAL:
        return float(x)
    if et == EvalType.DECIMAL:
        from tidb_tpu_torch.sqltypes import scaled_to_decimal
        return float(scaled_to_decimal(int(x), max(expr.ft.frac, 0)))
    return _s(x)


_reg("JSON_ARRAY", 0, 32, _json_ft, _json_array)
_reg("JSON_OBJECT", 0, 32, _json_ft, _json_object)


# -- pattern matching ---------------------------------------------------------

def _regexp_like(args, argv, n):
    """a REGEXP p (ref: expression/builtin_like.go regexpSig): partial
    match, per-row pattern, case-sensitive (utf8_bin semantics)."""
    import re
    v = _valid_all(argv, n)
    out = np.zeros(n, dtype=np.int64)
    cache = {}
    for i in range(n):
        if not v[i]:
            continue
        p = _s(argv[1][0][i])
        rx = cache.get(p)
        if rx is None:
            try:
                rx = cache[p] = re.compile(p)
            except re.error as ex:
                from tidb_tpu_torch.executor import ExecError
                raise ExecError(
                    f"Got error '{ex}' from regexp") from None
        out[i] = 1 if rx.search(_s(argv[0][0][i])) else 0
    return out, v


_reg("REGEXP_LIKE", 2, 2, "int", _regexp_like)


# -- TIMESTAMPDIFF ------------------------------------------------------------

_TSDIFF_US = {"MICROSECOND": 1, "SECOND": 1_000_000, "MINUTE": 60_000_000,
              "HOUR": 3_600_000_000, "DAY": _US_PER_DAY,
              "WEEK": 7 * _US_PER_DAY}
_TSDIFF_MONTHS = {"MONTH": 1, "QUARTER": 3, "YEAR": 12}


def _timestampdiff(args, argv, n):
    """TIMESTAMPDIFF(unit, a, b): complete units from a to b, truncated
    toward zero (ref: expression/builtin_time.go timestampDiff)."""
    v = _valid_all(argv, n)
    a = _micros(argv[1][0])
    b = _micros(argv[2][0])
    units = argv[0][0]
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        if not v[i]:
            continue
        u = _s(units[i]).upper()
        diff = int(b[i]) - int(a[i])
        if u in _TSDIFF_US:
            per = _TSDIFF_US[u]
            out[i] = abs(diff) // per * (1 if diff >= 0 else -1)
        elif u in _TSDIFF_MONTHS:
            da = micros_to_datetime(int(a[i]))
            db = micros_to_datetime(int(b[i]))
            months = (db.year - da.year) * 12 + (db.month - da.month)
            ta = (da.day, da.hour, da.minute, da.second, da.microsecond)
            tb = (db.day, db.hour, db.minute, db.second, db.microsecond)
            if months > 0 and tb < ta:
                months -= 1      # last month not complete
            elif months < 0 and tb > ta:
                months += 1
            k = _TSDIFF_MONTHS[u]
            out[i] = abs(months) // k * (1 if months >= 0 else -1)
        else:
            from tidb_tpu_torch.executor import ExecError
            raise ExecError(f"unsupported TIMESTAMPDIFF unit {u}")
    return out, v


_reg("TIMESTAMPDIFF", 3, 3, "int", _timestampdiff)


# The long-tail extension families (time/string/info/misc/crypto/JSON)
# register themselves on import; kept in a sibling module so each family
# file stays reviewable (mirrors the reference's builtin_*.go split).
from tidb_tpu_torch.expression import builtins_ext  # noqa: E402,F401
