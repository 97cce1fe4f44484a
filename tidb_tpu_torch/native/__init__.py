"""Native (C++) row decoder and LOAD DATA scanner, loaded via ctypes with
graceful fallback.

The port's copy of the JAX package's native/__init__.py: codec.cc (the
row decoder) and loadscan.cc (the LOAD DATA field scanner,
`scan_rows_native`). Each shared library is compiled on first use with
the system g++ into tidb_tpu_torch/_build/ (keyed by source mtime);
without a compiler the callers run the pure-Python decoder and scanner
(executor/loaddata.py counts that fallback). Beside the reference's
int, float, decimal and handle kinds, the port's codec.cc decodes byte
strings (NATIVE_KIND_BYTES) into an arena that `decode_rows_native`
turns into the same str values the Python decoder gives.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["lib", "decode_rows_native", "scan_rows_native",
           "NATIVE_KIND_INT",
           "NATIVE_KIND_FLOAT", "NATIVE_KIND_DECIMAL", "NATIVE_KIND_HANDLE",
           "NATIVE_KIND_BYTES"]

NATIVE_KIND_INT = 0
NATIVE_KIND_FLOAT = 1
NATIVE_KIND_DECIMAL = 2
NATIVE_KIND_HANDLE = 3
NATIVE_KIND_BYTES = 4

_lock = threading.Lock()
_lib = None
_tried = False

_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def _compile(name: str) -> ctypes.CDLL | None:
    """Build native/<name>.cc into tidb_tpu_torch/_build/<name>.so
    (mtime-cached) and load it; None when no compiler / load failure."""
    src = Path(__file__).parent / f"{name}.cc"
    so = _BUILD_DIR / f"{name}.so"
    try:
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            _BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_suffix(".so.tmp%d" % os.getpid())
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                 "-o", str(tmp), str(src)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        return ctypes.CDLL(str(so))
    except Exception:  # noqa: BLE001 - no compiler / load failure
        return None


def _build() -> ctypes.CDLL | None:
    cdll = _compile("codec")
    if cdll is None:
        return None
    cdll.decode_rows.restype = ctypes.c_int
    cdll.decode_rows.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
    ]
    return cdll


def _build_loadscan() -> ctypes.CDLL | None:
    cdll = _compile("loadscan")
    if cdll is None:
        return None
    cdll.scan_rows.restype = ctypes.c_int64
    P64 = ctypes.POINTER(ctypes.c_int64)
    P8 = ctypes.POINTER(ctypes.c_uint8)
    cdll.scan_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32,
        P64, P64, P8, P64, ctypes.c_int64, ctypes.c_int64, P64, P64,
    ]
    return cdll


_scan_lock = threading.Lock()
_scan_lib = None
_scan_tried = False


def _loadscan_lib() -> ctypes.CDLL | None:
    global _scan_lib, _scan_tried
    if _scan_tried:
        return _scan_lib
    with _scan_lock:
        if not _scan_tried:
            _scan_lib = _build_loadscan()
            _scan_tried = True
    return _scan_lib


def scan_rows_native(data: bytes, ft: bytes, lt: bytes, enc: bytes,
                     esc: bytes, ignore_lines: int,
                     final_chunk: bool = True):
    """Scan LOAD DATA text into field spans.

    -> (consumed_bytes, rowoff int64[nr+1], fstart, fend, fflags) or
    None when the native scanner is unavailable. consumed < len(data)
    means the caller must run the general scanner on the remainder."""
    cdll = _loadscan_lib()
    if cdll is None:
        return None
    n = len(data)
    # upper bounds: every separator byte could open a field/row
    max_fields = data.count(ft) + data.count(lt) + 2
    max_rows = data.count(lt) + 2
    fstart = np.empty(max_fields, dtype=np.int64)
    fend = np.empty(max_fields, dtype=np.int64)
    fflags = np.empty(max_fields, dtype=np.uint8)
    rowoff = np.zeros(max_rows + 1, dtype=np.int64)
    out = np.zeros(2, dtype=np.int64)
    P64 = ctypes.POINTER(ctypes.c_int64)
    P8 = ctypes.POINTER(ctypes.c_uint8)
    consumed = cdll.scan_rows(
        data, n, ft[0], lt[0],
        enc[0] if enc else -1, esc[0] if esc else -1,
        ignore_lines, 1 if final_chunk else 0,
        fstart.ctypes.data_as(P64), fend.ctypes.data_as(P64),
        fflags.ctypes.data_as(P8), rowoff.ctypes.data_as(P64),
        max_fields, max_rows,
        out[0:].ctypes.data_as(P64), out[1:].ctypes.data_as(P64))
    nr, nf = int(out[0]), int(out[1])
    return (int(consumed), rowoff[:nr + 1], fstart[:nf], fend[:nf],
            fflags[:nf])


def lib() -> ctypes.CDLL | None:
    """The native library, or None when unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            _lib = _build()
            _tried = True
    return _lib


def _utf8_or_bytes(b: bytes):
    """The Python decoder's string policy (table.decode_datum_for_col):
    str when the bytes are valid utf-8, else the bytes."""
    try:
        return b.decode("utf8")
    except UnicodeDecodeError:
        return b


def _strings(ends: np.ndarray, valid: np.ndarray, arena: np.ndarray):
    """Per-row end offsets into an arena -> object array of str values
    (bytes where not utf-8), '' in NULL rows. Rows of one width up to 8
    bytes (CHAR(1) flags, short codes) decode through np.unique over the
    packed bytes; the rest row by row with a memo."""
    n = len(ends)
    out = np.empty(n, dtype=object)
    if n == 0:
        return out
    starts = np.empty(n, dtype=np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1]
    lens = ends - starts
    width = int(lens[0])
    if valid.all() and 0 < width <= 8 and int(lens.min()) == width and \
            int(lens.max()) == width:
        packed = np.zeros((n, 8), dtype=np.uint8)
        packed[:, :width] = arena[:n * width].reshape(n, width)
        uniq, inv = np.unique(packed.view(np.uint64).reshape(n),
                              return_inverse=True)
        vals = np.empty(len(uniq), dtype=object)
        vals[:] = [_utf8_or_bytes(u.tobytes()[:width])
                   for u in uniq.view(np.uint8).reshape(-1, 8)]
        out[:] = vals[inv.reshape(n)]
        return out
    raw = arena.tobytes()
    memo: dict = {}
    for i, (s, e, ok) in enumerate(zip(starts.tolist(), ends.tolist(),
                                       valid.tolist())):
        if not ok:
            out[i] = ""
            continue
        b = raw[s:e]
        v = memo.get(b)
        if v is None:
            v = memo[b] = _utf8_or_bytes(b)
        out[i] = v
    return out


def decode_rows_native(kvrows, col_specs):
    """Batch-decode record (key, value) pairs into columnar arrays.

    col_specs: list of (col_id, kind, frac, default_valid, default_value)
    — kind NATIVE_KIND_*; for HANDLE the id/default are ignored.
    Returns (datas, valids) lists of numpy arrays (object arrays of str
    for NATIVE_KIND_BYTES), or None when the native path is unavailable
    or declined the input (caller uses the Python decoder).
    """
    cdll = lib()
    if cdll is None:
        return None
    n = len(kvrows)
    keys = b"".join(k for k, _v in kvrows)
    values = b"".join(v for _k, v in kvrows)
    key_offs = np.zeros(n + 1, dtype=np.int64)
    val_offs = np.zeros(n + 1, dtype=np.int64)
    if n:
        np.cumsum(np.fromiter((len(k) for k, _v in kvrows), np.int64, n),
                  out=key_offs[1:])
        np.cumsum(np.fromiter((len(v) for _k, v in kvrows), np.int64, n),
                  out=val_offs[1:])

    ncols = len(col_specs)
    col_ids = np.array([s[0] for s in col_specs], dtype=np.int64)
    col_kind = np.array([s[1] for s in col_specs], dtype=np.uint8)
    col_frac = np.array([max(0, s[2]) for s in col_specs], dtype=np.int32)
    def_valid = np.array([1 if s[3] else 0 for s in col_specs],
                         dtype=np.uint8)
    def_int = np.zeros(ncols, dtype=np.int64)
    def_float = np.zeros(ncols, dtype=np.float64)
    for i, s in enumerate(col_specs):
        if s[3] and s[4] is not None:
            if s[1] == NATIVE_KIND_BYTES:
                return None       # a string default: the python path
            if s[1] == NATIVE_KIND_FLOAT:
                def_float[i] = float(s[4])
            else:
                def_int[i] = int(s[4])
        elif s[3] and s[4] is None:
            def_valid[i] = 0   # default is NULL

    datas = []
    valids = []
    arenas = []
    out_ptrs = (ctypes.c_void_p * ncols)()
    valid_ptrs = (ctypes.c_void_p * ncols)()
    arena_ptrs = (ctypes.c_void_p * ncols)()
    for i, s in enumerate(col_specs):
        dt = np.float64 if s[1] == NATIVE_KIND_FLOAT else np.int64
        d = np.zeros(n, dtype=dt)
        m = np.zeros(n, dtype=np.uint8)
        a = np.zeros(len(values) if s[1] == NATIVE_KIND_BYTES else 0,
                     dtype=np.uint8)
        datas.append(d)
        valids.append(m)
        arenas.append(a)
        out_ptrs[i] = d.ctypes.data_as(ctypes.c_void_p)
        valid_ptrs[i] = m.ctypes.data_as(ctypes.c_void_p)
        arena_ptrs[i] = a.ctypes.data_as(ctypes.c_void_p)

    rc = cdll.decode_rows(
        values, val_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        keys, key_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, ncols,
        col_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_kind.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        col_frac.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        def_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        def_int.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        def_float.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_ptrs, valid_ptrs, arena_ptrs)
    if rc != 0:
        return None
    out_valid = [m.astype(bool) for m in valids]
    for i, s in enumerate(col_specs):
        if s[1] == NATIVE_KIND_BYTES:
            datas[i] = _strings(datas[i], out_valid[i], arenas[i])
    return datas, out_valid
