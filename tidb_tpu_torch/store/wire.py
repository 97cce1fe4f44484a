"""Typed wire codec for the storage RPC boundary.

The port's copy of the JAX package's store/wire.py: the registry holds
the port's classes under the reference's ids, so the same value encodes
to the same bytes in both packages and each decodes the other's frames.

Reference: TiDB's store/tikv/tikvrpc/tikvrpc.go:31-53 (the typed
CmdType envelope) and the vendored kvproto/tipb protobufs that define the
reference's closed cross-process contract. This module is this build's
equivalent of that contract: a self-describing tag-length-value encoding
over a CLOSED registry of struct/enum/error types. Nothing outside the
registry can cross the wire, decoding never executes arbitrary code (no
pickle), and every length/tag/id is validated so malformed frames raise
`WireError` instead of corrupting state (fuzzed in tests/test_wire.py).

Layout (little-endian):
  frame  = u32 payload_len | u8 status | payload
  value  = u8 tag | body
  varint = LEB128, max 10 bytes

Value tags:
  0 NONE   1 TRUE    2 FALSE   3 INT(zigzag varint)   4 FLOAT(8B IEEE)
  5 BYTES  6 STR     7 LIST    8 TUPLE   9 DICT
  10 NDARRAY(u8 dtype, varint n, raw buf)   11 OBJARR(varint n, items)
  12 STRUCT(u16 id, varint nfields, values)
  13 ENUM(u16 id, value)        14 ERROR(u16 id, args tuple, msg str)
  15 FNSPEC(str name)           16 BIGINT(signed big-endian bytes)
  17 DECIMAL(str)

Chunk columns ride as NDARRAY (fixed-width lanes: one raw memcpy-able
buffer, the one `device_put_chunk` stages) or OBJARR (varlen). Only host
numpy buffers cross: a torch tensor (a device-resident lane above all)
is not in the contract and raises WireError, it is never copied to the
host behind the caller's back.
"""

from __future__ import annotations

import struct
from decimal import Decimal
from enum import IntEnum

import numpy as np

__all__ = ["Cmd", "WireError", "encode", "decode",
           "encode_frame", "decode_frame_payload",
           "STATUS_OK", "STATUS_ERR", "STATUS_OK_TRACED",
           "STATUS_STREAM_FRAME", "STATUS_STREAM_END", "STATUS_CREDIT",
           "FLAG_TRACE", "FLAG_ORIGIN",
           "MAX_STREAM_CREDIT", "StreamReader", "CreditGate"]


class WireError(Exception):
    """Malformed or out-of-contract wire data."""


class Cmd(IntEnum):
    """Command enum (ref: tikvrpc.go:31-53 CmdType)."""

    PING = 0
    # transactional KV
    KV_GET = 1
    KV_SCAN = 2
    KV_PREWRITE = 3
    KV_COMMIT = 4
    KV_CLEANUP = 5
    KV_BATCH_GET = 6
    KV_BATCH_ROLLBACK = 7
    KV_SCAN_LOCK = 8
    KV_RESOLVE_LOCK = 9
    KV_GC = 10
    KV_DELETE_RANGE = 11
    # raw KV
    RAW_GET = 20
    RAW_BATCH_GET = 21
    RAW_PUT = 22
    RAW_BATCH_PUT = 23
    RAW_DELETE = 24
    RAW_DELETE_RANGE = 25
    RAW_SCAN = 26
    # coprocessor
    COP = 40
    # streaming coprocessor: multi-frame reply with credit flow control
    # (ref: CmdCopStream, store/tikv/coprocessor.go:547-555)
    COP_STREAM = 41
    # debug / admin
    MVCC_BY_KEY = 50
    MVCC_BY_START_TS = 51
    SPLIT_REGION = 52
    # PD role (TSO + region routing) served by the storage process
    TSO = 60
    REGION_BY_KEY = 61
    REGIONS_SNAPSHOT = 62
    SPLIT = 63
    SPLIT_TABLE = 64
    BULK_IMPORT = 65
    # replication control (primary/backup log shipping)
    REPL_HELLO = 70
    REPL_APPLY = 71
    REPL_SNAPSHOT = 72
    REPL_PROMOTE = 73
    REPL_INSTALL = 74
    # fleet cache coherence: one round trip returns the engine's
    # freshness meta (data_version / max_commit_ts / lock state) plus
    # the delta-journal window (fill_ts, read_ts] for one region range,
    # so a remote SQL server patches its resident chunk/HBM blocks in
    # place instead of re-colding on every remote read (store/delta.py)
    JOURNAL_WINDOW = 80


# method-name <-> Cmd mapping used by the RPC layer (the shim's python
# methods keep their names; the wire carries the enum)
CMD_BY_METHOD = {
    "ping": Cmd.PING,
    "kv_get": Cmd.KV_GET, "kv_scan": Cmd.KV_SCAN,
    "kv_prewrite": Cmd.KV_PREWRITE, "kv_commit": Cmd.KV_COMMIT,
    "kv_cleanup": Cmd.KV_CLEANUP, "kv_batch_get": Cmd.KV_BATCH_GET,
    "kv_batch_rollback": Cmd.KV_BATCH_ROLLBACK,
    "kv_scan_lock": Cmd.KV_SCAN_LOCK,
    "kv_resolve_lock": Cmd.KV_RESOLVE_LOCK, "kv_gc": Cmd.KV_GC,
    "kv_delete_range": Cmd.KV_DELETE_RANGE,
    "raw_get": Cmd.RAW_GET, "raw_batch_get": Cmd.RAW_BATCH_GET,
    "raw_put": Cmd.RAW_PUT, "raw_batch_put": Cmd.RAW_BATCH_PUT,
    "raw_delete": Cmd.RAW_DELETE,
    "raw_delete_range": Cmd.RAW_DELETE_RANGE, "raw_scan": Cmd.RAW_SCAN,
    "coprocessor": Cmd.COP,
    "coprocessor_stream": Cmd.COP_STREAM,
    "mvcc_by_key": Cmd.MVCC_BY_KEY,
    "mvcc_by_start_ts": Cmd.MVCC_BY_START_TS,
    "split_region": Cmd.SPLIT_REGION,
    "tso": Cmd.TSO, "region_by_key": Cmd.REGION_BY_KEY,
    "regions_snapshot": Cmd.REGIONS_SNAPSHOT,
    "split": Cmd.SPLIT, "split_table": Cmd.SPLIT_TABLE,
    "bulk_import": Cmd.BULK_IMPORT,
    "repl_hello": Cmd.REPL_HELLO, "repl_apply": Cmd.REPL_APPLY,
    "repl_snapshot": Cmd.REPL_SNAPSHOT,
    "repl_promote": Cmd.REPL_PROMOTE,
    "repl_install": Cmd.REPL_INSTALL,
    "journal_window": Cmd.JOURNAL_WINDOW,
}
METHOD_BY_CMD = {v: k for k, v in CMD_BY_METHOD.items()}

# -- tags ---------------------------------------------------------------------

_T_NONE, _T_TRUE, _T_FALSE, _T_INT, _T_FLOAT = 0, 1, 2, 3, 4
_T_BYTES, _T_STR, _T_LIST, _T_TUPLE, _T_DICT = 5, 6, 7, 8, 9
_T_NDARRAY, _T_OBJARR, _T_STRUCT, _T_ENUM, _T_ERROR = 10, 11, 12, 13, 14
_T_FNSPEC, _T_BIGINT, _T_DECIMAL = 15, 16, 17

_MAX_DEPTH = 64
_MAX_LEN = 1 << 31

# fixed-width lanes allowed in NDARRAY (codes are wire-stable)
_DTYPES = {0: np.dtype(np.int64), 1: np.dtype(np.float64),
           2: np.dtype(np.int32), 3: np.dtype(np.float32),
           4: np.dtype(np.bool_), 5: np.dtype(np.uint8),
           6: np.dtype(np.uint64)}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}

_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


# -- registries (append-only ids: the wire contract) --------------------------

_STRUCTS: dict[int, tuple] = {}      # id -> (cls, field_names, rebuild)
_STRUCT_IDS: dict[type, int] = {}
_ENUMS: dict[int, type] = {}
_ENUM_IDS: dict[type, int] = {}
_ERRORS: dict[int, type] = {}
_ERROR_IDS: dict[type, int] = {}


def _reg_struct(sid: int, cls, fields=None, rebuild=None):
    if fields is None:
        fields = [f.name for f in cls.__dataclass_fields__.values()] \
            if hasattr(cls, "__dataclass_fields__") else None
    if fields is None:
        raise TypeError(f"{cls} needs explicit fields")
    if rebuild is None:
        def rebuild(vals, cls=cls):
            return cls(*vals)
    _STRUCTS[sid] = (cls, fields, rebuild)
    _STRUCT_IDS[cls] = sid


def _reg_enum(eid: int, cls):
    _ENUMS[eid] = cls
    _ENUM_IDS[cls] = eid


def _reg_error(eid: int, cls):
    _ERRORS[eid] = cls
    _ERROR_IDS[cls] = eid


def _install_registry():
    """One closed list; ids are stable wire contract, append-only."""
    from tidb_tpu_torch import kv
    from tidb_tpu_torch.chunk import Chunk, Column
    from tidb_tpu_torch.expression.agg import AggDesc, AggFunc
    from tidb_tpu_torch.expression.core import (ColumnRef, Constant, Op,
                                                ScalarFunc)
    from tidb_tpu_torch.mockstore.cluster import Region, Store
    from tidb_tpu_torch.mockstore.rpc import RegionCtx, TimeoutError_
    from tidb_tpu_torch.plan.physical import CopPlan
    from tidb_tpu_torch.ranger import DatumRange
    from tidb_tpu_torch.schema.model import (ColumnInfo, DBInfo, IndexInfo,
                                             SchemaState, TableInfo)
    from tidb_tpu_torch.sqltypes import FieldType, TypeCode

    # structs (ids 1..)
    _reg_struct(1, kv.KVRange)
    _reg_struct(2, kv.Mutation)
    _reg_struct(3, kv.LockInfo)
    _reg_struct(4, kv.CopRequest)
    _reg_struct(5, kv.CopResponse)
    _reg_struct(6, RegionCtx,
                fields=["region_id", "version", "conf_ver", "store_id"])
    _reg_struct(7, Region)
    _reg_struct(8, Store)
    _reg_struct(9, CopPlan)
    _reg_struct(10, TableInfo)
    _reg_struct(11, ColumnInfo)
    _reg_struct(12, IndexInfo)
    _reg_struct(13, DBInfo)
    _reg_struct(14, FieldType)
    _reg_struct(15, AggDesc)
    _reg_struct(16, ColumnRef)
    _reg_struct(17, Constant)
    _reg_struct(18, DatumRange)

    def _rebuild_scalarfunc(vals):
        op, args, extra, ft = vals
        f = ScalarFunc.__new__(ScalarFunc)
        f.op, f.args, f.extra, f.ft = op, list(args), extra, ft
        return f

    _reg_struct(19, ScalarFunc, fields=["op", "args", "extra", "ft"],
                rebuild=_rebuild_scalarfunc)

    def _rebuild_column(vals):
        ft, data, valid = vals
        return Column(ft, data, valid)

    _reg_struct(20, Column, fields=["ft", "data", "valid"],
                rebuild=_rebuild_column)
    _reg_struct(21, Chunk, fields=["columns"],
                rebuild=lambda vals: Chunk(vals[0]))

    from tidb_tpu_torch.ops.hashagg import GroupResult
    _reg_struct(22, GroupResult)

    from tidb_tpu_torch.store.stream import StreamFrame
    _reg_struct(25, StreamFrame, fields=["chunk", "range", "last"])

    # MVCC engine internals: cross the wire only in REPL_SNAPSHOT state
    # transfer (primary -> attaching backup)
    from tidb_tpu_torch.mockstore.mvcc import WriteType, _Entry, _Lock
    _reg_struct(23, _Lock)
    _reg_struct(24, _Entry)
    _reg_enum(9, WriteType)

    # enums (ids 1..)
    _reg_enum(1, kv.MutationOp)
    _reg_enum(2, kv.ReqType)
    _reg_enum(3, kv.Priority)
    _reg_enum(4, kv.IsolationLevel)
    _reg_enum(5, Op)
    _reg_enum(6, AggFunc)
    _reg_enum(7, TypeCode)
    _reg_enum(8, SchemaState)

    # errors (ids 1..); ctor args come from each class's __reduce__
    _reg_error(1, kv.KVError)
    _reg_error(2, kv.NotFoundError)
    _reg_error(3, kv.RetryableError)
    _reg_error(4, kv.GCTooEarlyError)
    _reg_error(5, kv.SchemaChangedError)
    _reg_error(6, kv.KeyLockedError)
    _reg_error(7, kv.WriteConflictError)
    _reg_error(8, kv.RegionError)
    _reg_error(9, kv.NotLeaderError)
    _reg_error(10, kv.EpochNotMatchError)
    _reg_error(11, kv.StoreUnavailableError)
    _reg_error(12, kv.ServerBusyError)
    _reg_error(13, TimeoutError_)
    _reg_error(14, kv.StreamInterruptedError)


_installed = False


def _ensure_registry():
    global _installed
    if not _installed:
        _install_registry()
        _installed = True


# -- encoding -----------------------------------------------------------------

def _put_varint(out: bytearray, n: int) -> None:
    if n < 0:
        raise WireError("negative length")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n >= 0 else ((-n) << 1) - 1


def _unzigzag(n: int) -> int:
    return (n >> 1) if not (n & 1) else -((n + 1) >> 1)


def _enc(out: bytearray, v, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise WireError("nesting too deep")
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, np.bool_):
        out.append(_T_TRUE if v else _T_FALSE)
    elif isinstance(v, (int, np.integer)) and not isinstance(v, IntEnum):
        v = int(v)
        if _INT64_MIN <= v <= _INT64_MAX:
            out.append(_T_INT)
            _put_varint(out, _zigzag(v))
        else:
            out.append(_T_BIGINT)
            nb = (v.bit_length() + 8) // 8
            b = v.to_bytes(nb, "big", signed=True)
            _put_varint(out, len(b))
            out += b
    elif isinstance(v, (float, np.floating)):
        out.append(_T_FLOAT)
        out += struct.pack("<d", float(v))
    elif isinstance(v, bytes):
        out.append(_T_BYTES)
        _put_varint(out, len(v))
        out += v
    elif isinstance(v, str):
        b = v.encode("utf8")
        out.append(_T_STR)
        _put_varint(out, len(b))
        out += b
    elif isinstance(v, Decimal):
        b = str(v).encode("ascii")
        out.append(_T_DECIMAL)
        _put_varint(out, len(b))
        out += b
    elif isinstance(v, np.ndarray):
        if v.dtype == np.dtype(object):
            out.append(_T_OBJARR)
            _put_varint(out, len(v))
            for x in v:
                _enc(out, x, depth + 1)
        else:
            code = _DTYPE_CODES.get(v.dtype)
            if code is None:
                raise WireError(f"dtype {v.dtype} not in wire contract")
            if v.ndim != 1:
                v = np.ascontiguousarray(v).reshape(-1)
            out.append(_T_NDARRAY)
            out.append(code)
            _put_varint(out, len(v))
            out += np.ascontiguousarray(v).tobytes()
    elif isinstance(v, list):
        out.append(_T_LIST)
        _put_varint(out, len(v))
        for x in v:
            _enc(out, x, depth + 1)
    elif isinstance(v, tuple):
        out.append(_T_TUPLE)
        _put_varint(out, len(v))
        for x in v:
            _enc(out, x, depth + 1)
    elif isinstance(v, dict):
        out.append(_T_DICT)
        _put_varint(out, len(v))
        for k, x in v.items():
            _enc(out, k, depth + 1)
            _enc(out, x, depth + 1)
    elif isinstance(v, BaseException):
        _ensure_registry()
        eid = _ERROR_IDS.get(type(v))
        if eid is None:
            # out-of-registry exception: degrade to KVError with repr —
            # never ship arbitrary reconstruction info
            from tidb_tpu_torch import kv
            eid = _ERROR_IDS[kv.KVError]
            args = (f"{type(v).__name__}: {v}",)
        else:
            red = v.__reduce__()
            args = red[1] if isinstance(red, tuple) and len(red) >= 2 \
                else (str(v),)
        out.append(_T_ERROR)
        out += struct.pack("<H", eid)
        _enc(out, tuple(args), depth + 1)
    else:
        _ensure_registry()
        cls = type(v)
        if cls in _ENUM_IDS:
            out.append(_T_ENUM)
            out += struct.pack("<H", _ENUM_IDS[cls])
            _enc(out, v.value, depth + 1)
            return
        sid = _STRUCT_IDS.get(cls)
        if sid is not None:
            _cls, fields, _rb = _STRUCTS[sid]
            out.append(_T_STRUCT)
            out += struct.pack("<H", sid)
            _put_varint(out, len(fields))
            for f in fields:
                _enc(out, getattr(v, f), depth + 1)
            return
        if cls.__module__.startswith("torch"):
            raise WireError(
                f"torch {cls.__name__} on {getattr(v, 'device', '?')} is "
                "not in wire contract: ship host numpy lanes")
        # FnSpec crosses by name (host_filter pushdown)
        from tidb_tpu_torch.expression.builtins import FnSpec
        if isinstance(v, FnSpec):
            b = v.name.encode("utf8")
            out.append(_T_FNSPEC)
            _put_varint(out, len(b))
            out += b
            return
        raise WireError(
            f"type {cls.__module__}.{cls.__name__} not in wire contract")


def encode(v) -> bytes:
    out = bytearray()
    _enc(out, v, 0)
    return bytes(out)


# -- decoding -----------------------------------------------------------------

class _Reader:
    __slots__ = ("buf", "pos", "n")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.n = len(buf)

    def take(self, k: int) -> bytes:
        if k < 0 or self.pos + k > self.n:
            raise WireError("truncated frame")
        b = self.buf[self.pos:self.pos + k]
        self.pos += k
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            if shift > 63:
                raise WireError("varint too long")
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7


def _dec(r: _Reader, depth: int):
    if depth > _MAX_DEPTH:
        raise WireError("nesting too deep")
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return _unzigzag(r.varint())
    if tag == _T_FLOAT:
        return struct.unpack("<d", r.take(8))[0]
    if tag == _T_BYTES:
        return r.take(r.varint())
    if tag == _T_STR:
        try:
            return r.take(r.varint()).decode("utf8")
        except UnicodeDecodeError as e:
            raise WireError(f"bad utf8: {e}") from None
    if tag == _T_DECIMAL:
        try:
            return Decimal(r.take(r.varint()).decode("ascii"))
        except Exception as e:
            raise WireError(f"bad decimal: {e}") from None
    if tag == _T_BIGINT:
        return int.from_bytes(r.take(r.varint()), "big", signed=True)
    if tag in (_T_LIST, _T_TUPLE):
        k = r.varint()
        if k > r.n - r.pos:      # each element is >= 1 byte
            raise WireError("length exceeds frame")
        items = [_dec(r, depth + 1) for _ in range(k)]
        return items if tag == _T_LIST else tuple(items)
    if tag == _T_DICT:
        k = r.varint()
        if k * 2 > r.n - r.pos:
            raise WireError("length exceeds frame")
        out = {}
        for _ in range(k):
            key = _dec(r, depth + 1)
            try:
                out[key] = _dec(r, depth + 1)
            except TypeError as e:
                raise WireError(f"unhashable dict key: {e}") from None
        return out
    if tag == _T_NDARRAY:
        code = r.u8()
        dt = _DTYPES.get(code)
        if dt is None:
            raise WireError(f"unknown dtype code {code}")
        k = r.varint()
        nbytes = k * dt.itemsize
        if nbytes > r.n - r.pos:
            raise WireError("array exceeds frame")
        return np.frombuffer(r.take(nbytes), dtype=dt).copy()
    if tag == _T_OBJARR:
        k = r.varint()
        if k > r.n - r.pos:
            raise WireError("length exceeds frame")
        out = np.empty(k, dtype=object)
        for i in range(k):
            out[i] = _dec(r, depth + 1)
        return out
    if tag == _T_STRUCT:
        _ensure_registry()
        sid = r.u16()
        ent = _STRUCTS.get(sid)
        if ent is None:
            raise WireError(f"unknown struct id {sid}")
        cls, fields, rebuild = ent
        k = r.varint()
        if k != len(fields):
            raise WireError(
                f"struct {cls.__name__}: {k} fields, want {len(fields)}")
        vals = [_dec(r, depth + 1) for _ in range(k)]
        try:
            return rebuild(vals)
        except WireError:
            raise
        except Exception as e:
            raise WireError(
                f"struct {cls.__name__} rebuild failed: {e}") from None
    if tag == _T_ENUM:
        _ensure_registry()
        eid = r.u16()
        cls = _ENUMS.get(eid)
        if cls is None:
            raise WireError(f"unknown enum id {eid}")
        try:
            return cls(_dec(r, depth + 1))
        except ValueError as e:
            raise WireError(str(e)) from None
    if tag == _T_ERROR:
        _ensure_registry()
        eid = r.u16()
        cls = _ERRORS.get(eid)
        if cls is None:
            raise WireError(f"unknown error id {eid}")
        args = _dec(r, depth + 1)
        if not isinstance(args, tuple):
            raise WireError("error args must be a tuple")
        try:
            return cls(*args)
        except Exception as e:
            raise WireError(
                f"error {cls.__name__} rebuild failed: {e}") from None
    if tag == _T_FNSPEC:
        try:
            name = r.take(r.varint()).decode("utf8")
        except UnicodeDecodeError as e:
            raise WireError(f"bad utf8: {e}") from None
        from tidb_tpu_torch.expression.builtins import REGISTRY
        spec = REGISTRY.get(name)
        if spec is None:
            raise WireError(f"unknown builtin {name!r}")
        return spec
    raise WireError(f"unknown tag {tag}")


def decode(buf: bytes):
    r = _Reader(buf)
    v = _dec(r, 0)
    if r.pos != r.n:
        raise WireError(f"{r.n - r.pos} trailing bytes")
    return v


# -- frame helpers ------------------------------------------------------------

def encode_frame(status: int, payload: bytes) -> bytes:
    if len(payload) + 1 > _MAX_LEN:
        raise WireError("frame too large")
    return struct.pack("<IB", len(payload) + 1, status) + payload


def decode_frame_payload(buf: bytes):
    """Decode a received payload, turning any codec error into WireError."""
    try:
        return decode(buf)
    except WireError:
        raise
    except Exception as e:   # noqa: BLE001 — decoder must never crash caller
        raise WireError(f"malformed frame: {e}") from None


# -- streamed replies (COP_STREAM) --------------------------------------------
#
# A COP_STREAM request opens a stream on the connection: the server
# answers with zero or more STATUS_STREAM_FRAME frames (each payload a
# StreamFrame, struct id 25), terminated by STATUS_STREAM_END (normal) or
# STATUS_ERR (typed error; the stream is over, the connection is back in
# request/response state). Flow control is credit-based: the request
# carries an initial window of N frames; the server decrements per frame
# sent and BLOCKS at zero until the client ships a STATUS_CREDIT frame
# (payload: int grant) — a slow consumer backpressures the server instead
# of growing a buffer on either side. Both directions are validated by
# the state machines below; any protocol violation (frame after END,
# more frames outstanding than granted, a non-stream status mid-stream,
# a malformed grant) raises WireError LOUDLY — never deadlocks, never
# desynchronizes silently. Ref: the grpc server-streaming contract of
# CmdCopStream (store/tikv/coprocessor.go:547-555) + tikvrpc.go.

STATUS_OK = 0
STATUS_ERR = 1
STATUS_OK_TRACED = 2   # payload = (result, span-tree dict)
STATUS_STREAM_FRAME = 3
STATUS_STREAM_END = 4
STATUS_CREDIT = 5

# request-flags vocabulary (the optional 4th element of the request
# envelope — cross-process metadata, never command arguments):
#   FLAG_TRACE:  bool — the caller is traced; run the handler under a
#       local "storage:<method>" root and ship the finished tree back
#       (STATUS_OK_TRACED / the stream END frame).
#   FLAG_ORIGIN: dict — trace.origin() of the calling STATEMENT:
#       {"trace_id": fleet-unique id, "sampled": bool, "forced": bool,
#        "member": originating member id}. The server maps sampled/
#       forced onto its local root and stamps anything it retains with
#       origin_trace_id/origin_member, so store-plane ring records
#       join back to the SQL statement that caused them.
FLAG_TRACE = "trace"
FLAG_ORIGIN = "origin"

MAX_STREAM_CREDIT = 1024


class StreamReader:
    """Client-side validation of one streamed reply.

    feed(status, payload) -> ("frame", StreamFrame) | ("end", None);
    typed server errors re-raise in the caller. Tracks the credit ledger:
    the server exceeding the granted window is a protocol violation
    (it proves the peer ignores backpressure) and fails loudly."""

    def __init__(self, credit: int):
        if not (1 <= credit <= MAX_STREAM_CREDIT):
            raise WireError(f"bad credit window {credit!r}")
        self.granted = credit
        self.consumed = 0
        self.done = False

    def grant(self, n: int = 1) -> None:
        self.granted += n

    def feed(self, status: int, payload: bytes):
        if self.done:
            raise WireError("frame after stream end")
        if status == STATUS_STREAM_END:
            self.done = True
            # END may carry the server's span tree (trace propagation)
            return ("end", decode_frame_payload(payload)
                    if payload else None)
        if status == STATUS_ERR:
            self.done = True
            err = decode_frame_payload(payload)
            if isinstance(err, BaseException):
                raise err
            raise WireError(f"stream error: {err!r}")
        if status != STATUS_STREAM_FRAME:
            # e.g. a STATUS_OK of an interleaved plain reply: streams own
            # the connection until END — anything else is corruption
            raise WireError(f"unexpected status {status} mid-stream")
        self.consumed += 1
        if self.consumed > self.granted:
            raise WireError(
                f"credit violation: {self.consumed} frames received, "
                f"{self.granted} granted")
        frame = decode_frame_payload(payload)
        from tidb_tpu_torch import kv as _kv
        from tidb_tpu_torch.store.stream import StreamFrame
        if not isinstance(frame, StreamFrame):
            raise WireError(
                f"stream frame payload is {type(frame).__name__}, "
                "want StreamFrame")
        # field-shape validation: consumers dereference range.start/.end
        # and branch on last — corruption must fail HERE as WireError,
        # not as an AttributeError deep in the resume logic
        if not (isinstance(frame.range, _kv.KVRange) and
                isinstance(frame.range.start, bytes) and
                isinstance(frame.range.end, bytes) and
                isinstance(frame.last, bool)):
            raise WireError("malformed StreamFrame fields")
        return ("frame", frame)


class CreditGate:
    """Server-side credit ledger: consume() per frame sent; when the
    window is exhausted the serving loop blocks reading grant frames and
    feeds them through feed_grant(), which validates them."""

    def __init__(self, credit: int):
        if not (isinstance(credit, int) and not isinstance(credit, bool)
                and 1 <= credit <= MAX_STREAM_CREDIT):
            raise WireError(f"bad credit window {credit!r}")
        self.credit = credit
        self.sent = 0        # frames shipped
        self.received = 0    # grant units absorbed

    def consume(self) -> None:
        if self.credit <= 0:
            raise WireError("sent frame without credit")
        self.credit -= 1
        self.sent += 1

    def feed_grant(self, status: int, payload: bytes) -> None:
        if status != STATUS_CREDIT:
            raise WireError(f"expected credit grant, got status {status}")
        n = decode_frame_payload(payload)
        if not (isinstance(n, int) and not isinstance(n, bool)
                and 1 <= n <= MAX_STREAM_CREDIT):
            raise WireError(f"bad credit grant {n!r}")
        self.credit += n
        self.received += n

    @property
    def outstanding(self) -> int:
        """Grant units still in flight from a well-behaved peer that
        grants one unit per consumed frame: after a clean stream end the
        server must absorb exactly this many before the connection is
        back in request/response framing."""
        return self.sent - self.received
