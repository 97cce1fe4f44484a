"""Vectorized offline bulk load: columnar arrays -> committed KV pairs.

Reference: TiDB's util/kvencoder (standalone KV-pair encoder for
offline import) and the SQL LOAD path's row encoding (tablecodec.go
EncodeRow). The per-row Python encoder (tablecodec.encode_row) manages
~100k rows/s; loading a TPC-H scale factor through it would dominate any
benchmark run. Here the whole memcomparable row encoding is computed as
numpy byte-matrix math — flag bytes, sign-flipped big-endian ints, IEEE754
float tricks, group-stuffed strings — then sliced into per-row bytes and
ingested through MVCCStore.bulk_import at one commit timestamp.

The byte format is exactly tidb_tpu_torch.codec's (tested round-trip against the
scalar encoder); any divergence would corrupt the store, so tests compare
against tablecodec.encode_row on every column kind.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch import codec, kv, tablecodec
from tidb_tpu_torch.sqltypes import EvalType

__all__ = ["bulk_load", "encode_record_keys", "encode_rows_columnar"]

_SIGN = np.uint64(1 << 63)


def _be_bytes(u64: np.ndarray) -> np.ndarray:
    """uint64 array -> (n, 8) big-endian byte matrix."""
    return u64.astype(">u8").view(np.uint8).reshape(-1, 8)


def _int_payload(data: np.ndarray) -> np.ndarray:
    return _be_bytes(data.astype(np.int64).view(np.uint64) ^ _SIGN)


def _float_payload(data: np.ndarray) -> np.ndarray:
    d = data.astype(np.float64)
    u = d.view(np.uint64)
    # value test (not sign-bit) so -0.0 encodes as +0.0 (codec.encode_float)
    u = np.where(d >= 0, u | _SIGN, ~u)
    return _be_bytes(u)


def encode_record_keys(table_id: int, handles: np.ndarray) -> list[bytes]:
    """Vectorized tablecodec.record_key for every handle."""
    prefix = np.frombuffer(tablecodec.record_prefix(table_id), np.uint8)
    n = len(handles)
    mat = np.empty((n, len(prefix) + 8), dtype=np.uint8)
    mat[:, :len(prefix)] = prefix
    mat[:, len(prefix):] = _int_payload(np.asarray(handles))
    blob = mat.tobytes()
    w = mat.shape[1]
    return [blob[i * w:(i + 1) * w] for i in range(n)]


def _string_encodings(values) -> list[bytes]:
    """codec-encoded bytes (flag included) per distinct value."""
    out = []
    for v in values:
        s = v.encode("utf8") if isinstance(v, str) else bytes(v)
        out.append(bytes([codec.BYTES_FLAG]) + codec.encode_bytes(s))
    return out


class _ColPlan:
    """Per-column encode plan: widths per row + a scatter function."""

    def __init__(self, col, data, valid):
        self.col = col
        self.valid = valid
        n = len(valid)
        et = col.ft.eval_type
        self.str_encs = None
        self.codes = None
        if et == EvalType.STRING:
            # dictionary pass: distinct values encoded once, rows scatter
            # by code (BYTES encoding width varies with value length)
            arr = np.asarray(data, dtype=object)
            safe = np.where(valid, arr, "")
            uniq, codes = np.unique(safe.astype(str), return_inverse=True)
            self.str_encs = _string_encodings(uniq)
            self.codes = codes
            enc_lens = np.array([len(e) for e in self.str_encs],
                                dtype=np.int64)
            self.widths = np.where(valid, enc_lens[codes], 1)
        elif et == EvalType.DECIMAL:
            self.data = np.asarray(data, dtype=np.int64)  # scaled ints
            self.widths = np.where(valid, 10, 1)
        elif et == EvalType.REAL:
            self.data = np.asarray(data, dtype=np.float64)
            self.widths = np.where(valid, 9, 1)
        else:  # INT / DATETIME (epoch micros) / anything int64-shaped
            self.data = np.asarray(data, dtype=np.int64)
            self.widths = np.where(valid, 9, 1)
        assert len(self.widths) == n

    def scatter(self, out: np.ndarray, starts: np.ndarray) -> None:
        """Write this column's datums at byte offsets `starts`."""
        valid = self.valid
        nulls = np.flatnonzero(~valid)
        out[starts[nulls]] = codec.NIL_FLAG
        live = np.flatnonzero(valid)
        if not len(live):
            return
        pos = starts[live]
        et = self.col.ft.eval_type
        if et == EvalType.STRING:
            codes_live = self.codes[live]
            for code, enc in enumerate(self.str_encs):
                rows = pos[codes_live == code]
                if not len(rows):
                    continue
                mat = np.frombuffer(enc, np.uint8)
                out[rows[:, None] + np.arange(len(enc))] = mat
            return
        if et == EvalType.DECIMAL:
            out[pos] = codec.DECIMAL_FLAG
            out[pos + 1] = self.col.ft.frac
            out[(pos + 2)[:, None] + np.arange(8)] = \
                _int_payload(self.data[live])
            return
        if et == EvalType.REAL:
            out[pos] = codec.FLOAT_FLAG
            out[(pos + 1)[:, None] + np.arange(8)] = \
                _float_payload(self.data[live])
            return
        out[pos] = codec.INT_FLAG
        out[(pos + 1)[:, None] + np.arange(8)] = \
            _int_payload(self.data[live])


def encode_rows_columnar(cols, plans) -> list[bytes]:
    """-> per-row encoded value bytes. cols: ColumnInfo list (id order);
    plans: matching _ColPlan list."""
    n = len(plans[0].valid) if plans else 0
    cid_w = 9  # encode_datum(col_id): INT flag + 8 bytes
    # per-row total width and per-column start offsets
    row_w = np.zeros(n, dtype=np.int64)
    col_starts = []
    for p in plans:
        col_starts.append(row_w + cid_w)         # after this col's id datum
        row_w = row_w + cid_w + p.widths
    row_starts = np.concatenate(([0], np.cumsum(row_w)))
    total = int(row_starts[-1])
    out = np.zeros(total, dtype=np.uint8)
    for col, p, rel in zip(cols, plans, col_starts):
        id_pos = row_starts[:-1] + (rel - cid_w)
        out[id_pos] = codec.INT_FLAG
        out[(id_pos + 1)[:, None] + np.arange(8)] = np.broadcast_to(
            _int_payload(np.array([col.id]))[0], (n, 8))
        p.scatter(out, row_starts[:-1] + rel)
    blob = out.tobytes()
    return [blob[row_starts[i]:row_starts[i + 1]] for i in range(n)]


def bulk_load(storage, table, columns: dict, handles=None,
              rebase_autoid: bool = True) -> int:
    """Ingest columnar data into a table as one committed import.

    table: a tidb_tpu_torch.table.Table. columns: {lower col name: array | (data,
    valid)} for every public column — int64 for INT/DATE/DATETIME (epoch
    micros), float64 for REAL, column-frac scaled int64 for DECIMAL, object
    str for STRING. handles: int64 row handles (defaults to the
    pk-is-handle column). Tables with secondary indexes are refused (the
    offline importer writes record keys only). -> rows ingested."""
    info = table.info
    if info.writable_indexes():
        raise kv.KVError("bulk_load: secondary indexes unsupported")
    pub = info.public_columns()
    missing = [c.name for c in pub if c.name.lower() not in columns]
    if missing:
        raise kv.KVError(f"bulk_load: missing columns {missing}")
    plans = []
    n = None
    for c in pub:
        v = columns[c.name.lower()]
        data, valid = v if isinstance(v, tuple) else (
            v, np.ones(len(v), dtype=bool))
        if n is None:
            n = len(valid)
        elif len(valid) != n:
            raise kv.KVError("bulk_load: column length mismatch")
        plans.append(_ColPlan(c, data, valid))
    if n is None or n == 0:
        return 0
    if handles is None:
        if not info.pk_is_handle:
            raise kv.KVError("bulk_load: handles required without int pk")
        names = [c.name.lower() for c in pub]
        pk_plan = plans[names.index(info.pk_col_name.lower())]
        if not pk_plan.valid.all():
            raise kv.KVError("bulk_load: NULL primary key")
        handles = pk_plan.data
    handles = np.asarray(handles, dtype=np.int64)
    # sorted-by-key ingest keeps the engine's ordered index append-friendly
    order = np.argsort(handles, kind="stable")
    plans = [_reorder(p, order) for p in plans]
    handles = handles[order]
    if np.any(np.diff(handles) == 0):
        raise kv.KVError("bulk_load: duplicate handles")
    keys = encode_record_keys(info.id, handles)
    values = encode_rows_columnar(pub, plans)
    start_ts = storage.current_ts()
    commit_ts = storage.current_ts()
    storage.engine.bulk_import(zip(keys, values), start_ts, commit_ts)
    if rebase_autoid and len(handles):
        table.rebase_auto_id(int(handles.max()))
    return n


def _reorder(p: _ColPlan, order: np.ndarray) -> _ColPlan:
    p.valid = p.valid[order]
    p.widths = p.widths[order]
    if p.codes is not None:
        p.codes = p.codes[order]
    else:
        p.data = p.data[order]
    return p
