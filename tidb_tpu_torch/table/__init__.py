"""Row-level table operations over the transactional KV store.

The port's copy of the JAX package's table/__init__.py (itself after
the reference's table/tables/tables.go: AddRecord, RowWithCols, index
maintenance; key layout via tablecodec). Two changes: the native
decoder also takes string columns (native/codec.cc's bytes kind), so a
TPC-H lineitem scan decodes in C++ where the reference's falls to the
per-row Python loop; and `_now_micros`, which the JAX package's copy
calls without defining. Auto-increment ids come in batches from the
meta layer (meta/), as in the reference.

Datum conventions at this layer (matching sqltypes):
    INT/DATETIME/DURATION -> python int (epoch micros for times)
    REAL                  -> float
    DECIMAL               -> (frac, scaled_int) tuple in KV, scaled per
                             column frac in chunks
    STRING                -> str/bytes
"""

from __future__ import annotations

import threading
import weakref

import numpy as np

from tidb_tpu_torch import codec, kv, tablecodec
from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.schema.model import IndexInfo, SchemaState, TableInfo
from tidb_tpu_torch.sqltypes import (EvalType, FieldType, TypeCode,
                                     decimal_to_scaled, np_dtype_for,
                                     scaled_to_decimal)

__all__ = ["Table", "DupKeyError", "encode_datum_for_col",
           "decode_datum_for_col", "rows_to_chunk", "kvrows_to_chunk"]


class DupKeyError(kv.KVError):
    def __init__(self, key_desc: str):
        super().__init__(f"Duplicate entry for key '{key_desc}'")


def _normalize_enum_set(v, ft: FieldType):
    """ENUM: member string (or 1-based ordinal) -> the member, validated.
    SET: comma list (or bitmask) -> members deduped in definition order.
    Values are STORED as their member strings (a documented departure
    from MySQL's ordinal storage: comparisons/sorts here are by string,
    not by member index). Ref: types/enum.go, types/set.go."""
    elems = ft.elems
    if ft.tp == TypeCode.ENUM:
        if isinstance(v, (int,)) and not isinstance(v, bool):
            if not (1 <= v <= len(elems)):
                raise kv.KVError(f"invalid enum ordinal {v}")
            return elems[v - 1]
        sv = v if isinstance(v, str) else str(v)
        for e in elems:
            if e.lower() == sv.lower():
                return e
        raise kv.KVError(f"invalid enum value {sv!r} "
                         f"(members: {', '.join(elems)})")
    # SET
    if isinstance(v, int) and not isinstance(v, bool):
        if not (0 <= v < 1 << len(elems)):
            raise kv.KVError(f"invalid set bitmask {v}")
        return ",".join(e for i, e in enumerate(elems) if v >> i & 1)
    sv = v if isinstance(v, str) else str(v)
    if sv == "":
        return ""
    chosen = []
    for part in sv.split(","):
        hit = next((e for e in elems
                    if e.lower() == part.strip().lower()), None)
        if hit is None:
            raise kv.KVError(f"invalid set member {part!r} "
                             f"(members: {', '.join(elems)})")
        if hit not in chosen:
            chosen.append(hit)
    return ",".join(e for e in elems if e in chosen)


def encode_datum_for_col(v, ft: FieldType):
    """Python value -> KV datum representation."""
    if v is None:
        return None
    if ft.eval_type == EvalType.DECIMAL:
        # normalize to the column's scale: the memcomparable decimal
        # encoding orders by (frac, scaled), so every stored datum of a
        # column MUST share the column frac or index ranges break
        wide = ft.is_wide_decimal
        if isinstance(v, tuple):
            frac, scaled = v
            out = (ft.frac, _rescale_decimal(scaled, frac, ft.frac))
        else:
            out = (ft.frac, decimal_to_scaled(v, ft.frac, wide=wide))
        if ft.flen > 0 and abs(out[1]) >= 10 ** (
                ft.flen if wide else min(ft.flen, 18)):
            # MySQL strict mode: out-of-range decimal is an error, never
            # a silently stored wider value
            raise kv.KVError(
                f"Out of range value for DECIMAL({ft.flen},{ft.frac})")
        return out
    if ft.tp in (TypeCode.ENUM, TypeCode.SET):
        return _normalize_enum_set(v, ft)
    if ft.tp == TypeCode.JSON:
        # canonical compact text (ref: types/json/binary.go stores a
        # binary form; text keeps the column host-side and printable)
        import json as _json
        if isinstance(v, tuple):       # decimal datum -> a JSON number
            frac, scaled = v
            v = float(scaled_to_decimal(scaled, frac))
        if isinstance(v, (bytes, str)):
            try:
                return _json.dumps(_json.loads(v), separators=(",", ":"))
            except ValueError:
                raise kv.KVError(
                    f"Invalid JSON text: {str(v)[:64]!r}") from None
        return _json.dumps(v, separators=(",", ":"))
    if ft.eval_type == EvalType.STRING:
        return v if isinstance(v, (str, bytes)) else str(v)
    if isinstance(v, tuple):      # decimal datum into a non-decimal column
        frac, scaled = v
        if ft.eval_type == EvalType.REAL:
            return float(scaled_to_decimal(scaled, frac))
        # exact int64-safe rounding, MySQL half-away-from-zero
        q, r = divmod(abs(scaled), 10 ** frac)
        out = q + (1 if 2 * r >= 10 ** frac else 0)
        return out if scaled >= 0 else -out
    if ft.eval_type == EvalType.REAL:
        return float(v)
    if ft.eval_type == EvalType.DATETIME:
        if isinstance(v, str):
            from tidb_tpu_torch.sqltypes import parse_datetime
            v = parse_datetime(v)
        # round micros to the column's fsp at the write, like MySQL
        # DATETIME(fsp) (frac 0 stores whole seconds — 00:00:00.5
        # becomes 00:00:01, never a displayed fraction later)
        step = 10 ** (6 - min(max(ft.frac, 0), 6))
        if step > 1:
            v = ((int(v) + step // 2) // step) * step
        return int(v)
    if isinstance(v, float):      # MySQL rounds halves away from zero
        import math
        return int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5))
    return int(v)


def _rescale_decimal(scaled: int, frac: int, to_frac: int) -> int:
    """Change a scaled decimal's scale; MySQL half-away-from-zero when
    dropping digits."""
    if to_frac == frac:
        return scaled
    if to_frac > frac:
        return scaled * (10 ** (to_frac - frac))
    div = 10 ** (frac - to_frac)
    q, r = divmod(abs(scaled), div)
    out = q + (1 if 2 * r >= div else 0)
    return out if scaled >= 0 else -out


def decode_datum_for_col(v, ft: FieldType):
    """KV datum -> chunk-layer value (scaled int for decimals)."""
    if v is None:
        return None
    if ft.eval_type == EvalType.DECIMAL:
        frac, scaled = v
        return _rescale_decimal(scaled, frac, ft.frac)
    if ft.eval_type in (EvalType.STRING, EvalType.JSON) and \
            isinstance(v, bytes):
        # JSON text decodes here too: filters/joins on JSON columns must
        # see str, not bytes (presentation is too late)
        try:
            return v.decode("utf8")
        except UnicodeDecodeError:
            return v
    return v


# auto-increment batch caches shared across per-statement Table objects:
# storage -> {table_id: [next, last]} (ref: autoid.go:36 Allocator held
# by the domain, not the statement)
_AUTO_REGISTRY: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_AUTO_LOCK = threading.Lock()


def _now_micros() -> int:
    """CURRENT_TIMESTAMP as epoch micros (a DATETIME default)."""
    import datetime
    from tidb_tpu_torch.sqltypes import datetime_to_micros
    return datetime_to_micros(datetime.datetime.now())


class Table:
    """Operations for one table inside caller-provided transactions."""

    def __init__(self, info: TableInfo, storage):
        self.info = info
        self.storage = storage  # for auto-id allocation meta txns

    # -- auto increment ------------------------------------------------------

    AUTO_ID_STEP = 4000  # ref: meta/autoid allocator batch (autoid.go:36)

    # first id this Table instance generated: the LAST_INSERT_ID source
    # (MySQL reports the FIRST value generated by the last INSERT)
    first_alloc_id: int | None = None

    def _auto_cache_slot(self) -> list:
        """Shared [next, last] batch per (storage, table id). Table
        objects are per-statement, but the allocator must persist across
        statements like the reference's domain-held autoid.Allocator
        (autoid.go:36) — else every INSERT burns a fresh 4000-id batch
        and ids jump 1, 4001, 8001..."""
        caches = _AUTO_REGISTRY.get(self.storage)
        if caches is None:
            caches = _AUTO_REGISTRY.setdefault(self.storage, {})
        slot = caches.get(self.info.id)
        if slot is None:
            slot = caches[self.info.id] = [1, 0]   # empty range
        return slot

    def alloc_auto_id(self, track: bool = True) -> int:
        out = None
        with _AUTO_LOCK:
            slot = self._auto_cache_slot()
            if slot[0] <= slot[1]:
                out = slot[0]
                slot[0] += 1
        if out is None:
            # batch refill OUTSIDE the lock: the meta txn must not
            # serialize inserts on unrelated tables. Two racing refills
            # allocate distinct ranges (meta inc is transactional); the
            # loser's leftover range is skipped, ids just gap.
            from tidb_tpu_torch.meta import Meta
            txn = self.storage.begin()
            try:
                first, last = Meta(txn).gen_auto_id(
                    self.info.id, self.AUTO_ID_STEP)
                txn.commit()
            except Exception:
                txn.rollback()
                raise
            out = first
            with _AUTO_LOCK:
                slot = self._auto_cache_slot()
                if last > slot[1]:
                    slot[0], slot[1] = first + 1, last
        # only user-visible AUTO_INCREMENT allocations feed
        # LAST_INSERT_ID; the hidden _tidb_rowid handle does not (MySQL
        # returns 0 after inserting into a table with no auto column)
        if track and self.first_alloc_id is None:
            self.first_alloc_id = out
        return out

    def rebase_auto_id(self, at_least: int) -> None:
        from tidb_tpu_torch.meta import Meta
        txn = self.storage.begin()
        try:
            Meta(txn).rebase_auto_id(self.info.id, at_least)
            txn.commit()
        except Exception:
            txn.rollback()
            raise
        with _AUTO_LOCK:
            slot = self._auto_cache_slot()
            if slot[0] <= at_least <= slot[1]:
                # explicit id landed inside the cached batch: skip past
                # it (ref: autoid.go Rebase with newBase <= alloc.end)
                slot[0] = at_least + 1
            elif at_least > slot[1]:
                slot[0], slot[1] = 1, 0   # force a fresh meta batch

    # -- write path ----------------------------------------------------------

    def add_record(self, txn: kv.Transaction, values: dict[str, object],
                   handle: int | None = None, skip_dup_check: bool = False
                   ) -> int:
        """Insert one row; values keyed by lower column name. Returns the
        handle. Ref: tables.go:309 AddRecord."""
        info = self.info
        row_vals = {}
        for col in info.writable_columns():
            cname = col.name.lower()
            if cname in values:
                v = values[cname]
                # explicit NULL: auto-inc still allocates (MySQL), NOT NULL
                # errors; it is NOT replaced by the default
                if v is None and col.auto_increment:
                    v = self.alloc_auto_id()
                elif v is None and col.ft.not_null and \
                        col.state == SchemaState.PUBLIC:
                    raise kv.KVError(f"column '{col.name}' cannot be null")
            else:
                # omitted column: default / auto-increment
                if col.auto_increment:
                    v = self.alloc_auto_id()
                elif col.has_default:
                    v = col.default
                    if v == "CURRENT_TIMESTAMP" and \
                            col.ft.eval_type == EvalType.DATETIME:
                        v = _now_micros()   # evaluated per insert
                elif col.ft.not_null and col.state == SchemaState.PUBLIC:
                    raise kv.KVError(f"column '{col.name}' cannot be null")
                else:
                    v = None
            row_vals[col.id] = encode_datum_for_col(v, col.ft) \
                if v is not None else None

        if handle is None:
            if info.pk_is_handle:
                pk = info.col_by_name(info.pk_col_name)
                hv = row_vals.get(pk.id)
                if hv is None:
                    raise kv.KVError("primary key cannot be null")
                handle = int(hv)
                self.rebase_auto_id(handle) if pk.auto_increment else None
            else:
                handle = self.alloc_auto_id(track=False)

        rk = tablecodec.record_key(info.id, handle)
        if not skip_dup_check:
            if info.pk_is_handle and txn.get(rk) is not None:
                raise DupKeyError(f"{handle} for key 'PRIMARY'")
        # indexes first (unique checks), then the row
        for idx in self.info.writable_indexes():
            self._add_index_entry(txn, idx, row_vals, handle,
                                  check_dup=not skip_dup_check)
        col_ids = sorted(row_vals)
        txn.set(rk, tablecodec.encode_row(
            col_ids, [row_vals[c] for c in col_ids]))
        return handle

    def _index_values(self, idx: IndexInfo, row_vals: dict[int, object]):
        """Index-key datums for one row. _ci string columns contribute
        their casefolded collation key, so memcomparable byte order IS
        collation order and unique indexes reject case-duplicates (ref:
        collation-aware index encoding; the row itself keeps the
        original value — indexes on _ci columns are never covering)."""
        out = []
        for cname in idx.columns:
            col = self.info.col_by_name(cname)
            v = row_vals.get(col.id)
            if col.ft.is_ci and isinstance(v, str):
                from tidb_tpu_torch.sqltypes import collation_key
                v = collation_key(v)
            out.append(v)
        return out

    def _add_index_entry(self, txn, idx: IndexInfo,
                         row_vals: dict[int, object], handle: int,
                         check_dup: bool) -> None:
        vals = self._index_values(idx, row_vals)
        if idx.unique and all(v is not None for v in vals):
            ik = tablecodec.index_key(self.info.id, idx.id, vals)
            if check_dup:
                existing = txn.get(ik)
                if existing is not None:
                    raise DupKeyError(f"{vals} for key '{idx.name}'")
            txn.set(ik, codec.encode_int(handle))
        else:
            # non-unique (or unique w/ NULL part): handle in the key
            ik = tablecodec.index_key(self.info.id, idx.id, vals,
                                      handle=handle)
            txn.set(ik, b"0")

    def remove_record(self, txn: kv.Transaction, handle: int,
                      row_vals: dict[int, object]) -> None:
        """Ref: tables.go RemoveRecord + DeletableIndices."""
        txn.delete(tablecodec.record_key(self.info.id, handle))
        for idx in self.info.deletable_indexes():
            vals = self._index_values(idx, row_vals)
            if idx.unique and all(v is not None for v in vals):
                txn.delete(tablecodec.index_key(self.info.id, idx.id, vals))
            else:
                txn.delete(tablecodec.index_key(self.info.id, idx.id, vals,
                                                handle=handle))

    def update_record(self, txn: kv.Transaction, handle: int,
                      old_vals: dict[int, object],
                      new_values: dict[str, object]) -> None:
        """new_values keyed by lower column name (python values)."""
        merged = dict(old_vals)
        for name, v in new_values.items():
            col = self.info.col_by_name(name)
            merged[col.id] = encode_datum_for_col(v, col.ft) \
                if v is not None else None
        self.remove_record(txn, handle, old_vals)
        col_ids = sorted(merged)
        rk = tablecodec.record_key(self.info.id, handle)
        for idx in self.info.writable_indexes():
            self._add_index_entry(txn, idx, merged, handle, check_dup=True)
        txn.set(rk, tablecodec.encode_row(
            col_ids, [merged[c] for c in col_ids]))

    # -- read path -----------------------------------------------------------

    def row_by_handle(self, retriever, handle: int) -> dict[int, object] | None:
        raw = retriever.get(tablecodec.record_key(self.info.id, handle))
        if raw is None:
            return None
        return tablecodec.decode_row(raw)

    def iter_records(self, retriever, start_handle: int | None = None):
        """Yields (handle, {col_id: datum}). Ref: tables.go IterRecords."""
        info = self.info
        start = tablecodec.record_key(info.id, start_handle) \
            if start_handle is not None else tablecodec.record_prefix(info.id)
        end = codec.prefix_next(tablecodec.record_prefix(info.id))
        for k, v in retriever.iter_range(start, end):
            _tid, handle = tablecodec.decode_record_key(k)
            yield handle, tablecodec.decode_row(v)


def index_kvrows_to_chunk(info: TableInfo, idx: IndexInfo, col_infos,
                          kvrows, handle_col: int | None = None) -> Chunk:
    """Decode raw index (key, value) pairs into a chunk of the requested
    index columns (+ handle). Non-unique entries carry the handle as the
    key's last datum; unique entries carry it in the value
    (ref: tablecodec.go index layout, table/tables/index.go)."""
    from tidb_tpu_torch import codec as _codec
    from tidb_tpu_torch.sqltypes import new_int_field
    n_idx_cols = len(idx.columns)
    # map requested col name -> position among the index's columns
    pos_by_name = {c.lower(): i for i, c in enumerate(idx.columns)}
    ncols = len(col_infos) + (1 if handle_col is not None else 0)
    rows = []
    for k, v in kvrows:
        _tid, _iid, suffix = tablecodec.decode_index_key(k)
        vals = _codec.decode_key(suffix)
        if len(vals) > n_idx_cols:          # handle stored in-key
            handle = vals[n_idx_cols]
            vals = vals[:n_idx_cols]
        else:                               # unique entry: handle in value
            handle, _ = _codec.decode_int(v, 0)
        row = []
        src = 0
        for j in range(ncols):
            if handle_col is not None and j == handle_col:
                row.append(handle)
                continue
            ci = col_infos[src]
            src += 1
            pos = pos_by_name.get(ci.name.lower())
            # pk-is-handle column is not among index columns; its value IS
            # the handle (covering-index reads rely on this)
            row.append(handle if pos is None else vals[pos])
        rows.append(row)
    fts = []
    src = 0
    for j in range(ncols):
        if handle_col is not None and j == handle_col:
            fts.append(new_int_field())
        else:
            fts.append(col_infos[src].ft)
            src += 1
    return rows_to_chunk(fts, rows)


def rows_to_chunk(fts: list[FieldType], rows: list[list]) -> Chunk:
    """Build a chunk from decoded python values (decimals may be tuples)."""
    cols = []
    for j, ft in enumerate(fts):
        vals = [decode_datum_for_col(r[j], ft) for r in rows]
        dtype = np_dtype_for(ft.tp, ft.flen)
        valid = np.array([v is not None for v in vals], dtype=bool)
        if dtype == np.dtype(object):
            from tidb_tpu_torch.sqltypes import object_fill
            fill = object_fill(ft)
            data = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                data[i] = v if v is not None else fill
        else:
            data = np.zeros(len(vals), dtype=dtype)
            for i, v in enumerate(vals):
                if v is not None:
                    data[i] = v
        cols.append(Column(ft, data, valid))
    return Chunk(cols)


# string types whose stored datum is the value's bytes as they are (ENUM
# and SET normalize on write, JSON canonicalizes)
_NATIVE_STRING_TYPES = (TypeCode.VARCHAR, TypeCode.STRING,
                        TypeCode.VARSTRING, TypeCode.BLOB)


def _kvrows_to_chunk_native(col_infos, kvrows,
                            with_handle_col: int | None) -> Chunk | None:
    """C++ batch decode straight into columnar buffers (native/codec.cc).
    Handles fixed-width and plain string columns; None -> caller uses the
    Python loop (ENUM/SET/JSON/duration columns, unusual encodings, no
    compiler)."""
    from tidb_tpu_torch.native import (NATIVE_KIND_BYTES,
                                       NATIVE_KIND_DECIMAL,
                                       NATIVE_KIND_FLOAT,
                                       NATIVE_KIND_HANDLE, NATIVE_KIND_INT,
                                       decode_rows_native)
    from tidb_tpu_torch.sqltypes import new_int_field
    ncols = len(col_infos) + (1 if with_handle_col is not None else 0)
    specs = []
    fts = []
    src = 0
    for j in range(ncols):
        if with_handle_col is not None and j == with_handle_col:
            specs.append((0, NATIVE_KIND_HANDLE, 0, False, None))
            fts.append(new_int_field())
            continue
        ci = col_infos[src]
        src += 1
        et = ci.ft.eval_type
        if et in (EvalType.INT, EvalType.DATETIME):
            kind = NATIVE_KIND_INT
        elif et == EvalType.REAL:
            kind = NATIVE_KIND_FLOAT
        elif et == EvalType.DECIMAL:
            kind = NATIVE_KIND_DECIMAL
        elif ci.ft.tp in _NATIVE_STRING_TYPES:
            kind = NATIVE_KIND_BYTES
        else:
            return None   # enum/set/json/duration: python path
        default = None
        if ci.has_default and ci.default is not None:
            default = encode_datum_for_col(ci.default, ci.ft)
            if isinstance(default, tuple):
                default = default[1]   # scaled int at the column's frac
        specs.append((ci.id, kind, ci.ft.frac, ci.has_default, default))
        fts.append(ci.ft)
    out = decode_rows_native(kvrows, specs)
    if out is None:
        return None
    datas, valids = out
    return Chunk([Column(ft, d, v)
                  for ft, d, v in zip(fts, datas, valids)])


def kvrows_to_chunk(info: TableInfo, col_infos, kvrows,
                    with_handle_col: int | None = None) -> Chunk:
    """Decode raw (key, value) record pairs into a chunk of the requested
    columns. col_infos: list of ColumnInfo to emit, in order.
    with_handle_col: emit the row handle as an extra int column at this
    output position (DML readers need it to address rows).
    Fast path: the C++ batch decoder (ref: util/codec DecodeOneToChunk,
    codec.go:387 — and the Rust TiKV decode the reference leans on)."""
    from tidb_tpu_torch.sqltypes import new_int_field
    # wide-decimal datums use variable-length encodings the C++ walker
    # doesn't know; any such column in the ROW (even unrequested) gates
    # the whole table to the python decode path
    ch = None
    if not any(c.ft.is_wide_decimal for c in info.columns):
        ch = _kvrows_to_chunk_native(col_infos, kvrows, with_handle_col)
    if ch is not None:
        return ch
    ncols = len(col_infos) + (1 if with_handle_col is not None else 0)
    rows = []
    for k, v in kvrows:
        _tid, handle = tablecodec.decode_record_key(k)
        d = tablecodec.decode_row(v)
        row = []
        src = 0
        for j in range(ncols):
            if with_handle_col is not None and j == with_handle_col:
                row.append(handle)
                continue
            ci = col_infos[src]
            src += 1
            if ci.id in d:
                val = d[ci.id]   # stored value, including explicit NULL
            elif ci.has_default:
                # row written before ALTER ADD COLUMN: synthesize default
                val = encode_datum_for_col(ci.default, ci.ft)
            else:
                val = None
            row.append(val)
        rows.append(row)
    fts = []
    src = 0
    for j in range(ncols):
        if with_handle_col is not None and j == with_handle_col:
            fts.append(new_int_field())
        else:
            fts.append(col_infos[src].ft)
            src += 1
    return rows_to_chunk(fts, rows)
