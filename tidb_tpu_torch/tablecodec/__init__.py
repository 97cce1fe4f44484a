"""Row/index <-> ordered-KV key layout.

Reference: TiDB's tablecodec/tablecodec.go:37-65 —
    row:    t{tableID}_r{handle}            (tableID, handle: comparable int64)
    index:  t{tableID}_i{indexID}{values}   (values: memcomparable datums)
Row value is a colID->datum pair sequence; non-unique index values append the
handle to the key so entries stay unique, unique index values carry the
handle in the value.
"""

from __future__ import annotations

from tidb_tpu_torch import codec

__all__ = [
    "TABLE_PREFIX", "RECORD_SEP", "INDEX_SEP",
    "record_key", "record_prefix", "decode_record_key",
    "index_key", "index_prefix", "decode_index_key",
    "encode_row", "decode_row", "table_prefix_range",
]

TABLE_PREFIX = b"t"
RECORD_SEP = b"_r"
INDEX_SEP = b"_i"


def record_prefix(table_id: int) -> bytes:
    return TABLE_PREFIX + codec.encode_int(table_id) + RECORD_SEP


def record_key(table_id: int, handle: int) -> bytes:
    return record_prefix(table_id) + codec.encode_int(handle)


def decode_record_key(key: bytes) -> tuple[int, int]:
    """-> (table_id, handle). Raises ValueError on non-record/short keys."""
    if not key.startswith(TABLE_PREFIX) or len(key) < 19:
        raise ValueError("not a record key")
    tid, off = codec.decode_int(key, 1)
    if key[off:off + 2] != RECORD_SEP:
        raise ValueError("not a record key")
    handle, _ = codec.decode_int(key, off + 2)
    return tid, handle


def index_prefix(table_id: int, index_id: int) -> bytes:
    return TABLE_PREFIX + codec.encode_int(table_id) + INDEX_SEP + \
        codec.encode_int(index_id)


def index_key(table_id: int, index_id: int, values, handle: int | None = None) -> bytes:
    """Non-unique indexes pass `handle` to keep entries distinct."""
    k = index_prefix(table_id, index_id) + codec.encode_key(values)
    if handle is not None:
        k += codec.encode_datum(handle)
    return k


def decode_index_key(key: bytes) -> tuple[int, int, bytes]:
    """-> (table_id, index_id, encoded_values_suffix)."""
    if not key.startswith(TABLE_PREFIX) or len(key) < 19:
        raise ValueError("not an index key")
    tid, off = codec.decode_int(key, 1)
    if key[off:off + 2] != INDEX_SEP:
        raise ValueError("not an index key")
    iid, off = codec.decode_int(key, off + 2)
    return tid, iid, key[off:]


def table_prefix_range(table_id: int) -> tuple[bytes, bytes]:
    """[start, end) covering every key of a table (prefix-successor end,
    safe at table_id = int64 max)."""
    p = TABLE_PREFIX + codec.encode_int(table_id)
    return p, codec.prefix_next(p)


def encode_row(col_ids, values) -> bytes:
    """Row value: flat [colID, value, colID, value, ...] datum sequence.
    Ref: tablecodec.go EncodeRow (datum-pairs codec)."""
    flat = []
    for cid, v in zip(col_ids, values, strict=True):
        flat.append(cid)
        flat.append(v)
    return codec.encode_key(flat)


def decode_row(value: bytes) -> dict:
    """-> {col_id: python value}."""
    flat = codec.decode_key(value)
    if len(flat) % 2 != 0:
        raise ValueError("malformed row value")
    return {flat[i]: flat[i + 1] for i in range(0, len(flat), 2)}
