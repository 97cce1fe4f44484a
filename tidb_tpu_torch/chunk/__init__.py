"""Columnar batch format (Arrow layout), numpy-backed, device-transferable.

Reference: TiDB's util/chunk/chunk.go:27-97 — per-column null bitmap
plus fixed-width data buffer, or offsets + varlen buffer. Here:

* Fixed-width columns are a single numpy array (int64 / float64) plus a
  boolean validity array (True = valid, Arrow convention). These views are
  exactly what `ops.runtime.device_put_chunk` copies to device memory —
  host<->device DMA is a memcpy.
* Varlen (string/bytes) columns are numpy object arrays on the host;
  `dict_encode` produces int64 codes + a dictionary so group-by/join keys
  can ride the device path (SURVEY.md §7 "Variable-length strings on device").

Unlike the reference's append-row-at-a-time builder, the fast path is
columnar construction from numpy; append_row exists for the control plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from tidb_tpu_torch.sqltypes import (EvalType, FieldType, TypeCode, decimal_to_scaled,
                               np_dtype_for, scaled_to_decimal)

__all__ = ["Column", "Chunk", "dict_encode", "MAX_CHUNK_SIZE"]

# Default row cap per chunk; ref: sessionctx/variable/session.go:244 (1024).
# We default larger because device kernels amortize better on big batches.
MAX_CHUNK_SIZE = 32768


class Column:
    """One column: numpy data + validity mask."""

    # _enc memoizes dict_encode's (codes, values) — columns are
    # immutable once built, so the dictionary pass runs once per column
    # no matter how many consumers (device transfer, join key encoding,
    # encoded filters) ask for codes. The values list may be EXTENDED in
    # place by an incremental dictionary growth: appends only, existing
    # codes stay stable.
    __slots__ = ("ft", "data", "valid", "_enc")

    def __init__(self, ft: FieldType, data: np.ndarray, valid: np.ndarray | None = None):
        self.ft = ft
        self.data = data
        if valid is None:
            valid = np.ones(len(data), dtype=bool)
        self.valid = valid

    # -- construction -------------------------------------------------------

    @staticmethod
    def empty(ft: FieldType) -> "Column":
        return Column(ft, np.empty(0, dtype=np_dtype_for(ft.tp)), np.empty(0, dtype=bool))

    @staticmethod
    def from_values(ft: FieldType, values: Iterable) -> "Column":
        """Build from python values (None = NULL). Converts decimals/datetimes
        to their int64 device representation per sqltypes conventions."""
        vals = list(values)
        n = len(vals)
        dtype = np_dtype_for(ft.tp)
        valid = np.array([v is not None for v in vals], dtype=bool)
        if dtype == np.dtype(object):
            data = np.empty(n, dtype=object)
            for i, v in enumerate(vals):
                data[i] = v if v is not None else ""
        else:
            data = np.zeros(n, dtype=dtype)
            et = ft.eval_type
            for i, v in enumerate(vals):
                if v is None:
                    continue
                if et == EvalType.DECIMAL:
                    data[i] = decimal_to_scaled(v, ft.frac)
                else:
                    data[i] = v
        return Column(ft, data, valid)

    # -- access --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.data)

    def is_null(self, i: int) -> bool:
        return not self.valid[i]

    def get(self, i: int):
        """Python value at row i (host path; decimals decoded exactly)."""
        if not self.valid[i]:
            return None
        v = self.data[i]
        if self.ft.tp == TypeCode.NEWDECIMAL:
            return scaled_to_decimal(int(v), self.ft.frac)
        if isinstance(v, np.generic):
            return v.item()
        return v

    def take(self, idx: np.ndarray) -> "Column":
        return Column(self.ft, self.data[idx], self.valid[idx])

    def slice(self, start: int, stop: int) -> "Column":
        return Column(self.ft, self.data[start:stop], self.valid[start:stop])

    def concat(self, other: "Column") -> "Column":
        return Column(self.ft, np.concatenate([self.data, other.data]),
                      np.concatenate([self.valid, other.valid]))

    @property
    def fixed_width(self) -> bool:
        return self.data.dtype != np.dtype(object)


class Chunk:
    """A batch of rows in columnar layout. Ref: util/chunk/chunk.go NewChunk."""

    # _dev_cache: memoized device-resident columns (ops/runtime.py
    # device_put_chunk) — chunks are treated as immutable once built.
    # _scan_handles/_delta_memo ride cached base chunks only
    # (store/delta.py): the row handles of a cached record scan, and
    # the memoized base-plus-delta merges computed from them.
    # _bytes_memo caches memtrack's O(columns-payload) byte sizing —
    # hot cached chunks are re-sized on every dispatch otherwise
    __slots__ = ("columns", "_dev_cache", "_cop_filter_memo",
                 "_scan_handles", "_delta_memo", "_bytes_memo")

    def __getstate__(self):
        # device memos and filter memos are process-local accelerators;
        # they must never ride a pickle across the storage RPC
        return {"columns": self.columns}

    def __setstate__(self, state):
        self.columns = state["columns"]

    def __init__(self, columns: Sequence[Column]):
        self.columns = list(columns)
        if self.columns:
            n = len(self.columns[0])
            for c in self.columns:
                assert len(c) == n, "ragged chunk"

    # -- construction -------------------------------------------------------

    @staticmethod
    def empty(fts: Sequence[FieldType]) -> "Chunk":
        return Chunk([Column.empty(ft) for ft in fts])

    @staticmethod
    def from_rows(fts: Sequence[FieldType], rows: Iterable[Sequence]) -> "Chunk":
        rows = list(rows)
        cols = []
        for j, ft in enumerate(fts):
            cols.append(Column.from_values(ft, [r[j] for r in rows]))
        return Chunk(cols)

    @staticmethod
    def from_arrays(fts: Sequence[FieldType], arrays: Sequence[np.ndarray],
                    valids: Sequence[np.ndarray] | None = None) -> "Chunk":
        cols = []
        for j, ft in enumerate(fts):
            v = valids[j] if valids is not None else None
            cols.append(Column(ft, np.asarray(arrays[j]), v))
        return Chunk(cols)

    # -- access --------------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    def __len__(self) -> int:
        return self.num_rows

    def col(self, j: int) -> Column:
        return self.columns[j]

    def row(self, i: int) -> tuple:
        return tuple(c.get(i) for c in self.columns)

    def iter_rows(self):
        for i in range(self.num_rows):
            yield self.row(i)

    def to_pylist(self) -> list[tuple]:
        return list(self.iter_rows())

    def take(self, idx: np.ndarray) -> "Chunk":
        return Chunk([c.take(idx) for c in self.columns])

    def filter(self, mask: np.ndarray) -> "Chunk":
        return self.take(np.flatnonzero(mask))

    def slice(self, start: int, stop: int) -> "Chunk":
        return Chunk([c.slice(start, stop) for c in self.columns])

    def concat(self, other: "Chunk") -> "Chunk":
        if not self.columns:
            return other
        return Chunk([a.concat(b) for a, b in zip(self.columns, other.columns)])

    @staticmethod
    def concat_all(chunks: list["Chunk"]) -> "Chunk | None":
        """One-pass concatenation (pairwise .concat in a loop re-copies the
        accumulated prefix per chunk — O(C^2) in chunk count)."""
        chunks = [c for c in chunks if c.columns]
        if not chunks:
            return None
        if len(chunks) == 1:
            return chunks[0]
        cols = []
        for j, c0 in enumerate(chunks[0].columns):
            cols.append(Column(
                c0.ft,
                np.concatenate([c.columns[j].data for c in chunks]),
                np.concatenate([c.columns[j].valid for c in chunks])))
        return Chunk(cols)

    def field_types(self) -> list[FieldType]:
        return [c.ft for c in self.columns]


def dict_encode(col: Column) -> tuple[np.ndarray, list]:
    """Dictionary-encode a varlen column: returns (int64 codes, dictionary).

    NULLs get code -1. The codes array rides the device path for group-by /
    join keys; the dictionary stays host-side for final decode. Columns
    with a _ci collation encode by CASEFOLDED value — case variants share
    one code, so device group-by/compare over codes follows the collation
    (the dictionary keeps the first-seen variant for decode, matching the
    host path's representative-row semantics).

    The result is memoized on the column (columns are immutable): hot
    cached chunks pay the Python encode pass once, and every consumer
    (device transfer, join key encoder, encoded filter translation)
    shares ONE (codes, values) pair — the identity that makes
    shared-dictionary detection possible (ops/encoded.py).
    """
    hit = getattr(col, "_enc", None)
    if hit is not None:
        return hit
    codes = np.empty(len(col), dtype=np.int64)
    mapping: dict = {}
    values: list = []
    data, valid = col.data, col.valid
    ci = col.ft.is_ci
    if ci:
        from tidb_tpu_torch.sqltypes import collation_key
    for i in range(len(col)):
        if not valid[i]:
            codes[i] = -1
            continue
        v = data[i]
        k = collation_key(v) if ci else v
        c = mapping.get(k)
        if c is None:
            c = len(values)
            mapping[k] = c
            values.append(v)
        codes[i] = c
    col._enc = (codes, values)
    return codes, values
