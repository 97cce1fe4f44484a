"""Column statistics: equi-depth histograms and the count-min sketch.

A copy of the parts of the JAX package's statistics module that one
column's ANALYZE needs: `Histogram`, `build_histogram`, `CMSketch`,
`cm_key`, `ColumnStats` and `build_column_stats`. The histogram build
sorts the whole column; a numeric column of `_DEVICE_SORT_MIN` rows or
more sorts on the device (ops/stats.device_sort, one torch.sort), a
smaller one with numpy. The CMSketch also serves the hybrid join's
streaming heavy-hitter detection (ops/hybrid.py).

`TableStats`, `analyze_table`, `selectivity` and the stats handle need
the storage layer and the planner, which the port does not have yet.
"""

from __future__ import annotations

import base64
import hashlib
import math
from bisect import bisect_left
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Histogram", "CMSketch", "ColumnStats", "build_histogram",
           "build_column_stats", "cm_key", "CM_DEPTH",
           "CM_WIDTH", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = 256
CM_DEPTH = 4
CM_WIDTH = 2048


# value domain: histogram bounds must be comparable and interpolatable.
# Numeric columns use their values; strings/bytes interpolate by byte
# prefix.


def _bytes_frac(v: bytes, lo: bytes, hi: bytes) -> float:
    """Position of v in [lo, hi) by 8-byte window after the common
    prefix."""
    p = 0
    while p < len(lo) and p < len(hi) and lo[p] == hi[p]:
        p += 1

    def win(b: bytes) -> int:
        w = b[p:p + 8].ljust(8, b"\0")
        return int.from_bytes(w, "big")

    lo_i, hi_i, v_i = win(lo), win(hi), win(v)
    if hi_i <= lo_i:
        return 0.5
    return min(1.0, max(0.0, (v_i - lo_i) / (hi_i - lo_i)))


def _interp(v, lo, hi) -> float:
    """Fraction of [lo, hi) below v."""
    if isinstance(v, (bytes, bytearray)):
        return _bytes_frac(bytes(v), bytes(lo), bytes(hi))
    if isinstance(v, str):
        return _bytes_frac(v.encode("utf-8", "surrogateescape"),
                           str(lo).encode("utf-8", "surrogateescape"),
                           str(hi).encode("utf-8", "surrogateescape"))
    try:
        lo_f, hi_f, v_f = float(lo), float(hi), float(v)
    except (TypeError, ValueError):
        return 0.5
    if hi_f <= lo_f:
        return 0.5
    return min(1.0, max(0.0, (v_f - lo_f) / (hi_f - lo_f)))


@dataclass
class Histogram:
    """Equi-depth histogram. Buckets are parallel lists; counts are
    cumulative row counts through each bucket; repeats count occurrences
    of each bucket's upper bound."""

    ndv: int = 0
    null_count: int = 0
    total: int = 0
    lowers: list = field(default_factory=list)
    uppers: list = field(default_factory=list)
    counts: list = field(default_factory=list)    # cumulative
    repeats: list = field(default_factory=list)

    @property
    def num_buckets(self) -> int:
        return len(self.uppers)

    def _bucket_count(self, i: int) -> int:
        return self.counts[i] - (self.counts[i - 1] if i else 0)

    def _locate(self, v) -> int:
        """First bucket whose upper >= v (may be num_buckets)."""
        return bisect_left(self.uppers, v)

    def less_row_count(self, v) -> float:
        """Estimated rows strictly < v."""
        if not self.uppers:
            return 0.0
        i = self._locate(v)
        if i >= self.num_buckets:
            return float(self.total)
        prev = self.counts[i - 1] if i else 0
        if v <= self.lowers[i]:
            return float(prev)
        in_bucket = self._bucket_count(i) - self.repeats[i]
        frac = _interp(v, self.lowers[i], self.uppers[i])
        return prev + frac * in_bucket

    def equal_row_count(self, v) -> float:
        if not self.uppers or self.ndv == 0:
            return 0.0
        if v < self.lowers[0] or v > self.uppers[-1]:
            return 0.0
        i = self._locate(v)
        if i < self.num_buckets and v == self.uppers[i]:
            return float(self.repeats[i])
        return self.total / self.ndv

    def between_row_count(self, lo, hi, lo_incl: bool = True,
                          hi_incl: bool = False) -> float:
        """Estimated rows in the interval; None bound = unbounded."""
        lo_cnt = 0.0 if lo is None else self.less_row_count(lo)
        hi_cnt = float(self.total) if hi is None else self.less_row_count(hi)
        est = hi_cnt - lo_cnt
        if lo is not None and not lo_incl:
            est -= self.equal_row_count(lo)
        if hi is not None and hi_incl:
            est += self.equal_row_count(hi)
        return max(0.0, min(float(self.total), est))

    def to_obj(self):
        return {"ndv": self.ndv, "null": self.null_count, "total": self.total,
                "lowers": [_val_to_obj(v) for v in self.lowers],
                "uppers": [_val_to_obj(v) for v in self.uppers],
                "counts": self.counts, "repeats": self.repeats}

    @staticmethod
    def from_obj(o) -> "Histogram":
        return Histogram(ndv=o["ndv"], null_count=o["null"],
                         total=o["total"],
                         lowers=[_val_from_obj(v) for v in o["lowers"]],
                         uppers=[_val_from_obj(v) for v in o["uppers"]],
                         counts=list(o["counts"]),
                         repeats=list(o["repeats"]))


def _val_to_obj(v):
    if isinstance(v, (bytes, bytearray)):
        return {"b": base64.b64encode(bytes(v)).decode()}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _val_from_obj(o):
    if isinstance(o, dict) and "b" in o:
        return base64.b64decode(o["b"])
    return o


def build_histogram(values, counts, n_buckets: int = DEFAULT_BUCKETS,
                    null_count: int = 0) -> Histogram:
    """Build from distinct `values` (ascending) with per-value `counts`."""
    h = Histogram(ndv=len(values), null_count=null_count)
    if len(values) == 0:
        return h
    total = int(sum(counts))
    per_bucket = max(1, math.ceil(total / n_buckets))
    cum = 0
    cur = 0  # rows in current bucket
    for v, c in zip(values, counts):
        c = int(c)
        if cur > 0 and cur + c > per_bucket:
            cur = 0
        if cur == 0:
            h.lowers.append(v)
            h.uppers.append(v)
            h.counts.append(cum)
            h.repeats.append(0)
        cum += c
        cur += c
        h.uppers[-1] = v
        h.counts[-1] = cum
        h.repeats[-1] = c
    h.total = cum
    return h


class CMSketch:
    """Count-min sketch, inserted per distinct value with its count."""

    def __init__(self, depth: int = CM_DEPTH, width: int = CM_WIDTH):
        self.depth = depth
        self.width = width
        self.count = 0
        self.table = np.zeros((depth, width), dtype=np.int64)

    def _positions(self, key: bytes) -> list[int]:
        d = hashlib.blake2b(key, digest_size=16).digest()
        h1 = int.from_bytes(d[:8], "little")
        h2 = int.from_bytes(d[8:], "little")
        return [(h1 + i * h2) % self.width for i in range(self.depth)]

    def insert(self, key: bytes, cnt: int = 1) -> None:
        self.count += cnt
        for i, p in enumerate(self._positions(key)):
            self.table[i, p] += cnt

    def query(self, key: bytes) -> int:
        return min(int(self.table[i, p])
                   for i, p in enumerate(self._positions(key)))

    def to_obj(self):
        return {"depth": self.depth, "width": self.width, "count": self.count,
                "table": base64.b64encode(
                    self.table.astype("<i8").tobytes()).decode()}

    @staticmethod
    def from_obj(o) -> "CMSketch":
        cm = CMSketch(o["depth"], o["width"])
        cm.count = o["count"]
        cm.table = np.frombuffer(
            base64.b64decode(o["table"]), dtype="<i8").reshape(
                o["depth"], o["width"]).copy()
        return cm


def cm_key(v) -> bytes:
    """CMSketch key encoding of a column value: a consumer must query with
    exactly the encoding the sketch was built with."""
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, str):
        return b"s" + v.encode("utf-8", "surrogateescape")
    if isinstance(v, (int, np.integer)):
        return b"i" + int(v).to_bytes(8, "little", signed=True)
    return b"f" + np.float64(v).tobytes()


@dataclass
class ColumnStats:
    hist: Histogram
    cms: CMSketch | None = None

    def equal_count(self, v) -> float:
        if self.cms is not None:
            return float(self.cms.query(cm_key(v)))
        return self.hist.equal_row_count(v)


# columns this long sort on the device (the JAX package's threshold)
_DEVICE_SORT_MIN = 1 << 17
_DEVICE_SORT_DTYPES = (np.dtype(np.int64), np.dtype(np.float64),
                       np.dtype(np.int32), np.dtype(np.float32))


def _device_sort(data: np.ndarray, device) -> np.ndarray:
    """Whole-column sort, the ANALYZE hot loop: a large numeric column
    sorts on `device`, a small one with numpy."""
    if len(data) >= _DEVICE_SORT_MIN and data.dtype in _DEVICE_SORT_DTYPES:
        from tidb_tpu_torch.ops.stats import device_sort
        return device_sort(data, device)
    return np.sort(data, kind="stable")


def _distinct_sorted(col, device) -> tuple[list, np.ndarray, int]:
    """(distinct values asc, counts, null_count) from a chunk Column."""
    valid = np.asarray(col.valid)
    null_count = int((~valid).sum())
    data = col.data[valid] if null_count else col.data
    if len(data) == 0:
        return [], np.empty(0, np.int64), null_count
    if data.dtype == np.dtype(object):   # strings: python sort
        vals: dict = {}
        for v in data:
            vals[v] = vals.get(v, 0) + 1
        keys = sorted(vals)
        return keys, np.array([vals[k] for k in keys], np.int64), null_count
    s = _device_sort(np.ascontiguousarray(data), device)
    edge = np.flatnonzero(s[1:] != s[:-1])
    starts = np.concatenate(([0], edge + 1))
    counts = np.diff(np.concatenate((starts, [len(s)])))
    return list(s[starts]), counts, null_count


def _column_stats(vals, counts, nulls: int, n_buckets: int) -> ColumnStats:
    hist = build_histogram(vals, counts, n_buckets, null_count=nulls)
    cms = CMSketch()
    for v, c in zip(vals, counts):
        cms.insert(cm_key(v), int(c))
    return ColumnStats(hist, cms)


def build_column_stats(col, n_buckets: int = DEFAULT_BUCKETS,
                       device=None) -> ColumnStats:
    """Histogram and CMSketch of one chunk Column. A numeric column of
    _DEVICE_SORT_MIN rows or more sorts on `device` (CUDA unless the
    caller asks for another; it raises where there is none)."""
    from tidb_tpu_torch.ops import runtime
    device = runtime.resolve_device(device)
    return _column_stats(*_distinct_sorted(col, device), n_buckets)
