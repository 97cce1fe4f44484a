"""CBO statistics: equi-depth histograms, count-min sketch, selectivity.

Reference: TiDB's statistics/ — Histogram (histogram.go:39),
CMSketch (cmsketch.go:30), table stats (table.go:46), Handle with
lease-based reload (handle.go:32,106), session delta collection
(update.go:53), selectivity estimation (selectivity.go:30).

The port's copy of the JAX package's statistics module. The reference
builds histograms by merging per-region sample collectors row-at-a-time.
Here ANALYZE scans the table through the normal coprocessor path into
columnar chunks and builds each histogram from a whole-column sort: a
numeric column of `_DEVICE_SORT_MIN` rows or more sorts on the device
(ops/stats.device_sort, one torch.sort), a smaller one with numpy.
`build_column_stats` takes the device; `analyze_table` sorts on the
storage's. Estimation stays host-side: the planner is host control-plane
code. The CMSketch also serves the hybrid join's heavy-hitter detection
(ops/hybrid.py).

Persistence follows the reference's mysql.stats_* tables in spirit: stats
serialize to one JSON blob per table under a meta key (m_stats/<id>), so
a fresh Domain on the same store recovers them (handle.Update analogue).
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
from bisect import bisect_left
from dataclasses import dataclass, field

import numpy as np

from tidb_tpu_torch import codec, ranger, tablecodec
from tidb_tpu_torch.schema.model import IndexInfo, TableInfo
from tidb_tpu_torch.sqltypes import EvalType

__all__ = ["Histogram", "CMSketch", "ColumnStats", "IndexStats",
           "TableStats", "StatsHandle", "build_histogram",
           "build_column_stats", "analyze_table", "selectivity",
           "cm_key", "PSEUDO_ROW_COUNT", "SELECTION_FACTOR", "CM_DEPTH",
           "CM_WIDTH", "DEFAULT_BUCKETS"]

# Pseudo-stats rates; ref: statistics/table.go pseudo estimation constants.
PSEUDO_ROW_COUNT = 10000
PSEUDO_EQUAL_RATE = 1000     # eq selects 1/1000
PSEUDO_LESS_RATE = 3         # < selects 1/3
PSEUDO_BETWEEN_RATE = 40     # between selects 1/40
SELECTION_FACTOR = 0.8       # default filter selectivity (plan/task.go)

DEFAULT_BUCKETS = 256
CM_DEPTH = 4
CM_WIDTH = 2048
MAX_SAMPLE = 100_000         # index-key encoding sample cap


# ---------------------------------------------------------------------------
# value domain: histogram bounds must be comparable + interpolatable.
# Numeric columns use float keys; strings/bytes use their raw value with
# byte-prefix interpolation.


def _bytes_frac(v: bytes, lo: bytes, hi: bytes) -> float:
    """Position of v in [lo, hi) by 8-byte window after the common prefix."""
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
    """Equi-depth histogram (ref: statistics/histogram.go:39). Buckets are
    parallel lists; counts are cumulative row counts through each bucket;
    repeats count occurrences of each bucket's upper bound."""

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
        """Estimated rows strictly < v (ref: histogram.go lessRowCount)."""
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

    # -- serialization -------------------------------------------------------

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
        import base64
        return {"b": base64.b64encode(bytes(v)).decode()}
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def _val_from_obj(o):
    if isinstance(o, dict) and "b" in o:
        import base64
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
    """Count-min sketch for point frequency (ref: statistics/cmsketch.go:30).
    Inserted per *distinct* value with its count (we see the whole column at
    ANALYZE time, unlike the reference's streaming sampler)."""

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
        vals = [int(self.table[i, p])
                for i, p in enumerate(self._positions(key))]
        return min(vals)

    def to_obj(self):
        import base64
        return {"depth": self.depth, "width": self.width, "count": self.count,
                "table": base64.b64encode(
                    self.table.astype("<i8").tobytes()).decode()}

    @staticmethod
    def from_obj(o) -> "CMSketch":
        import base64
        cm = CMSketch(o["depth"], o["width"])
        cm.count = o["count"]
        cm.table = np.frombuffer(
            base64.b64decode(o["table"]), dtype="<i8").reshape(
                o["depth"], o["width"]).copy()
        return cm


def _cm_key(v) -> bytes:
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, str):
        return b"s" + v.encode("utf-8", "surrogateescape")
    if isinstance(v, (int, np.integer)):
        return b"i" + int(v).to_bytes(8, "little", signed=True)
    return b"f" + np.float64(v).tobytes()


def cm_key(v) -> bytes:
    """Public CMSketch key encoding for a column value — external
    consumers (the hybrid join's heavy-hitter seeding) must query with
    EXACTLY the encoding ANALYZE inserted with."""
    return _cm_key(v)


@dataclass
class ColumnStats:
    hist: Histogram
    cms: CMSketch | None = None

    def equal_count(self, v) -> float:
        if self.cms is not None:
            return float(self.cms.query(_cm_key(v)))
        return self.hist.equal_row_count(v)


@dataclass
class IndexStats:
    """Histogram over memcomparable-encoded index keys: multi-column range
    estimation reduces to a byte-range query (the reference keeps index
    hists over encoded keys too, statistics/histogram.go index path)."""

    hist: Histogram
    cms: CMSketch | None = None

    def ranges_row_count(self, index_ranges) -> float:
        """index_ranges: KVRange list with the index prefix stripped."""
        total = 0.0
        for r in index_ranges:
            total += self.hist.between_row_count(r.start, r.end)
        return total


@dataclass
class TableStats:
    """Per-table stats (ref: statistics/table.go:46)."""

    table_id: int
    version: int = 0            # analyze ts
    count: int = PSEUDO_ROW_COUNT
    modify_count: int = 0
    columns: dict = field(default_factory=dict)   # col_id -> ColumnStats
    indexes: dict = field(default_factory=dict)   # idx_id -> IndexStats
    pseudo: bool = True

    # -- estimation ----------------------------------------------------------

    def col_ranges_row_count(self, col_id: int,
                             ranges: list[ranger.DatumRange]) -> float:
        cs = self.columns.get(col_id)
        total = 0.0
        for r in ranges:
            lo = r.low[0] if r.low and not r.low_unbounded else None
            hi = r.high[0] if r.high and not r.high_unbounded else None
            # IS NULL point range ([None],[None]): answered by null_count,
            # not the histogram (NULLs are excluded from it)
            if lo is None and hi is None and r.low and r.high and \
                    not r.low_unbounded and not r.high_unbounded:
                if cs is None or self.pseudo:
                    total += self.count / PSEUDO_EQUAL_RATE
                else:
                    total += float(cs.hist.null_count)
                continue
            # decimal datums are (frac, scaled) with the column's frac;
            # column histograms store the scaled int (the chunk layout)
            if isinstance(lo, tuple):
                lo = lo[1]
            if isinstance(hi, tuple):
                hi = hi[1]
            if cs is None or self.pseudo:
                total += self._pseudo_range(lo, hi)
                continue
            try:
                if lo is not None and lo == hi and r.low_incl and \
                        r.high_incl:
                    total += cs.equal_count(lo)
                else:
                    total += cs.hist.between_row_count(
                        lo, hi, r.low_incl, r.high_incl)
            except TypeError:   # incomparable datum vs histogram domain
                total += self._pseudo_range(lo, hi)
        return min(float(self.count), total)

    def index_ranges_row_count(self, idx: IndexInfo,
                               ranges: list[ranger.DatumRange]) -> float:
        st = self.indexes.get(idx.id)
        if st is not None and not self.pseudo:
            kvr = ranger.index_ranges_to_kv(0, 0, ranges)
            strip = len(tablecodec.index_prefix(0, 0))
            stripped = [type(r)(r.start[strip:], r.end[strip:]) for r in kvr]
            return min(float(self.count), st.ranges_row_count(stripped))
        total = 0.0
        for r in ranges:
            sel = 1.0
            for i in range(max(len(r.low), len(r.high))):
                lo = r.low[i] if i < len(r.low) else None
                hi = r.high[i] if i < len(r.high) else None
                sel *= self._pseudo_range(lo, hi) / max(1, self.count)
            total += sel * self.count
        return min(float(self.count), total)

    def _pseudo_range(self, lo, hi) -> float:
        if lo is not None and lo == hi:
            return self.count / PSEUDO_EQUAL_RATE
        if lo is not None and hi is not None:
            return self.count / PSEUDO_BETWEEN_RATE
        if lo is None and hi is None:
            return float(self.count)
        return self.count / PSEUDO_LESS_RATE

    # -- serialization -------------------------------------------------------

    def to_blob(self) -> bytes:
        o = {"table_id": self.table_id, "version": self.version,
             "count": self.count, "modify_count": self.modify_count,
             "columns": {str(k): {"hist": v.hist.to_obj(),
                                  "cms": v.cms.to_obj() if v.cms else None}
                         for k, v in self.columns.items()},
             "indexes": {str(k): {"hist": v.hist.to_obj(),
                                  "cms": v.cms.to_obj() if v.cms else None}
                         for k, v in self.indexes.items()}}
        return json.dumps(o).encode()

    @staticmethod
    def from_blob(blob: bytes) -> "TableStats":
        o = json.loads(blob)
        ts = TableStats(table_id=o["table_id"], version=o["version"],
                        count=o["count"], modify_count=o["modify_count"],
                        pseudo=False)
        for k, v in o["columns"].items():
            ts.columns[int(k)] = ColumnStats(
                Histogram.from_obj(v["hist"]),
                CMSketch.from_obj(v["cms"]) if v["cms"] else None)
        for k, v in o["indexes"].items():
            ts.indexes[int(k)] = IndexStats(
                Histogram.from_obj(v["hist"]),
                CMSketch.from_obj(v["cms"]) if v["cms"] else None)
        return ts


# ---------------------------------------------------------------------------
# building stats from data


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


def build_column_stats(col, n_buckets: int = DEFAULT_BUCKETS,
                       device=None) -> ColumnStats:
    """Histogram and CMSketch of one chunk Column. A numeric column of
    _DEVICE_SORT_MIN rows or more sorts on `device` (CUDA unless the
    caller asks for another; it raises where there is none)."""
    from tidb_tpu_torch.ops import runtime
    device = runtime.resolve_device(device)
    vals, counts, nulls = _distinct_sorted(col, device)
    hist = build_histogram(vals, counts, n_buckets, null_count=nulls)
    cms = CMSketch()
    for v, c in zip(vals, counts):
        cms.insert(_cm_key(v), int(c))
    return ColumnStats(hist, cms)


def _kv_datum(col, row: int):
    """Raw chunk value -> KV-layer datum matching what ranger's
    _exact_datum produces for plan-time range bounds: ints/floats as
    Python scalars, decimals as (column_frac, scaled), strings as-is."""
    if not col.valid[row]:
        return None
    v = col.data[row]
    et = col.ft.eval_type
    if et == EvalType.DECIMAL:
        return (col.ft.frac, int(v))
    if et in (EvalType.INT, EvalType.DATETIME):
        return int(v)
    if et == EvalType.REAL:
        return float(v)
    return v


def _index_key_stats(chunk_cols_rows, n_buckets: int) -> IndexStats:
    """chunk_cols_rows: iterable of per-row datum tuples for the index
    columns (kv-layer values)."""
    vals: dict = {}
    for row in chunk_cols_rows:
        try:
            k = codec.encode_key(row)
        except Exception:
            continue
        vals[k] = vals.get(k, 0) + 1
    keys = sorted(vals)
    counts = np.array([vals[k] for k in keys], np.int64) if keys \
        else np.empty(0, np.int64)
    hist = build_histogram(keys, counts, n_buckets)
    cms = CMSketch()
    for k in keys:
        cms.insert(k, int(vals[k]))
    return IndexStats(hist, cms)


def analyze_table(storage, read_ts: int, info: TableInfo,
                  n_buckets: int = DEFAULT_BUCKETS) -> TableStats:
    """Full-scan ANALYZE (ref: executor/analyze.go:42 AnalyzeExec; sample
    collection mocktikv/analyze.go). Reads the table through the normal
    coprocessor fan-out, then builds per-column and per-index stats; a
    large numeric column sorts on the storage's device."""
    from tidb_tpu_torch.executor import ExecContext
    from tidb_tpu_torch.executor.reader import TableReader
    from tidb_tpu_torch.plan.physical import CopPlan

    cols = info.public_columns()
    cop = CopPlan(table=info, cols=list(cols))
    reader = TableReader(cop)
    ctx = ExecContext(storage.device, storage=storage, read_ts=read_ts)

    parts = []
    total = 0
    for ch in reader.chunks(ctx):
        parts.append(ch)
        total += ch.num_rows

    ts = TableStats(table_id=info.id, version=read_ts, count=total,
                    pseudo=False)
    from tidb_tpu_torch.chunk import Column
    for ci, cinfo in enumerate(cols):
        # concatenate once, one whole-column sort (device for big numerics)
        if parts:
            whole = Column(
                cinfo.ft,
                np.concatenate([ch.columns[ci].data for ch in parts]),
                np.concatenate([np.asarray(ch.columns[ci].valid)
                                for ch in parts]))
        else:
            whole = Column.empty(cinfo.ft)
        vals, counts, nulls = _distinct_sorted(whole, storage.device)
        keys = [v.item() if hasattr(v, "item") else v for v in vals]
        hist = build_histogram(keys, counts, n_buckets, null_count=nulls)
        cms = CMSketch()
        for k, c in zip(keys, counts):
            cms.insert(_cm_key(k), int(c))
        ts.columns[cinfo.id] = ColumnStats(hist, cms)

    # index stats over encoded keys (sampled above MAX_SAMPLE rows)
    from tidb_tpu_torch.schema.model import SchemaState
    name_to_off = {c.name.lower(): i for i, c in enumerate(cols)}
    for idx in info.indexes:
        if idx.state != SchemaState.PUBLIC:
            continue
        offs = [name_to_off[c.lower()] for c in idx.columns
                if c.lower() in name_to_off]
        if len(offs) != len(idx.columns):
            continue
        step = max(1, total // MAX_SAMPLE)

        def rows():
            for ch in parts:
                ccols = [ch.columns[o] for o in offs]
                for r in range(0, ch.num_rows, step):
                    yield tuple(_kv_datum(c, r) for c in ccols)

        st = _index_key_stats(rows(), n_buckets)
        if step > 1:   # scale sampled counts back to table size
            st.hist.total *= step
            st.hist.counts = [c * step for c in st.hist.counts]
            st.hist.repeats = [c * step for c in st.hist.repeats]
            if st.cms is not None:
                st.cms.table *= step
                st.cms.count *= step
        ts.indexes[idx.id] = st
    return ts


# ---------------------------------------------------------------------------
# selectivity


def _expr_col_offsets(e) -> set:
    return e.columns_used()


def selectivity(ts: TableStats, conjuncts, schema_cols, info: TableInfo
                ) -> float:
    """Combined selectivity of the conjuncts (ref: selectivity.go:30).
    Single-column conjuncts estimate through that column's histogram via
    ranger; the rest contribute the default SELECTION_FACTOR each
    (capped), combined under independence."""
    if not conjuncts:
        return 1.0
    count = max(1, ts.count)
    name_to_col = {c.name.lower(): c for c in info.columns}
    sel = 1.0
    defaults = 0
    for e in conjuncts:
        offs = _expr_col_offsets(e)
        done = False
        if len(offs) == 1:
            off = next(iter(offs))
            if off < len(schema_cols):
                sc = schema_cols[off]
                cinfo = name_to_col.get(sc.name.lower())
                if cinfo is not None:
                    path = ranger.detach_index_conditions(
                        [e], [off], [sc.ft])
                    if path.useful and path.ranges is not None:
                        rows = ts.col_ranges_row_count(cinfo.id, path.ranges)
                        sel *= max(rows, 0.0) / count
                        done = True
        if not done:
            defaults += 1
    sel *= SELECTION_FACTOR ** min(defaults, 3)
    return max(sel, 1.0 / count)


# ---------------------------------------------------------------------------
# handle


_STATS_PREFIX = b"m_stats/"


def _stats_key(table_id: int) -> bytes:
    return _STATS_PREFIX + b"%020d" % table_id


class StatsHandle:
    """Stats cache + persistence + DML delta collection (ref:
    statistics/handle.go:32; update.go:53 SessionStatsCollector)."""

    AUTO_ANALYZE_RATIO = 0.5

    def __init__(self, storage):
        self.storage = storage
        self._cache: dict[int, TableStats] = {}
        self._deltas: dict[int, int] = {}
        self.version = 0     # bumped on save/drop; part of plan-cache keys
        # serializes histogram feedback writers (executor threads)
        self._fb_mu = threading.Lock()

    def get(self, table_id: int) -> TableStats:
        ts = self._cache.get(table_id)
        if ts is None:
            ts = self._load(table_id)
            if ts is None:
                ts = TableStats(table_id=table_id)
            self._cache[table_id] = ts
        return ts

    def modify_count(self, table_id: int) -> int:
        """Persisted modify count plus this handle's pending DML delta."""
        return self.get(table_id).modify_count + \
            self._deltas.get(table_id, 0)

    def _load(self, table_id: int) -> TableStats | None:
        txn = self.storage.begin()
        try:
            raw = txn.get(_stats_key(table_id))
            return TableStats.from_blob(raw) if raw else None
        finally:
            txn.rollback()

    def save(self, ts: TableStats) -> None:
        txn = self.storage.begin()
        try:
            txn.set(_stats_key(ts.table_id), ts.to_blob())
            txn.commit()
        except Exception:
            txn.rollback()
            raise
        self._deltas.pop(ts.table_id, None)
        self._cache[ts.table_id] = ts
        self.version += 1

    def drop(self, table_id: int) -> None:
        txn = self.storage.begin()
        try:
            txn.delete(_stats_key(table_id))
            txn.commit()
        except Exception:
            txn.rollback()
            raise
        self._cache.pop(table_id, None)
        self._deltas.pop(table_id, None)
        self.version += 1

    def invalidate(self) -> None:
        self._cache.clear()

    # -- DML deltas ----------------------------------------------------------

    def note_dml(self, table_id: int, modified: int) -> None:
        if modified:
            self._deltas[table_id] = self._deltas.get(table_id, 0) + modified

    def need_auto_analyze(self, table_id: int) -> bool:
        ts = self._cache.get(table_id)
        if ts is None or ts.pseudo:
            return self._deltas.get(table_id, 0) > 0
        base = max(1, ts.count)
        return self._deltas.get(table_id, 0) / base >= \
            self.AUTO_ANALYZE_RATIO

    def pending_tables(self) -> list[int]:
        """Table ids with uncollected DML deltas (auto-analyze candidates,
        ref: statistics/update.go:135 + handle.go auto-analyze tick).
        Loads persisted stats first so a fresh process doesn't full-
        analyze a huge table over a one-row delta."""
        out = []
        for tid in list(self._deltas):
            self.get(tid)   # populate _cache from storage if persisted
            if self.need_auto_analyze(tid):
                out.append(tid)
        return out

    # -- query feedback (ref: statistics/update.go:88 QueryFeedback) ---------

    FEEDBACK_MIN_FACTOR = 0.2
    FEEDBACK_MAX_FACTOR = 5.0
    FEEDBACK_DEADBAND = 0.25   # |factor-1| below this: estimate is fine

    def feedback_range(self, table_id: int, col_id: int, dranges,
                       actual: int) -> None:
        """A pure range scan observed `actual` rows where the histogram
        estimated otherwise: rescale the overlapped buckets so future
        estimates track reality. In-memory only (like the reference's
        feedback before its periodic dump); version-bumped so cached
        plans re-cost."""
        ts = self._cache.get(table_id)
        if ts is None or ts.pseudo:
            return
        cs = ts.columns.get(col_id)
        if cs is None or not cs.hist.uppers:
            return
        with self._fb_mu:   # one feedback writer at a time
            est = ts.col_ranges_row_count(col_id, dranges)
            factor = (actual + 1.0) / (est + 1.0)
            factor = min(self.FEEDBACK_MAX_FACTOR,
                         max(self.FEEDBACK_MIN_FACTOR, factor))
            if abs(factor - 1.0) < self.FEEDBACK_DEADBAND:
                return
            hist = cs.hist
            touched = set()
            for r in dranges:
                lo = r.low[0] if r.low and not r.low_unbounded else None
                hi = r.high[0] if r.high and not r.high_unbounded else None
                if isinstance(lo, tuple):
                    lo = lo[1]
                if isinstance(hi, tuple):
                    hi = hi[1]
                i0 = 0 if lo is None else hist._locate(lo)
                i1 = hist.num_buckets - 1 if hi is None \
                    else hist._locate(hi)
                for i in range(max(0, i0),
                               min(hist.num_buckets - 1, i1) + 1):
                    touched.add(i)
            if not touched:
                return
            incr = [hist._bucket_count(i) for i in range(hist.num_buckets)]
            new_repeats = list(hist.repeats)
            for i in touched:
                incr[i] = int(round(incr[i] * factor))
                new_repeats[i] = int(round(new_repeats[i] * factor))
            new_counts = []
            run = 0
            for v in incr:
                run += v
                new_counts.append(run)
            # build-then-swap: concurrent READERS always see internally
            # consistent (monotonic) arrays
            hist.repeats = new_repeats
            hist.counts = new_counts
            hist.total = run
            self.version += 1
