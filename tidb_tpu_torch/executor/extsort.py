"""External (spill-to-disk) sort: the port of the JAX package's
executor/extsort.py (host numpy, billed to the port's memtrack).

* full rows spill to disk in RUNS, one .npy per fixed-width column (+
  bool validity); varlen (object) columns are dictionary-encoded at
  spill time, so only int64 codes hit disk and the value dictionary
  stays in memory
* the evaluated sort-key columns never spill: keys are a narrow slice of
  the row, and keeping them in memory lets the merge be ONE global
  np.lexsort over dense ranks instead of a per-row heap
* output streams in blocks: the global order is walked block by block,
  gathering rows from the memory-mapped runs, so peak row memory is
  O(run + block), not O(total)

The sorter bills the buffered rows and the in-memory run keys to its
tracker and registers a quota spill action: over
tidb_tpu_mem_quota_query it sheds its buffer to disk instead of
cancelling the statement. Runs go to a temporary directory under
TMPDIR, removed on close.
"""

from __future__ import annotations

import os
import tempfile
import threading

import numpy as np

from tidb_tpu_torch import memtrack
from tidb_tpu_torch.chunk import Chunk, Column

__all__ = ["SpillSorter", "order_from_keys"]


def order_from_keys(key_arrays, n: int) -> np.ndarray:
    """-> int64 permutation of n rows given [(data, valid, desc)] key
    columns. Dense-rank encoding (np.unique) makes DESC a negation that
    works for numerics and object columns alike; NULLs rank below every
    value (first asc / last desc, MySQL). np.lexsort is stable."""
    lex_keys = []
    for d, v, desc in key_arrays:
        d, v = np.asarray(d), np.asarray(v, dtype=bool)
        rank = np.full(n, -1, dtype=np.int64)
        if v.any():
            _u, inv = np.unique(d[v], return_inverse=True)
            rank[v] = inv
        lex_keys.append(-rank if desc else rank)
    if not lex_keys:
        return np.arange(n, dtype=np.int64)
    return np.lexsort(lex_keys[::-1]).astype(np.int64)


class _Run:
    """One spilled run: per-column .npy paths (data may be int64 codes
    for dict-encoded varlen columns) + validity paths + row count."""

    __slots__ = ("data_paths", "valid_paths", "n")

    def __init__(self, data_paths, valid_paths, n):
        self.data_paths = data_paths
        self.valid_paths = valid_paths
        self.n = n


class SpillSorter:
    """Accumulates chunks; spills full runs to disk past `run_rows`;
    yields the globally ordered rows in `block_rows` chunks.

    Key memory stays O(total keys); row memory stays O(run + block)."""

    def __init__(self, by, run_rows: int = 1 << 20,
                 block_rows: int = 1 << 16, tmpdir: str | None = None,
                 tracker=None):
        self.by = by                      # [(Expression, desc)]
        self.run_rows = run_rows
        self.block_rows = block_rows
        self._tmp = None
        self._tmpdir = tmpdir
        self._buf: list[Chunk] = []
        self._nbuf = 0
        self._runs: list[_Run] = []
        self._keys: list[list] = []       # per run/tail: [(data, valid)]
        self._fts = None
        # shared dictionaries for object columns (per column offset)
        self._dicts: dict[int, dict] = {}
        self._dict_vals: dict[int, list] = {}
        # memory accounting: buffered full rows + resident key arrays.
        # Spilling RELEASES the buffered-row bytes (they moved to disk)
        # and keeps only the narrow keys — the tracker visibly drops, the
        # whole point of a spill OOM action. The RLock serializes add()
        # against a quota-triggered spill arriving from another thread's
        # consume (a cop worker crossing the statement quota), and is
        # re-entrant because add()'s own consume may fire the action on
        # this very thread.
        self._tracker = tracker
        self._tracked_buf = 0
        self._tracked_keys = 0
        self._mu = threading.RLock()
        self._unregister = memtrack.register_spill(self._quota_spill) \
            if tracker is not None else (lambda: None)

    # -- build phase --------------------------------------------------------

    def add(self, chunk: Chunk) -> None:
        if chunk.num_rows == 0:
            return
        with self._mu:
            if self._fts is None:
                self._fts = [c.ft for c in chunk.columns]
            self._buf.append(chunk)
            self._nbuf += chunk.num_rows
            if self._tracker is not None:
                b = memtrack.chunk_bytes(chunk)
                self._tracked_buf += b
                self._tracker.consume(host=b)
            if self._nbuf >= self.run_rows:
                self._spill()

    def _quota_spill(self) -> None:
        """OOM spill action (memtrack quota chain): shed the buffered
        rows to disk early. Re-armed — fires again on later episodes."""
        with self._mu:
            if self._nbuf:
                self._spill()

    def _eval_keys(self, chunk: Chunk):
        out = []
        for e, _desc in self.by:
            d, v = e.eval(chunk)
            d = np.asarray(d)
            if e.ft.is_ci and d.dtype == np.dtype(object):
                from tidb_tpu_torch.sqltypes import fold_column
                d = fold_column(d)           # _ci ordering
            out.append((d, np.asarray(v, dtype=bool)))
        return out

    def _encode(self, j: int, col: Column) -> np.ndarray:
        """Dictionary-encode an object column for spilling."""
        mapping = self._dicts.setdefault(j, {})
        vals = self._dict_vals.setdefault(j, [])
        codes = np.empty(len(col.data), dtype=np.int64)
        for i, val in enumerate(col.data):
            if not col.valid[i]:
                codes[i] = 0
                continue
            code = mapping.get(val)
            if code is None:
                code = len(vals)
                mapping[val] = code
                vals.append(val)
            codes[i] = code
        return codes

    def _spill(self) -> None:
        whole = Chunk.concat_all(self._buf)
        self._buf, self._nbuf = [], 0
        if self._tracker is not None and self._tracked_buf:
            # rows move to disk: credit the buffer back so the quota sees
            # the spill actually freeing memory
            self._tracker.release(host=self._tracked_buf)
            self._tracked_buf = 0
        if whole is None or whole.num_rows == 0:
            return
        if self._tmp is None:
            self._tmp = tempfile.TemporaryDirectory(
                prefix="tidbtpu-sort-", dir=self._tmpdir)
        keys = self._eval_keys(whole)
        self._keys.append(keys)
        if self._tracker is not None:
            kb = sum((8 * len(d) if d.dtype == object else d.nbytes)
                     + v.nbytes for d, v in keys)
            self._tracked_keys += kb
            self._tracker.consume(host=kb)
        rid = len(self._runs)
        dpaths, vpaths = [], []
        for j, col in enumerate(whole.columns):
            data = self._encode(j, col) if col.data.dtype == object \
                else col.data
            dp = os.path.join(self._tmp.name, f"r{rid}c{j}.npy")
            vp = os.path.join(self._tmp.name, f"r{rid}c{j}v.npy")
            np.save(dp, data, allow_pickle=False)
            np.save(vp, col.valid, allow_pickle=False)
            dpaths.append(dp)
            vpaths.append(vp)
        self._runs.append(_Run(dpaths, vpaths, whole.num_rows))

    # -- output phase -------------------------------------------------------

    @property
    def spilled(self) -> bool:
        return bool(self._runs)

    @property
    def spilled_runs(self) -> int:
        """Runs written to disk so far."""
        return len(self._runs)

    def sorted_chunks(self):
        """Yield the accumulated rows in global sort order."""
        try:
            with self._mu:
                # drain the buffer ATOMICALLY against a quota spill from
                # another thread's consume: once _nbuf is zero the spill
                # action no-ops, so the tail can never be both spilled
                # to a run and kept in memory (double rows), and
                # _tracked_buf keeps covering the resident tail until
                # close() releases it
                tail = Chunk.concat_all(self._buf)
                self._buf, self._nbuf = [], 0
            if not self._runs:
                if tail is not None and tail.num_rows:
                    order = order_from_keys(
                        [(d, v, desc) for (d, v), (_e, desc) in
                         zip(self._eval_keys(tail), self.by)],
                        tail.num_rows)
                    yield tail.take(order)
                return
            if tail is not None and tail.num_rows:
                self._keys.append(self._eval_keys(tail))
            # global order over concatenated keys (runs in spill order,
            # then the in-memory tail)
            total = sum(r.n for r in self._runs) + \
                (tail.num_rows if tail is not None else 0)
            key_arrays = []
            for ki, (_e, desc) in enumerate(self.by):
                d = np.concatenate([ks[ki][0] for ks in self._keys])
                v = np.concatenate([ks[ki][1] for ks in self._keys])
                key_arrays.append((d, v, desc))
            self._keys = []
            order = order_from_keys(key_arrays, total)
            del key_arrays
            offs = np.cumsum([0] + [r.n for r in self._runs])
            mms = [[np.load(p, mmap_mode="r") for p in r.data_paths]
                   for r in self._runs]
            vmms = [[np.load(p, mmap_mode="r") for p in r.valid_paths]
                    for r in self._runs]
            ncols = len(self._fts)
            from tidb_tpu_torch.sqltypes import np_dtype_for
            dtypes = [np_dtype_for(ft.tp, ft.flen) for ft in self._fts]
            is_obj = [dt == np.dtype(object) for dt in dtypes]
            nruns = len(self._runs)
            for s in range(0, total, self.block_rows):
                idx = order[s:s + self.block_rows]
                bn = len(idx)
                out_data = [np.empty(bn, dtype=dt) if not o
                            else np.full(bn, "", dtype=object)
                            for dt, o in zip(dtypes, is_obj)]
                out_valid = [np.empty(bn, dtype=bool) for _ in range(ncols)]
                src_run = np.clip(
                    np.searchsorted(offs, idx, side="right") - 1,
                    0, nruns)   # == nruns -> the in-memory tail
                for r in range(nruns + 1):
                    sel = np.flatnonzero(src_run == r)
                    if not len(sel):
                        continue
                    if r < nruns:
                        local = idx[sel] - offs[r]
                        for j in range(ncols):
                            dv = np.asarray(mms[r][j][local])
                            vv = np.asarray(vmms[r][j][local])
                            if is_obj[j]:
                                vals = self._dict_vals.get(j, [])
                                out_data[j][sel] = [
                                    vals[c] if vb and vals else ""
                                    for c, vb in zip(dv, vv)]
                            else:
                                out_data[j][sel] = dv
                            out_valid[j][sel] = vv
                    else:
                        local = idx[sel] - offs[-1]
                        for j in range(ncols):
                            c = tail.columns[j]
                            out_data[j][sel] = c.data[local]
                            out_valid[j][sel] = c.valid[local]
                cols = []
                for j, ft in enumerate(self._fts):
                    d = out_data[j]
                    if is_obj[j]:
                        d[~out_valid[j]] = ""
                    cols.append(Column(ft, d, out_valid[j]))
                yield Chunk(cols)
        finally:
            self.close()

    def close(self) -> None:
        self._unregister()
        if self._tracker is not None and \
                (self._tracked_buf or self._tracked_keys):
            self._tracker.release(
                host=self._tracked_buf + self._tracked_keys)
            self._tracked_buf = self._tracked_keys = 0
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None
