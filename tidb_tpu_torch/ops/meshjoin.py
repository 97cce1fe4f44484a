"""Distributed star-join + aggregation on the device plane.

The port of the JAX package's ops/meshjoin.py. Q3/Q5-shaped plans run
as one program per probe shard:

    probe rows sharded over ("batch",)    [the fact table: lineitem]
    build tables replicated on every device [the dimension tables]
    filter -> lookup chain -> group-by aggregate -> gather merge

Each lookup is a bounded open-addressing probe against the dimension
table's packed hash slots plus an exact-bits verify; matched rows flow
straight into the aggregation (ops/meshagg.group_merge_program). Build
keys must be unique (dimension tables); the executor falls back to the
host join otherwise (`BuildError`).

The reference runs three compiled stages with a compaction between
them, reading one survivor-count scalar after each of the first two
(the bucket the next stage runs at); the port keeps those stages and
those two reads. Its probe is a `lax.while_loop` with a global early
exit (`~done.all()` in the condition); here it is a loop bounded by the
table's `probe_depth` over the `done` mask: rows that are done no
longer change, so the result is the same, and no `.all()` reads back to
the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from tidb_tpu_torch import devplane
from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.expression import AggDesc, AggFunc, Expression
from tidb_tpu_torch.ops import runtime, tnp
from tidb_tpu_torch.ops.hashagg import (_host_splitmix, _key_bits,
                                        _signed, _splitmix,
                                        _validate_device_exprs,
                                        finalize_group_result)
from tidb_tpu_torch.ops.meshagg import MeshKernelBase, group_merge_program

__all__ = ["LookupSpec", "MeshLookupAggKernel", "BuildError",
           "host_lookup_agg"]

_KEY_SEED = 0x9E6D55A3C1B70F27


def _host_key_bits(d: np.ndarray) -> np.ndarray:
    """uint64 bit pattern of a numpy key lane (floats bitcast, -0.0
    normalized), as the reference's `_key_bits(np, d)`."""
    d = np.asarray(d)
    if d.dtype == np.float64:
        return np.where(d == 0.0, 0.0, d).view(np.uint64)
    return d.astype(np.uint64)


def _lookup_hash_host(key_lanes, n: int) -> np.ndarray:
    """Join-key hash WITHOUT the NULL-validity lane of the group-key hash
    (build keys are NULL-free; NULL probe rows are masked by `hit & v`):
    numpy, bit-identical to the reference's `_lookup_hash(np, ...)`."""
    h = np.full(n, np.uint64(_KEY_SEED), dtype=np.uint64)
    for d, _v in key_lanes:
        h = _host_splitmix(h ^ _host_key_bits(d))
    return h.view(np.int64)


# lint: exempt[dtype-discipline] row hashes are int64 by contract (splitmix64 bit patterns, sentinel headroom)
def _lookup_hash(key_cols, n: int, device):
    """The torch twin of `_lookup_hash_host`, on the device."""
    h = torch.full((n,), _signed(_KEY_SEED), dtype=torch.int64,
                   device=device)
    for d, _v in key_cols:
        h = _splitmix(h ^ _key_bits(d))
    return h


class BuildError(Exception):
    """Build side unusable for the lookup kernel (dup/NULL keys, strings
    in key columns, hash collision): the caller falls back to the host
    join."""


@dataclass
class LookupSpec:
    """One dimension-table lookup in the chain.

    key_exprs index the CURRENT virtual schema (probe columns, then the
    payloads of earlier lookups, in order). build_key_offsets/payload
    offsets index build_chunk's columns; payload columns are appended to
    the virtual schema for later key_exprs / group_exprs / aggs."""

    key_exprs: list
    build_chunk: Chunk
    build_key_offsets: list[int]
    payload_offsets: list[int] = field(default_factory=list)


_EMPTY_SLOT = np.int64((1 << 63) - 1)   # the hashes never emit it


class _BuildTable:
    """Host-prepared replicated lookup table: an open-addressing hash
    table over the key hashes (load factor <= 0.25, linear probing with a
    KNOWN max displacement, so the device probe is a bounded gather
    chain), exact key bit lanes, payload lanes (strings dict-encoded for
    the device; original values kept for the host finalize)."""

    def __init__(self, spec: LookupSpec):
        ch = spec.build_chunk
        keys = [ch.columns[o] for o in spec.build_key_offsets]
        n = ch.num_rows
        valid = np.ones(n, dtype=bool)
        for k in keys:
            valid &= np.asarray(k.valid)
        if not valid.all():
            # NULL join keys never match anything: drop them here
            ch = ch.filter(valid)
            keys = [ch.columns[o] for o in spec.build_key_offsets]
            n = ch.num_rows
        key_lanes = []
        for k in keys:
            if k.data.dtype == np.dtype(object):
                raise BuildError("string build keys need the host join")
            key_lanes.append((np.asarray(k.data), np.ones(n, dtype=bool)))
        h = _lookup_hash_host(key_lanes, n)
        if n > 1:
            hs = np.sort(h)
            if (hs[1:] == hs[:-1]).any():
                # duplicate hash: either duplicate keys (not a dimension
                # table) or a 2^-64 collision; both go to the host join
                raise BuildError("duplicate build keys / hash collision")
        self.chunk = ch                         # NULL-free build rows
        self.n = n
        self._insert(h)
        self.key_bits = [_host_key_bits(d).view(np.int64)
                         for d, _v in key_lanes]
        self.pay_data = []
        self.pay_valid = []
        for o in spec.payload_offsets:
            c = ch.columns[o]
            d = np.asarray(c.data)
            if d.dtype == np.dtype(object):
                # lint: exempt[memtrack-alloc] build-side encode scratch bounded by the build rows the executor bills via device_scope at launch
                codes = np.empty(n, dtype=np.int64)
                seen: dict = {}
                for i, v in enumerate(d):
                    codes[i] = seen.setdefault(v, len(seen))
                d = codes
            self.pay_data.append(np.ascontiguousarray(d))
            self.pay_valid.append(np.ascontiguousarray(c.valid, dtype=bool))
        self._key_lanes = key_lanes
        self._row_by_key = None
        self._dev = None

    def _insert(self, h: np.ndarray) -> None:
        """Vectorized round-based insertion: round d places every pending
        key whose slot (base+d) is free, first writer per slot wins; the
        final round count bounds every key's displacement, so a lookup
        probes at most `probe_depth` slots. Slots PACK (quantized hash |
        row index) into one int64, one gather per probe step; the exact
        key-bits verify makes quantization merges harmless."""
        n = len(h)
        M = 1 << max(int(2 * max(n, 1) - 1).bit_length(), 4)
        bits = max(1, int(max(n, 1) - 1).bit_length()) if n > 1 else 1
        B = np.int64(bits)
        hq = (h >> B) << B
        slot_pack = np.full(M, _EMPTY_SLOT, dtype=np.int64)
        # reserve the empty marker's quantum so no packed value aliases it
        eq = (_EMPTY_SLOT >> B) << B
        hq = np.where(hq == eq, eq - (np.int64(1) << B), hq)
        if n > 1:
            sq = np.sort(hq)
            if (sq[1:] == sq[:-1]).any():
                # two build keys share a quantized hash: the probe's
                # first-match-wins walk could stop at the wrong slot
                raise BuildError("quantized hash collision")
        base = h & np.int64(M - 1)
        pending = np.arange(n)
        d = 0
        while pending.size:
            if d > 64:
                raise BuildError("pathological hash clustering")
            cand = (base[pending] + d) & (M - 1)
            empty = slot_pack[cand] == _EMPTY_SLOT
            marked = np.where(empty, cand, -1)
            uniq, first = np.unique(marked, return_index=True)
            win = np.zeros(len(pending), dtype=bool)
            win[first[uniq >= 0]] = True
            win &= empty
            wi = pending[win]
            slot_pack[cand[win]] = hq[wi] | wi
            pending = pending[~win]
            d += 1
        self.slot_pack = slot_pack
        self.hash_quantum_bits = bits
        self.table_size = M
        self.probe_depth = max(d, 1)

    @property
    def row_by_key(self) -> dict:
        """Host-side exact map for the finalize and the host fallback,
        keyed in the chunk-layer value domain. Built lazily: the device
        path only touches it for a handful of representative rows."""
        if self._row_by_key is None:
            m = {}
            for i in range(self.n):
                m[tuple(d[i].item() for d, _v in self._key_lanes)] = i
            self._row_by_key = m
        return self._row_by_key

    def nbytes(self) -> int:
        """Bytes of one device copy of the table's lanes."""
        return int(self.slot_pack.nbytes +
                   sum(a.nbytes for a in self.key_bits) +
                   sum(a.nbytes for a in self.pay_data) +
                   sum(a.nbytes for a in self.pay_valid))

    def device_arrays(self, mesh):
        """The table's lanes on every device of `mesh` (Replicas: one copy
        per distinct device), memoized: the first use uploads, a cached
        kernel re-executing against unchanged dimension data uploads
        nothing. Keyed by the plane's GENERATION."""
        key = devplane.mesh_generation()
        if self._dev is None or self._dev[0] != key:
            host = [self.slot_pack] + self.key_bits + self.pay_data
            nk, npay = len(self.key_bits), len(self.pay_data)

            def put(dev):
                ts = [torch.from_numpy(a).to(dev, non_blocking=True)
                      for a in host]
                vs = [torch.from_numpy(a).to(dev, non_blocking=True)
                      for a in self.pay_valid]
                return (ts[0], tuple(ts[1:1 + nk]),
                        tuple(ts[1 + nk:1 + nk + npay]), tuple(vs))
            self._dev = (key, devplane.replicate(put, mesh))
        return self._dev[1]


# lint: exempt[dtype-discipline] matched build row ids stay exact int64 (global offsets exceed int32)
def _probe_build(bt, b, key_cols, ph, mask, ln):
    """One build table's probe -> (hit, row): at most probe_depth packed
    gathers, a row that found its slot (or proved absence on an empty
    one) keeping its result."""
    slot_pack, key_bits, _pay_data, _pay_valid = b
    hit = mask
    for _d, v in key_cols:
        hit = hit & v                   # NULL keys match nothing
    dev = mask.device
    if bt.n == 0:
        return hit & False, torch.zeros(ln, dtype=torch.int64, device=dev)
    M1 = bt.table_size - 1
    B = bt.hash_quantum_bits
    Q = 1 << B
    eq = (int(_EMPTY_SLOT) >> B) << B
    phq = (ph >> B) << B
    phq = torch.where(phq == eq, eq - Q, phq)
    base = ph & M1
    row = torch.zeros(ln, dtype=torch.int64, device=dev)
    found = torch.zeros(ln, dtype=torch.bool, device=dev)
    done = torch.zeros(ln, dtype=torch.bool, device=dev)
    for j in range(bt.probe_depth):
        pk = slot_pack[(base + j) & M1]
        newhit = (~done) & (((pk >> B) << B) == phq)
        row = torch.where(newhit, pk & (Q - 1), row)
        found = found | newhit
        # an empty slot on the probe path proves absence
        done = done | newhit | (pk == int(_EMPTY_SLOT))
    hit = hit & found
    # exact verify: quantized-hash equality is not key equality
    for (d, _v), bb in zip(key_cols, key_bits):
        hit = hit & (_key_bits(d) == bb[row])
    return hit, row


def _lookup_step(xp, lk, bt, b, virt, mask, ln):
    """One lookup of the chain: probe + payload appends -> new mask."""
    _slot, _kb, pay_data, pay_valid = b
    key_cols = [e.eval_xp(xp, virt, ln) for e in lk.key_exprs]
    ph = _lookup_hash(key_cols, ln, mask.device)
    hit, row = _probe_build(bt, b, key_cols, ph, mask, ln)
    safe = torch.where(hit, row, 0)
    for d, v in zip(pay_data, pay_valid):
        virt.append((d[safe], v[safe] & hit))
    return hit


class MeshLookupAggKernel(MeshKernelBase):
    """filter -> unique-key lookup chain -> group-by agg over the device
    plane, in three stages with a compaction after each of the first two:

      stage 1: filter + FIRST lookup, then prefix-sum compaction of the
               surviving rows (the first lookup is usually the selective
               one: a filtered dimension kills most fact rows);
      stage 2: the remaining lookups, compacted again;
      stage 3: group-by agg over the compacted rows, padded to a
               power-of-two bucket sized by the chain's selectivity.

    Each compaction's plane-wide survivor maximum is read back once (one
    scalar) to size the next stage's bucket, as in the reference. The
    original probe row indices ride along as a column, so the
    representative-row finalize is unchanged."""

    def __init__(self, mesh, filter_expr: Expression | None,
                 lookups: Sequence[LookupSpec],
                 group_exprs: Sequence[Expression],
                 aggs: Sequence[AggDesc], capacity: int = 4096,
                 builds: list | None = None):
        self.mesh = mesh
        self.filter_expr = filter_expr
        self.lookups = list(lookups)
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        _validate_device_exprs(filter_expr, self.group_exprs, self.aggs)
        for lk in self.lookups:
            _validate_device_exprs(None, lk.key_exprs, [])
        self.builds = builds if builds is not None \
            else [_BuildTable(lk) for lk in self.lookups]
        self._setup_sizes(mesh, capacity)
        used: set = set()
        if filter_expr is not None:
            used |= filter_expr.columns_used()
        for e in list(self.group_exprs) + \
                [k for lk in self.lookups for k in lk.key_exprs]:
            used |= e.columns_used()
        for a in self.aggs:
            if a.arg is not None:
                used |= a.arg.columns_used()
        self._virt_used = used
        self._stage1 = devplane.plane_jit(self._stage1_fn)
        self._stage2 = devplane.plane_jit(self._stage2_fn)
        self._stage3 = devplane.plane_jit(self._stage3_fn)

    # -- plane stages --------------------------------------------------------

    @staticmethod
    # lint: exempt[dtype-discipline] compacted row ids stay exact int64 (global offsets exceed int32)
    def _compact(virt, mask, row_ids, ln):
        """Prefix-sum compaction of the surviving rows -> (compacted
        (data, valid) pairs, live flags, row ids, local survivor
        count). Unshipped (None) columns stay None."""
        dev = mask.device
        s_local = mask.sum()
        pos = torch.cumsum(mask.to(torch.int64), 0) - 1
        # dead rows scatter past the end (a dump slot, then dropped)
        idx = torch.where(mask, pos, ln)
        compacted = []
        for lane in virt:
            if lane is None:
                compacted.append(None)
                continue
            d, v = lane
            cd = torch.zeros(ln + 1, dtype=d.dtype, device=dev)
            cv = torch.zeros(ln + 1, dtype=torch.bool, device=dev)
            cd.scatter_(0, idx, d)
            cv.scatter_(0, idx, v)
            compacted.append((cd[:ln], cv[:ln]))
        live = torch.zeros(ln + 1, dtype=torch.bool, device=dev)
        live.scatter_(0, idx, mask)
        rid = torch.zeros(ln + 1, dtype=torch.int64, device=dev)
        rid.scatter_(0, idx, row_ids)
        return compacted, live[:ln], rid[:ln], s_local

    def _stage1_fn(self, cols, ln: int, nrows: int, builds):
        """filter + first lookup + compaction, per shard; -> per-shard
        results and the plane-wide survivor maximum."""
        outs = []
        for i, dev in enumerate(self.mesh.devices.flat):
            with devplane.device_scope(dev):
                xp = tnp.on(dev)
                off = i * ln
                # lint: exempt[dtype-discipline] global row offsets are exact int64 (shard base can exceed int32 on big superchunks)
                rows = off + torch.arange(ln, dtype=torch.int64, device=dev)
                mask = runtime.filter_mask_xp(xp, self.filter_expr, cols[i],
                                              ln) & (rows < nrows)
                virt = list(cols[i])
                mask = _lookup_step(xp, self.lookups[0], self.builds[0],
                                    builds[i][0], virt, mask, ln)
                outs.append(self._compact(virt, mask, rows, ln))
        return outs, self._smax(outs)

    def _stage2_fn(self, staged, bucket: int, builds):
        """The remaining lookups over the first `bucket` compacted rows,
        then compaction AGAIN: the chain's total selectivity shrinks the
        aggregation's input."""
        outs = []
        for i, dev in enumerate(self.mesh.devices.flat):
            with devplane.device_scope(dev):
                ccols, live, rid, _s = staged[i]
                virt = [None if c is None else (c[0][:bucket], c[1][:bucket])
                        for c in ccols]
                mask = live[:bucket]
                for lk, bt, bd in zip(self.lookups[1:], self.builds[1:],
                                      builds[i][1:]):
                    mask = _lookup_step(tnp.on(dev), lk, bt, bd, virt, mask,
                                        bucket)
                outs.append(self._compact(virt, mask, rid[:bucket], bucket))
        return outs, self._smax(outs)

    def _stage3_fn(self, staged, bucket: int):
        cols, masks, rids = [], [], []
        for ccols, live, rid, _s in staged:
            cols.append([None if c is None else (c[0][:bucket],
                                                 c[1][:bucket])
                         for c in ccols])
            masks.append(live[:bucket])
            rids.append(rid[:bucket])
        return group_merge_program(self.mesh, cols, masks, bucket,
                                   [0] * self.ndev, self.group_exprs,
                                   self.aggs, self._C, row_ids=rids)

    def _smax(self, outs):
        """The plane-wide max survivor count (lax.pmax), on the first
        shard's device."""
        s = [o[3] for o in outs]
        return s[0] if self.ndev == 1 else devplane.pmax(s, self.mesh)[0]

    # -- host side -----------------------------------------------------------

    @staticmethod
    def _bucket(s: int, ln: int) -> int:
        b = 8
        while b < s:
            b <<= 1
        return min(b, ln)

    def _probe_used(self, probe: Chunk) -> set:
        return {j for j in self._virt_used if j < probe.num_cols}

    def launch(self, probe: Chunk, bucket: bool = False):
        """Stage 1 (filter + first lookup + compact), one survivor-count
        read, stage 2 (remaining lookups + compact), one more, then stage
        3 (aggregation) on the chain-selectivity-sized bucket. Build
        tables are device-memoized (_BuildTable.device_arrays), so
        per-batch launches re-send nothing."""
        self.used = self._probe_used(probe)
        cols, ln = self._shard_probe(probe, bucket=bucket)
        builds = [tuple(t) for t in zip(*(b.device_arrays(self.mesh)
                                          for b in self.builds))]
        staged, smax = self._stage1(cols, ln, probe.num_rows, builds)
        bkt = self._bucket(int(smax), ln)
        if len(self.lookups) > 1:
            staged, smax2 = self._stage2(staged, bkt, builds)
            bkt = self._bucket(int(smax2), bkt)
        return self._stage3(staged, bkt)

    def finish(self, outs, probe: Chunk):
        gidx, rep_rows, lanes_at, counts = self.finalize(outs)
        return self._finalize(probe, gidx, rep_rows, lanes_at, counts)

    def __call__(self, probe: Chunk):
        return self.finish(self.launch(probe), probe)

    def _finalize(self, probe: Chunk, gidx, rep_rows, lanes_at, counts):
        """Re-run the lookup chain on the handful of representative rows
        (and FIRST_ROW rows) on the host, so group keys and first values
        come back as exact original values, strings included."""
        needed = set(int(r) for r in rep_rows)
        for a, ls in zip(self.aggs, lanes_at):
            if a.fn == AggFunc.FIRST_ROW:
                for i, has in zip(ls[0], ls[1]):
                    if has > 0:
                        needed.add(int(i))
        order = sorted(needed)
        pos = {g: i for i, g in enumerate(order)}
        mini = self._host_chain(probe.take(np.array(order, dtype=np.int64)))
        rep_local = np.array([pos[int(r)] for r in rep_rows],
                             dtype=np.int64)
        fixed_lanes = []
        for a, ls in zip(self.aggs, lanes_at):
            if a.fn == AggFunc.FIRST_ROW:
                idx = np.array([pos.get(int(i), 0) for i in ls[0]],
                               dtype=np.int64)
                fixed_lanes.append([idx, ls[1]])
            else:
                fixed_lanes.append(ls)
        return finalize_group_result(mini, self.group_exprs, self.aggs,
                                     gidx, rep_local, fixed_lanes, counts)

    def _host_chain(self, mini: Chunk) -> Chunk:
        """Append the payload columns for the (matched) mini rows on the
        host, with the original (undecoded) build values."""
        out_cols = list(mini.columns)
        for lk, b in zip(self.lookups, self.builds):
            virt = Chunk(out_cols)
            n = virt.num_rows
            keyvals = []
            for e in lk.key_exprs:
                d, v = e.eval(virt)
                keyvals.append([None if not v[i] else
                                (d[i].item() if hasattr(d[i], "item")
                                 else d[i]) for i in range(n)])
            rows = [b.row_by_key.get(tuple(kv[i] for kv in keyvals))
                    for i in range(n)]
            for o in lk.payload_offsets:
                src = b.chunk.columns[o]
                vals = [None if r is None else src.get(r) for r in rows]
                out_cols.append(Column.from_values(src.ft, vals))
        return Chunk(out_cols)


def host_lookup_agg(probe: Chunk, filter_expr, lookups: Sequence[LookupSpec],
                    group_exprs, aggs, builds=None):
    """Pure-host implementation: the ground truth of the tests and the
    per-batch fallback of the streaming plane path (which passes its
    prebuilt `builds`, so dimension tables are not rebuilt per batch)."""
    from tidb_tpu_torch.ops.hostagg import host_hash_agg
    mask = runtime.eval_filter_host(filter_expr, probe)
    ch = probe.filter(mask)
    if builds is None:
        builds = [_BuildTable(lk) for lk in lookups]
    cols = list(ch.columns)
    for lk, b in zip(lookups, builds):
        virt = Chunk(cols)
        n = virt.num_rows
        keyvals = []
        for e in lk.key_exprs:
            d, v = e.eval(virt)
            keyvals.append([None if not v[i] else
                            (d[i].item() if hasattr(d[i], "item") else d[i])
                            for i in range(n)])
        # lint: exempt[memtrack-alloc] host-fallback row gather bounded by the probe chunk the statement already tracks
        rows = np.empty(n, dtype=object)
        keep = np.zeros(n, dtype=bool)
        for i in range(n):
            r = b.row_by_key.get(tuple(kv[i] for kv in keyvals))
            rows[i] = r
            keep[i] = r is not None
        cols = [c.take(np.flatnonzero(keep)) for c in cols]
        matched = [int(r) for r in rows[keep]]
        for o in lk.payload_offsets:
            src = b.chunk.columns[o]
            cols.append(Column.from_values(
                src.ft, [src.get(r) for r in matched]))
    combined = Chunk(cols)
    return host_hash_agg(combined, None, group_exprs, aggs)
