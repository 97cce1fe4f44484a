"""Distributed group-by aggregation on the device plane.

The port of the JAX package's ops/meshagg.py. Every shard aggregates its
row shard locally (sort-based or direct group tables, exactly as
ops/hashagg.py does), the per-shard group tables are gathered over the
``"batch"`` axis, and the gathered tables are re-reduced into one merged
table, replicated: the host reads one copy. On a 1-shard plane the
gather is skipped and the program is the single-device kernel.

The reference's body calls its collectives in the middle of one traced
program (the pmax of the direct table's strides, the all_gathers of the
merge). With one controller driving every shard, the body is split at
each collective into per-shard stages: a stage runs on every shard's
device, the collective (devplane.all_gather / pmax) joins them, and the
next stage reads its result. The algorithm is the reference's:

  * local stage: group table (direct slots for dict-encoded keys, a
    runtime choice between direct slots and the packed sort for bare int
    keys — both with the plane-wide strides and spans —, the packed sort
    otherwise), then one `_SegBatch` for the header lanes and every
    aggregate, so each shard's int64 and float64 sum lanes go to
    ops/segsum (the hand-written kernel on CUDA);
  * direct merge: every shard shares one slot space, so the merge is an
    elementwise reduce over the gathered [ndev, C] tables;
  * hashed merge: `_group_table` over the tiled [ndev*C] keys, then the
    stacked lanes re-reduce per (merge-op, dtype): sums through
    ops/segsum, min and max through `_segment_minmax`.

`lax.pmax(local_tot)` becomes a max on the device after the gather, read
once at `finalize`, so the program never syncs with the host. Collision
and overflow semantics are the single-device kernel's: the dual 64-bit
hash detects key collisions, the true-distinct count detects capacity
overflow, and both raise so the caller can re-plan or fall back.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tidb_tpu_torch import devplane
from tidb_tpu_torch.chunk import Chunk
from tidb_tpu_torch.expression import AggDesc, Expression
from tidb_tpu_torch.ops import runtime, segsum, tnp
from tidb_tpu_torch.ops.hashagg import (_FILL, _I64_MAX, _I64_MIN,
                                        _SENTINEL_MASKED, CapacityError,
                                        CollisionError, GroupResult,
                                        _agg_requests, _columns_used,
                                        _cond_direct_mode,
                                        _direct_group_mode, _group_table,
                                        _hash_keys, _pack, _readback,
                                        _segment_minmax, _SegBatch,
                                        _validate_device_exprs,
                                        finalize_group_result)

__all__ = ["MeshAggKernel", "MeshKernelBase", "group_merge_program"]

_BIG = _I64_MAX
_SEED1 = 0x517CC1B727220A95
_SEED2 = 0x2545F4914F6CDD1D


def _plane_max(mesh, xs) -> list:
    """lax.pmax over the shards' values (the values themselves on a
    1-shard plane)."""
    return xs if len(xs) == 1 else devplane.pmax(xs, mesh)


# lint: exempt[dtype-discipline] group codes carry exact int64 key values (scaled decimals / epoch-micros exceed float range)
def _direct_tables(mesh, xps, group_exprs, cols, ln, masks, C) -> list:
    """Per-shard direct-indexed group tables -> [(uniq[C], inv int32,
    tot)]: the strides are plane-wide maxima, so every shard shares one
    slot space (hashagg._direct_group_table, with the reference's pmax
    between the evaluation and the combination)."""
    ndev = len(cols)
    combined = None
    for g in group_exprs:
        codes = []
        for i in range(ndev):
            d, v = g.eval_xp(xps[i], cols[i], ln)
            code = torch.where(v, d.to(torch.int64) + 1, 0)
            codes.append(torch.where(masks[i], code, 0))
        if combined is None:
            combined = codes
        else:
            m = _plane_max(mesh, [torch.amax(c) for c in codes])
            combined = [combined[i] * (m[i] + 1) + codes[i]
                        for i in range(ndev)]
    out = []
    for i in range(ndev):
        mask, comb = masks[i], combined[i]
        tot = torch.amax(torch.where(mask, comb, -1)) + 2
        slot = torch.clamp(comb, max=C - 2)
        inv = torch.where(mask, slot, C - 1)
        uniq = torch.full((C,), _FILL, dtype=torch.int64, device=mask.device)
        uniq.scatter_(0, inv, torch.where(mask, slot, _SENTINEL_MASKED))
        out.append((uniq, inv.to(torch.int32), tot))
    return out


# lint: exempt[dtype-discipline] exact int64 key codes + float64 span product (span overflow check must not round at 2^53)
def _cond_tables(mesh, xps, group_exprs, cols, ln, masks, hs, C) -> list:
    """Per-shard runtime-selected group tables (hashagg._cond_group_table)
    with the keys' minima, maxima and spans taken over the whole plane,
    so every shard agrees on the code space. Both branches run and a
    device-side select picks, as on one device."""
    ndev = len(cols)
    codes = [[] for _ in range(ndev)]
    spans, span_fs = [], []
    for g in group_exprs:
        ds, lives = [], []
        for i in range(ndev):
            d, v = g.eval_xp(xps[i], cols[i], ln)
            ds.append(d.to(torch.int64))
            lives.append(masks[i] & v)
        lo = [torch.amin(torch.where(lv, d, _I64_MAX))
              for d, lv in zip(ds, lives)]
        hi_raw = [torch.amax(torch.where(lv, d, _I64_MIN))
                  for d, lv in zip(ds, lives)]
        if ndev > 1:
            lo = [-x for x in devplane.pmax([-x for x in lo], mesh)]
            hi_raw = devplane.pmax(hi_raw, mesh)
        # NULL -> 0; live values -> 1.. (saturate when no live rows)
        code = [torch.where(lv, torch.clamp(d - lo[i], min=0) + 1, 0)
                for i, (d, lv) in enumerate(zip(ds, lives))]
        hi = _plane_max(mesh, [torch.amax(c) for c in code])
        for i in range(ndev):
            codes[i].append(code[i])
        spans.append([h + 1 for h in hi])
        # the smallness decision uses raw min/max in float64: the int64
        # code math wraps when the raw span exceeds 2^63
        span_fs.append([torch.clamp(hi_raw[i].to(torch.float64) -
                                    lo[i].to(torch.float64) + 2.0, min=1.0)
                        for i in range(ndev)])
    out = []
    for i in range(ndev):
        mask, h = masks[i], hs[i]
        span_prod = torch.prod(torch.stack([sf[i] for sf in span_fs]))
        small = span_prod <= float(C - 2)
        combined = codes[i][0]
        for c, s in zip(codes[i][1:], spans[1:]):
            combined = combined * s[i] + c
        d_tot = torch.amax(torch.where(mask, combined, -1)) + 2
        # the unselected direct branch's code math may have wrapped
        # negative: clamp into the table so its scatter stays in bounds
        d_inv = torch.where(mask, torch.clamp(combined, 0, C - 2), C - 1)
        # slot identity is the key-tuple hash, not the dense code: the
        # cross-shard re-unique merge keeps the hash mode's contract
        d_uniq = torch.full((C,), _FILL, dtype=torch.int64,
                            device=mask.device)
        d_uniq.scatter_(0, d_inv, torch.where(mask, h, _SENTINEL_MASKED))
        h_uniq, h_inv, h_tot = _group_table(h, ln, C, mask=mask)
        out.append((torch.where(small, d_uniq, h_uniq),
                    torch.where(small, d_inv.to(torch.int32), h_inv),
                    torch.where(small, d_tot, h_tot)))
    return out


# lint: exempt[dtype-discipline] int64 COUNT lane: exact past 2^53 rows, matches the agg-state stacking dtype
def _local_lanes(xp, cols, mask, ln, offs, inv, h2, aggs, C, row_ids):
    """One shard's lanes: one _SegBatch for the header lanes (count,
    check-hash min/max, representative row) and every aggregate.
    -> ([(array[C], merge_op)], [(start, width)] per aggregate)."""
    dev = mask.device
    mask_i = mask.to(torch.int64)
    arange = torch.arange(ln, dtype=torch.int64, device=dev)
    b = _SegBatch(inv, C)
    i_cnt = b.add(mask_i, "sum")
    i_h2min = b.add(torch.where(mask, h2, _I64_MAX), "min")
    i_h2max = b.add(torch.where(mask, h2, _I64_MIN), "max")
    if row_ids is not None:
        i_grep = b.add(torch.where(mask, row_ids, _BIG), "min")
    else:
        i_grep = b.add(torch.where(mask, arange, ln), "min")
    i_ghas = b.add(mask_i, "max")
    assembles = [_agg_requests(xp, a, cols, ln, mask, b, arange=arange,
                               offs=offs, row_ids=row_ids)
                 for a in aggs]
    b.run()
    lanes = [(b.get(i_cnt), "sum"), (b.get(i_h2min), "min"),
             (b.get(i_h2max), "max")]
    if row_ids is not None:
        lanes.append((b.get(i_grep), "min"))
    else:
        lanes.append((torch.where(b.get(i_ghas) > 0, offs + b.get(i_grep),
                                  _BIG), "min"))
    slices = []
    for assemble in assembles:
        ls = assemble(b.get)
        slices.append((len(lanes) - 4, len(ls)))
        lanes.extend(ls)
    return lanes, slices


def _outs(uniq, merged, slices, tot) -> tuple:
    cnt, h2min, h2max, rep = merged[:4]
    agg_out = tuple(tuple(merged[4 + s + i] for i in range(w))
                    for s, w in slices)
    return (uniq, cnt, h2min, h2max, rep, agg_out, tot)


def group_merge_program(mesh, cols, masks, ln, offs, group_exprs, aggs, C,
                        row_ids=None) -> list:
    """The shared plane program: per-shard group tables, gather over
    the ``"batch"`` axis, re-reduce. `cols[i]`, `masks[i]`, `offs[i]`
    (a python int: the shard's global row offset) and `row_ids[i]` are
    shard i's; `cols[i]` is any virtual column list (probe columns, or
    probe + gathered join payloads: ops/meshjoin.py), indexed by the
    expressions. row_ids (the global original probe row of each row)
    replaces offs + arange for the representative and FIRST_ROW lanes
    where rows were compacted. -> Replicas of the output tuple (uniq,
    cnt, h2min, h2max, rep, agg_out, tot), one per distinct device."""
    ndev = len(cols)
    xps = [tnp.on(m.device) for m in masks]
    rids = row_ids if row_ids is not None else [None] * ndev
    direct = _direct_group_mode(group_exprs)
    if direct:
        # dense dict codes index slots directly: no sort, no hash, no
        # collisions (h2 lanes are zeros so the check trivially passes)
        tables = _direct_tables(mesh, xps, group_exprs, cols, ln, masks, C)
        # lint: exempt[dtype-discipline] h2 lanes ride the int64 hash dtype (splitmix64 bit patterns)
        h2s = [torch.zeros(ln, dtype=torch.int64, device=m.device)
               for m in masks]
    else:
        hs, h2s = [], []
        for i in range(ndev):
            dev = masks[i].device
            with devplane.device_scope(dev):
                key_cols = [g.eval_xp(xps[i], cols[i], ln)
                            for g in group_exprs]
                hs.append(_hash_keys(key_cols, ln, _SEED1, dev))
                h2s.append(_hash_keys(key_cols, ln, _SEED2, dev))
        if _cond_direct_mode(group_exprs):
            # bare int/dict keys: a runtime range check picks direct
            # slots when the span fits, the packed-sort table otherwise
            tables = _cond_tables(mesh, xps, group_exprs, cols, ln, masks,
                                  hs, C)
        else:
            tables = [_group_table(hs[i], ln, C, mask=masks[i])
                      for i in range(ndev)]
    lanes, slices = [], None
    for i in range(ndev):
        with devplane.device_scope(masks[i].device):
            ls, slices = _local_lanes(xps[i], cols[i], masks[i], ln,
                                      offs[i], tables[i][1], h2s[i], aggs,
                                      C, rids[i])
        lanes.append(ls)
    if ndev == 1:
        # the local table already is the global table: no collective
        uniq, _inv, tot = tables[0]
        return devplane.Replicas(
            [_outs(uniq, [l for l, _op in lanes[0]], slices, tot)])
    ops = [op for _l, op in lanes[0]]
    local_tot = _plane_max(mesh, [t[2] for t in tables])
    if direct:
        # every shard shares one slot space: an elementwise reduce over
        # the gathered [ndev, C] tables, no re-unique
        gu = devplane.all_gather([t[0] for t in tables], mesh)
        gathered = [devplane.all_gather([ls[k][0] for ls in lanes], mesh)
                    for k in range(len(ops))]

        def merge_direct(gu, tot, *gl):
            muniq = torch.amin(gu, 0)   # FILL > real code > SENTINEL;
            # a slot live anywhere must not surface as masked-sentinel
            any_real = torch.amax(torch.where(gu == _SENTINEL_MASKED,
                                              _I64_MIN, gu), 0)
            muniq = torch.where((muniq == _SENTINEL_MASKED) &
                                (any_real != _I64_MIN) &
                                (any_real != _FILL), any_real, muniq)
            red = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}
            merged = [red[op](g, 0) for g, op in zip(gl, ops)]
            return _outs(muniq, merged, slices, tot)
        return devplane.per_device(merge_direct, mesh, gu, local_tot,
                                   *gathered)
    all_uniq = devplane.all_gather([t[0] for t in tables], mesh, tiled=True)
    # batched re-reduce: same-(op, dtype) lanes stacked, one gather and
    # one segment op per kind
    groups: dict = {}
    for k, (lane, op) in enumerate(lanes[0]):
        groups.setdefault((op, lane.dtype), []).append(k)
    kinds = list(groups.items())
    gathered = [devplane.all_gather(
        [torch.stack([ls[k][0] for k in idxs], 1) for ls in lanes], mesh,
        tiled=True) for (_op, _dt), idxs in kinds]

    def merge_hashed(all_uniq, ltot, *gs):
        muniq, minv, gtot = _group_table(all_uniq, ndev * C, C)
        # gathered fill/sentinel slots can add up to 2 phantom values to
        # gtot relative to a single table; they are excluded on the host
        # by the live mask, and capacity is checked with slack for them
        tot = torch.maximum(gtot, ltot)
        minv64 = None
        merged: list = [None] * len(ops)
        for ((op, _dt), idxs), g in zip(kinds, gs):
            if op == "sum":
                r = segsum.segment_sum(g, minv, C)
            else:
                if minv64 is None:
                    # lint: exempt[dtype-discipline] scatter_reduce (the MIN/MAX merge) takes int64 index tensors
                    minv64 = minv.to(torch.int64)
                r = _segment_minmax(g, minv64, C, op)
            for j, k in enumerate(idxs):
                merged[k] = r[:, j]
        return _outs(muniq, merged, slices, tot)
    return devplane.per_device(merge_hashed, mesh, all_uniq, local_tot,
                               *gathered)


class MeshKernelBase:
    """Shared plane plumbing: capacity sizing, the sharded probe upload,
    and the merged-table finalize (capacity and collision checks,
    live-group extraction)."""

    used: set = set()

    def _setup_sizes(self, mesh, capacity: int):
        self.mesh = mesh
        self.ndev = devplane.ndev(mesh)
        # internal table size = requested capacity + 2 headroom slots for
        # the masked-sentinel and fill phantoms (which count as
        # "distinct" but are never live groups)
        self.capacity = max(capacity, 1)
        self._C = self.capacity + 2

    def _setup_mesh(self, mesh, capacity: int):
        self._setup_sizes(mesh, capacity)
        self._jit = devplane.plane_jit(self._program)

    def _shard_len(self, n: int, bucket: bool) -> int:
        ln = -(-max(n, 1) // self.ndev)
        ln += (-ln) % 8
        return runtime.bucket_size(ln) if bucket else ln

    def _shard_probe(self, chunk: Chunk, bucket: bool = False):
        """-> (per-shard device column lists, padded shard length). The
        sharded transfer is memoized on the chunk (keyed by the plane's
        generation, the padded size and the shipped columns): cached
        storage chunks stay resident across re-executions. bucket=True
        pads the shard length to a power-of-two bucket so a stream of
        similar-sized super-batches reuses one shape."""
        n = chunk.num_rows
        ln = self._shard_len(n, bucket)
        # the generation (not id(plane)) keys the memo: a torn-down
        # plane's id can be recycled by a new one at the same address
        key = ("shard", devplane.mesh_generation(), ln * self.ndev,
               tuple(sorted(self.used)))
        hit = runtime.dev_cache_get(chunk, key)
        if hit is not None:
            return hit, ln
        lanes, _dicts = runtime.device_put_chunk(
            chunk, size=ln * self.ndev, used=self.used, to_device=False)
        cols = runtime.shard_put(lanes, n, ln, self.mesh)
        runtime.dev_cache_put(chunk, key, cols)
        return cols, ln

    def finalize(self, outs):
        """-> (gidx, rep_rows, lanes_at, counts) from the program's
        outputs, raising on capacity overflow or group-key hash collision.
        The kernel's one output boundary: the first replica's outputs
        are packed into one buffer and read back in one copy."""
        uniq, cnt, h2min, h2max, rep, agg_out, tot = \
            _readback(_pack(outs[0]))
        tot = int(tot[0])
        # tot counts the masked sentinel / fill phantoms; _C holds >= 2
        # headroom slots for them, so tot > _C means possible truncation
        if tot > self._C:
            err = CapacityError(
                f"distinct groups {tot} > capacity {self.capacity}")
            err.needed = tot    # executors re-plan with 2x this
            raise err
        live = (cnt > 0) & (uniq != _SENTINEL_MASKED) & (uniq != _FILL)
        if bool(np.any(live & (h2min != h2max))):
            raise CollisionError("group key hash collision")
        gidx = np.flatnonzero(live)
        rep_rows = rep[gidx]
        lanes_at = [[l[gidx] for l in ls] for ls in agg_out]
        return gidx, rep_rows, lanes_at, cnt[gidx]


class MeshAggKernel(MeshKernelBase):
    """Filter + group-by + aggregation, distributed over the ("batch",)
    device plane: per-shard local aggregation, a gather of the group
    tables across the batch axis, re-reduction to a replicated merged
    table. Columns stay separate tensors so int64 keys keep exact
    bits."""

    def __init__(self, mesh, filter_expr: Expression | None,
                 group_exprs: Sequence[Expression],
                 aggs: Sequence[AggDesc], capacity: int = 4096):
        self.filter_expr = filter_expr
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        _validate_device_exprs(filter_expr, self.group_exprs, self.aggs)
        self.used = _columns_used(filter_expr, self.group_exprs, self.aggs)
        self._setup_mesh(mesh, capacity)

    # -- plane program -------------------------------------------------------

    def _program(self, cols, ln: int, nrows: int):
        masks, offs = [], []
        for i, dev in enumerate(self.mesh.devices.flat):
            off = i * ln
            # lint: exempt[dtype-discipline] global row offsets are exact int64 (shard base can exceed int32 on big superchunks)
            alive = (off + torch.arange(ln, dtype=torch.int64,
                                        device=dev)) < nrows
            mask = runtime.filter_mask_xp(tnp.on(dev), self.filter_expr,
                                          cols[i], ln) & alive
            masks.append(mask)
            offs.append(off)
        return group_merge_program(self.mesh, cols, masks, ln, offs,
                                   self.group_exprs, self.aggs, self._C)

    # -- host side -----------------------------------------------------------

    def launch(self, chunk: Chunk, bucket: bool = False):
        """Asynchronous half: the sharded host->device transfer and the
        plane program, queued without a host sync, so the caller can
        overlap the next batch's transfer with this batch's readback
        (the pipeline_map streaming of executor/mesh.py)."""
        cols, ln = self._shard_probe(chunk, bucket=bucket)
        return self._jit(cols, ln, chunk.num_rows)

    def finish(self, outs, chunk: Chunk) -> GroupResult:
        """Blocking half: one batched device->host readback + host tail."""
        gidx, rep_rows, lanes_at, counts = self.finalize(outs)
        return finalize_group_result(chunk, self.group_exprs, self.aggs,
                                     gidx, rep_rows, lanes_at, counts)

    def __call__(self, chunk: Chunk) -> GroupResult:
        return self.finish(self.launch(chunk), chunk)
