"""Stream (sorted-input) aggregation on the device: segment-reduce.

The port of the JAX package's ops/streamagg.py. The input chunk arrives
with equal group keys adjacent (the caller's contract: a sort below, or
an order-preserving source); no hash table, no capacity protocol, no
collision path:

    1. adjacent-row bit compares of the key lanes (and their validity)
       mark segment starts; padding rows open no segment, and a cumsum
       turns the boundary mask into dense int32 segment ids
    2. every aggregate reduces into per-segment lanes with num_segments
       = the padded rows (a static shape that never overflows)

The result is exact by construction (keys compare by value, not by
hash). Partials of one chunk merge across chunk boundaries on the host
in HashAggregator, as the hash path's do.

Deviations from the JAX package:
  * the count lane and every sum lane go through one `hashagg._SegBatch`
    into ops/segsum.segment_sum, the hand-written segment-sum kernel on
    CUDA, at C = the padded rows: one stacked launch per dtype, where the
    JAX package runs one jax.ops.segment_sum batch for the count and one
    per aggregate (`_agg_lanes`), which XLA fuses and eager torch would
    launch one by one (as for Q1's int64 lanes, see ops/segsum.py);
  * no donation twin (`_jitd`): torch runs the ops eagerly and there is
    no input buffer to donate; `dispatch` takes no `donate` flag;
  * the profiler and device-plane hooks of `segment_kernel_for` wait for
    those modules.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tidb_tpu_torch.chunk import Chunk
from tidb_tpu_torch.expression import AggDesc, Expression
from tidb_tpu_torch.ops import runtime, tnp
from tidb_tpu_torch.ops.hashagg import (GroupResult, _agg_requests,
                                        _columns_used, _key_bits, _pack,
                                        _readback, _SegBatch,
                                        _validate_device_exprs,
                                        finalize_group_result)

__all__ = ["SegmentAggKernel", "segment_kernel_for"]


class SegmentAggKernel:
    """Segment-reduce over one sorted-chunk schema, on one device.

    The caller owns the sorted-input contract: rows with equal group keys
    must be adjacent (contiguity is enough). group_exprs must be
    device-safe or bare string ColumnRefs (dictionary codes compare equal
    iff the values do, which is all boundary detection needs)."""

    def __init__(self, group_exprs: Sequence[Expression],
                 aggs: Sequence[AggDesc], device=None):
        self.device = runtime.resolve_device(device)
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        _validate_device_exprs(None, self.group_exprs, self.aggs)
        self.used = _columns_used(None, self.group_exprs, self.aggs)

    # lint: exempt[dtype-discipline] int64 segment counts/ids: exact lane semantics shared with hashagg's agg-state stacking
    def _kernel(self, cols, nrows):
        xp = tnp.on(self.device)
        n = next(c for c in cols if c is not None)[0].shape[0]
        arange = torch.arange(n, dtype=torch.int64, device=self.device)
        alive = arange < nrows
        key_cols = [g.eval_xp(xp, cols, n) for g in self.group_exprs]
        # segment starts: row 0, plus any row whose key differs from the
        # previous row's (exact bit compare; NULLs equal NULLs). Built
        # with cat, not an item store: storing a python scalar into a
        # CUDA tensor syncs with the host
        diff = torch.zeros(n - 1, dtype=torch.bool, device=self.device)
        for d, v in key_cols:
            bits = _key_bits(d)
            diff |= (bits[1:] != bits[:-1]) | (v[1:] != v[:-1])
        new = torch.cat((torch.ones(1, dtype=torch.bool, device=self.device),
                         diff))
        new = new & alive                      # padding opens no segment
        seg = torch.cumsum(new, 0, dtype=torch.int32) - 1
        seg = torch.clamp(seg, 0, n - 1)       # all-padding chunk guard
        nseg = torch.sum(new, dtype=torch.int64)
        # one batch: the count lane and every aggregate's sum lanes of a
        # dtype stack into one segment-sum launch
        b = _SegBatch(seg, n)
        i_cnt = b.add(alive.to(torch.int64), "sum")
        i_rep = b.add(torch.where(alive, arange, n), "min")
        assembles = [_agg_requests(xp, a, cols, n, alive, b, arange=arange)
                     for a in self.aggs]
        b.run()
        lanes = [[lane for lane, _op in asm(b.get)] for asm in assembles]
        return nseg, b.get(i_cnt), b.get(i_rep), lanes

    def scratch_nbytes(self, chunk: Chunk) -> int:
        """Device bytes beyond the input columns: segment-id, count and
        lane scratch (num_segments = padded rows, the no-capacity-limit
        trade)."""
        n = runtime.bucket_size(max(chunk.num_rows, 1))
        return n * 8 * (3 + 2 * len(self.aggs))

    def dispatch_nbytes(self, chunk: Chunk) -> int:
        """Device bytes one dispatch stages, from shapes at dispatch
        time: padded input columns plus the kernel scratch (the JAX
        package's count for the same chunk)."""
        from tidb_tpu_torch import memtrack
        n = runtime.bucket_size(max(chunk.num_rows, 1))
        return memtrack.device_put_bytes(chunk, n) + \
            self.scratch_nbytes(chunk)

    def dispatch(self, chunk: Chunk, dev_cols=None):
        """Pad + transfer + enqueue WITHOUT a host sync. With dev_cols
        (device-resident padded columns) the upload is skipped. -> opaque
        pending token."""
        cols = dev_cols
        if cols is None:
            cols, _dicts = runtime.device_put_chunk(chunk, self.device,
                                                    used=self.used)
        return _pack(self._kernel(cols, chunk.num_rows))

    def finalize(self, chunk: Chunk, pending) -> GroupResult:
        """Blocking half: one device->host copy, then the host tail."""
        nseg, counts, rep, lanes = _readback(pending)
        gidx = np.arange(int(nseg[0]))
        lanes_at = [[lane[gidx] for lane in ls] for ls in lanes]
        return finalize_group_result(chunk, self.group_exprs, self.aggs,
                                     gidx, rep[gidx], lanes_at,
                                     counts[gidx])

    def __call__(self, chunk: Chunk, dev_cols=None) -> GroupResult:
        return self.finalize(chunk, self.dispatch(chunk, dev_cols=dev_cols))


# process-wide cache like hashagg.kernel_for's, keyed on the group/agg
# fingerprint and the device (segment kernels have no capacity axis)
_SEG_KERNELS = runtime.FingerprintCache(64)


def segment_kernel_for(group_exprs, aggs, device=None) -> SegmentAggKernel:
    """A SegmentAggKernel, shared process-wide by plan fingerprint and
    device. Raises DeviceRejectError like the constructor when the
    exprs are not device-safe."""
    device = runtime.resolve_device(device)

    from tidb_tpu_torch import devplane, profiler
    made = []

    def make():
        made.append(1)
        return SegmentAggKernel(group_exprs, aggs, device=device)

    fp = runtime.plan_fingerprint(None, group_exprs, aggs)
    if fp is None:
        k = make()
        prof = profiler.profile("streamagg", None)
        profiler.note_construct(prof, reuse=False)
        k._profile = prof
        return k
    key = (fp, str(device), devplane.mesh_fingerprint(process=True))
    k = _SEG_KERNELS.get_or_create(key, make)
    prof = profiler.profile("streamagg", fp)
    profiler.note_construct(prof, reuse=not made)
    k._profile = prof
    return k
