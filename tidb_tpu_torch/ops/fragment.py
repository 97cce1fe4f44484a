"""Fused pipeline fragments: probe + partial agg in one dispatch.

The port of the JAX package's ops/fragment.py. Run per operator, a
`scan -> join-probe -> partial-agg` pipeline writes a pair list back to
the host, gathers a joined chunk there and uploads it again to group it.
ProbeAggKernel runs the whole fragment per probe superchunk as one queue
of torch work on the device:

    1. hash both sides' key lanes and expand the sort-join candidate runs
       into a static-capacity (li, ri) pair list with exact-key
       verification (ops/join.match_pairs, unchanged semantics);
    2. gather ONLY the columns the group/agg expressions read, straight
       from the device-resident padded columns (probe superchunk columns
       and the once-uploaded build columns) at the pair indices: the
       joined row never exists at full width, and varlen lanes stay
       dictionary codes end to end;
    3. run the shared group + partial-agg phase (ops/hashagg.group_partial)
       over the pairs.

Only the group tables return to the host; representative (li, ri) pairs
late-materialize exact group-key values from the two source chunks at
finalize. A pair-capacity overflow regrows inside finalize over the SAME
device-resident lanes; group capacity and collision misses raise to the
executor (executor/agg.HashAgg), which escalates once and then falls
back to the decoded per-batch path. `fragment_kernel_for` registers each
kernel with the kernel-profile plane (profiler.py, family `fragment`).

Left out: the memtrack byte sizing (build_nbytes / dispatch_nbytes).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tidb_tpu_torch.chunk import Chunk
from tidb_tpu_torch.expression import AggDesc, AggFunc, Expression
from tidb_tpu_torch.ops import runtime, tnp
from tidb_tpu_torch.ops.hashagg import (_FILL, _SENTINEL_MASKED,
                                        CapacityError, CollisionError,
                                        DeviceRejectError, GroupResult,
                                        _direct_group_mode, _pack, _readback,
                                        _validate_device_exprs,
                                        finalize_group_result, group_partial)
from tidb_tpu_torch.ops.join import (_DEAD_BUILD, _DEAD_PROBE, match_pairs,
                                     side_hashes)

__all__ = ["ProbeAggKernel", "fragment_kernel_for"]


class _PendingFragment:
    """One in-flight fused dispatch: the padded device-resident lanes
    (probe AND the shared build reference) ride along so a pair-capacity
    overflow retry re-runs WITHOUT re-padding or re-transferring
    anything. The kernel object itself stays stateless: it is cached
    process-wide."""

    __slots__ = ("build_dev", "nb", "pk", "pcols", "np_", "cap", "res")

    def __init__(self, build_dev, nb, pk, pcols, np_, cap, res):
        self.build_dev = build_dev
        self.nb = nb
        self.pk, self.pcols = pk, pcols
        self.np_ = np_
        self.cap = cap
        self.res = res


class ProbeAggKernel:
    """Probe -> partial agg over one (join keys, joined-schema group/agg)
    fragment signature, on one device.

    `group_exprs`/`aggs` reference the JOINED schema: probe columns at
    [0, probe_width), build columns at [probe_width, width). FIRST_ROW
    and GROUP_CONCAT reject (their late-materialize protocol needs
    row-identity lanes the pair space does not preserve)."""

    def __init__(self, num_keys: int, probe_width: int, width: int,
                 group_exprs: Sequence[Expression],
                 aggs: Sequence[AggDesc], capacity: int = 4096,
                 force_hash: bool = False, direct_limit=None, device=None):
        self.device = runtime.resolve_device(device)
        self.num_keys = num_keys
        self.probe_width = probe_width
        self.width = width
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self.capacity = capacity
        self.force_hash = force_hash
        self.direct_limit = direct_limit
        for a in self.aggs:
            if a.fn in (AggFunc.FIRST_ROW, AggFunc.GROUP_CONCAT):
                raise DeviceRejectError(
                    f"{a.fn} needs row identity at finalize; the fused "
                    f"fragment carries only pair indices")
        _validate_device_exprs(None, self.group_exprs, self.aggs)
        used = set()
        for g in self.group_exprs:
            used |= g.columns_used()
        for a in self.aggs:
            if a.arg is not None:
                used |= a.arg.columns_used()
        if any(j >= width for j in used):
            raise DeviceRejectError("agg reads past the joined schema")
        self.probe_used = sorted(j for j in used if j < probe_width)
        self.build_used = sorted(j for j in used if j >= probe_width)

    # -- the fragment's device work ------------------------------------------

    def _kernel(self, bkeys, pkeys, pcols, bcols, nb: int, np_: int,
                out_cap: int):
        """-> (packed result, pending readback spec, total pairs)."""
        hb = side_hashes(bkeys, nb, _DEAD_BUILD)
        hp = side_hashes(pkeys, np_, _DEAD_PROBE)
        li, ri, ok, total = match_pairs(
            hb, hp, [d for d, _v in bkeys], [d for d, _v in pkeys], out_cap)
        # the joined row never materializes at full width: only the
        # lanes the group/agg expressions read are gathered
        joined = [None] * self.width
        for lane, j in enumerate(self.probe_used):
            d, v = pcols[lane]
            joined[j] = (d[li], v[li] & ok)
        for lane, j in enumerate(self.build_used):
            d, v = bcols[lane]
            joined[j] = (d[ri], v[ri] & ok)
        uniq, nuniq, collided, counts, rep, lanes = group_partial(
            tnp.on(self.device), self.group_exprs, self.aggs, joined,
            out_cap, ok, self.capacity, force_hash=self.force_hash,
            direct_limit=self.direct_limit)
        # representative PAIRS (not pair indices) return to the host:
        # finalize gathers exact group-key values from the two source
        # chunks without reading the full li/ri buffers back
        repc = torch.clamp(rep, 0, out_cap - 1)
        return _pack((uniq, nuniq, collided, counts, li[repc], ri[repc],
                      lanes)), total

    def _build_sub(self, build: Chunk) -> Chunk:
        return Chunk([build.columns[j - self.probe_width]
                      for j in self.build_used])

    def _probe_sub(self, chunk: Chunk) -> Chunk:
        return Chunk([chunk.columns[j] for j in self.probe_used])

    def input_nbytes(self, chunk: Chunk) -> int:
        """Device bytes of one dispatch's input lanes: the probe columns
        the group and aggregate expressions read, plus the padded key
        lanes (the bytes_touched figure; the JAX package's count)."""
        from tidb_tpu_torch import memtrack
        pb = runtime.bucket_size(max(chunk.num_rows, 1))
        return memtrack.device_put_bytes(self._probe_sub(chunk), pb) + \
            self.num_keys * 9 * pb

    # -- async dispatch / blocking finalize ----------------------------------

    def prepare_build(self, build: Chunk, build_keys, nb: int):
        """Upload the build side once for the whole probe: padded key
        lanes + the USED build columns (dict-encoded, padded). ->
        (bkeys_dev, bcols_dev), reused by every dispatch."""
        bb = runtime.bucket_size(max(nb, 1))
        bkeys = runtime.put_lanes(build_keys, nb, bb, self.device)
        bcols, _dicts = runtime.device_put_chunk(
            self._build_sub(build), self.device, size=bb, memo=False) \
            if self.build_used else ([], {})
        return bkeys, bcols

    def dispatch(self, build_dev, nb: int, probe_keys, chunk: Chunk,
                 np_: int, out_cap: int | None = None) -> _PendingFragment:
        """Async half: transfer the probe superchunk (its used columns and
        key lanes only) and enqueue the fragment, with no host sync.
        `build_dev` is prepare_build's result, shared by every batch."""
        bkeys, bcols = build_dev
        pb = runtime.bucket_size(max(np_, 1))
        cap = out_cap or runtime.bucket_size(max(np_ * 2, 1024))
        pk = runtime.put_lanes(probe_keys, np_, pb, self.device)
        pcols, _dicts = runtime.device_put_chunk(
            self._probe_sub(chunk), self.device, size=pb, memo=False) \
            if self.probe_used else ([], {})
        res = self._kernel(bkeys, pk, pcols, bcols, nb, np_, cap)
        return _PendingFragment(build_dev, nb, pk, pcols, np_, cap, res)

    def finalize(self, probe_chunk: Chunk, build: Chunk, nb: int,
                 p: _PendingFragment) -> GroupResult:
        """Blocking half: read the pair total first (a scalar: an overflow
        retry then regrows over the SAME resident lanes without
        transferring the dead buffers), then one copy of the group tables,
        then the host late-materialize tail."""
        while True:
            total = int(p.res[1])
            if total <= p.cap:
                break
            p.cap = runtime.bucket_size(total)
            bkeys, bcols = p.build_dev
            p.res = self._kernel(bkeys, p.pk, p.pcols, bcols, p.nb, p.np_,
                                 p.cap)
        (uniq, nuniq, collided, counts, rep_li, rep_ri,
         lanes) = _readback(p.res[0])
        nuniq = int(nuniq[0])
        if nuniq > self.capacity:
            err = CapacityError(f"distinct groups {nuniq} > capacity "
                                f"{self.capacity}")
            err.needed = nuniq
            raise err
        if bool(collided[0]):
            raise CollisionError("fused group key hash collision")
        live = (counts > 0) & (uniq != _SENTINEL_MASKED) & (uniq != _FILL)
        gidx = np.flatnonzero(live)
        lanes_at = [[lane[gidx] for lane in ls] for ls in lanes]
        # late materialization: gather ONLY the representative joined
        # rows from the two source chunks (strings decode here, at the
        # operator-output boundary, never inside the fragment)
        pli = np.clip(rep_li[gidx], 0, max(probe_chunk.num_rows - 1, 0))
        pri = np.clip(rep_ri[gidx], 0, max(nb - 1, 0))
        rep_chunk = Chunk(probe_chunk.take(pli).columns +
                          build.take(pri).columns)
        order = np.arange(len(gidx), dtype=np.int64)
        return finalize_group_result(rep_chunk, self.group_exprs,
                                     self.aggs, order, order, lanes_at,
                                     counts[gidx])


# process-wide fragment-kernel cache, keyed on the structural identity of
# the whole fragment (join-key arity, schema split, group/agg fingerprint,
# table capacity, the degrade bounds and the device)
_FRAGMENTS = runtime.FingerprintCache(32)


def fragment_kernel_for(num_keys: int, probe_width: int, width: int,
                        group_exprs, aggs, capacity: int = 4096,
                        device=None):
    """ProbeAggKernel with process-wide reuse; raises DeviceRejectError
    (or ValueError) when the fragment is not device-safe: the caller then
    keeps the per-operator path."""
    from tidb_tpu_torch import config
    device = runtime.resolve_device(device)
    direct_limit = config.direct_agg_slots()
    force_hash = capacity > direct_limit and _direct_group_mode(group_exprs)

    from tidb_tpu_torch import profiler
    made = []

    def make():
        made.append(1)
        return ProbeAggKernel(num_keys, probe_width, width, group_exprs,
                              aggs, capacity=capacity, force_hash=force_hash,
                              direct_limit=direct_limit, device=device)

    fp = runtime.plan_fingerprint(None, group_exprs, aggs)
    if fp is None:
        k = make()
        prof = profiler.profile("fragment", None)
        profiler.note_construct(prof, reuse=False)
        k._profile = prof
        return k
    key = (fp, num_keys, probe_width, width, capacity, force_hash,
           direct_limit, str(device))
    k = _FRAGMENTS.get_or_create(key, make)
    prof = profiler.profile(
        "fragment", f"{fp}|{num_keys}|{probe_width}|{width}|{capacity}"
                    f"|{force_hash}|{direct_limit}")
    profiler.note_construct(prof, reuse=not made)
    k._profile = prof
    return k
