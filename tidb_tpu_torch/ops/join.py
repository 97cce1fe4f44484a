"""Equi-join pair matching on the device: the sort join.

The port of the JAX package's ops/join.py. A dynamic hash table fights
static shapes, so the matcher is sort-based:

    1. hash both sides' key tuples to int64 (NULL keys -> per-side
       sentinels, so they never match anything: SQL semantics)
    2. sort the build hashes once (stable, so equal hashes keep build
       order); searchsorted gives every probe row its contiguous
       candidate run [left, right)
    3. a prefix sum over run lengths + one searchsorted turn the dynamic
       fan-out into a static-capacity (li, ri) pair list; `finalize` reads
       the true `total` first and regrows the capacity when it overflowed
    4. candidate pairs are verified by EXACT key equality, so a hash
       collision only costs a discarded candidate, never a wrong row

Keys are evaluated to fixed-width lanes on the host first (strings get a
dictionary shared across both sides, `JoinKeyEncoder`), so the matcher
only ever sees int64 / float64 lanes; payload gather happens on the host
from the returned pair indices. Every step of the matcher is torch ops
queued on the device's stream: `dispatch` never syncs with the host.

Deviations from the JAX package: no per-capacity program memo (torch runs
eagerly, nothing is traced), and `finalize` compacts the verified pairs
on the device before the one copy back, where the reference copies the
whole capacity-sized li/ri/ok buffers.
"""

from __future__ import annotations

import numpy as np
import torch

from tidb_tpu_torch.ops import runtime
from tidb_tpu_torch.ops.hashagg import (_FILL, _SENTINEL_MASKED, _hash_keys,
                                        host_hash_keys)

__all__ = ["JoinKernel", "JoinOverflowError", "JoinKeyEncoder",
           "match_pairs", "host_match_pairs"]

# build-side dead rows hash to _SENTINEL_MASKED, probe-side to _FILL:
# distinct values, and _hash_keys never produces either for live rows
_DEAD_BUILD = _SENTINEL_MASKED
_DEAD_PROBE = _FILL
# one seed for both sides: equal keys hash equal
SEED = 0x9E3779B97F4A7C15


class JoinOverflowError(Exception):
    """More output pairs than the kernel's static capacity."""

    def __init__(self, needed: int):
        super().__init__(f"join output needs {needed} pairs")
        self.needed = needed


class JoinKeyEncoder:
    """Aligns varlen key columns across both sides of a join.

    Fitted once on the (materialized) build side; probe chunks stream
    through transform_probe(). String values get int64 codes from one
    shared dictionary; probe values absent from it get unique negative
    codes so they match nothing yet remain live rows (outer joins).

    A side that arrives PRE-ENCODED (the memoized dict_encode of a bare
    varlen ColumnRef, ops/encoded.py) skips the per-row dictionary loop:
    a probe sharing the build's dictionary OBJECT passes its codes
    straight through, a mismatched dictionary re-keys with one gather
    through a code-translation array."""

    def __init__(self, num_keys: int):
        self._dicts: list[dict | None] = [None] * num_keys
        self._bvalues: list[list | None] = [None] * num_keys
        self._ci = [False] * num_keys

    def fit_build(self, cols, encoded=None, ci=None):
        out = []
        for j, (d, v) in enumerate(cols):
            enc = encoded[j] if encoded is not None else None
            if enc is not None:
                # the column's memoized dictionary IS the join dictionary
                codes, values = enc
                self._bvalues[j] = values
                if ci is not None:
                    self._ci[j] = bool(ci[j])
                out.append((codes, v))
                continue
            if d.dtype != object:
                out.append((d, v))
                continue
            mapping: dict = {}
            codes = np.empty(len(d), dtype=np.int64)
            for i, val in enumerate(d):
                codes[i] = mapping.setdefault(val, len(mapping)) if v[i] \
                    else -1
            self._dicts[j] = mapping
            out.append((codes, v))
        return out

    def _mapping(self, j: int) -> dict | None:
        """The build-side value->code map, built lazily from an encoded
        build dictionary when a raw probe side needs per-value lookup."""
        mapping = self._dicts[j]
        if mapping is None and self._bvalues[j] is not None:
            from tidb_tpu_torch.ops import encoded as op_encoded
            mapping = op_encoded._dict_map(self._bvalues[j], self._ci[j])
            self._dicts[j] = mapping
        return mapping

    def transform_probe(self, cols, encoded=None):
        out = []
        for j, (d, v) in enumerate(cols):
            enc = encoded[j] if encoded is not None else None
            bvals = self._bvalues[j]
            if enc is not None and bvals is not None:
                codes, values = enc
                if values is bvals:
                    out.append((codes, v))     # shared dictionary
                else:
                    from tidb_tpu_torch.ops import encoded as op_encoded
                    t = op_encoded.code_translation(
                        values, bvals, self._ci[j],
                        dst_map=self._mapping(j))
                    out.append((t[codes], v))
                continue
            mapping = self._mapping(j)
            if mapping is None:
                if d.dtype == object:
                    # the build side had no string values at all: nothing
                    # can match, but rows stay live for outer joins
                    codes = np.arange(-2, -2 - len(d), -1, dtype=np.int64)
                    out.append((codes, v))
                else:
                    out.append((d, v))
                continue
            codes = np.empty(len(d), dtype=np.int64)
            for i, val in enumerate(d):
                codes[i] = mapping.get(val, -2 - i) if v[i] else -1
            out.append((codes, v))
        return out


def side_hashes(keys, n: int, dead: int):
    """Device row hashes of one side's padded key lanes: rows past `n` or
    with any NULL key get the side's dead sentinel."""
    size = keys[0][0].shape[0]
    device = keys[0][0].device
    valid = torch.arange(size, device=device) < n
    for _d, v in keys:
        valid = valid & v
    h = _hash_keys([(d, v & valid) for d, v in keys], size, SEED, device)
    return torch.where(valid, h, dead)


def match_pairs(hb, hp, bd_lanes, pd_lanes, out_cap: int):
    """Sort-join matcher steps 2-4 (module docstring): build hashes `hb`
    (dead rows = _DEAD_BUILD) vs probe hashes `hp` (dead = _DEAD_PROBE),
    expanded into a static-capacity pair list with exact-key verification
    over the raw data lanes. Both sides are non-empty (padded to a
    bucket). -> (li, ri, ok, total) tensors; `total` is the true pair
    count, which may exceed out_cap."""
    b_n = hb.shape[0]
    p_n = hp.shape[0]
    perm = torch.argsort(hb, stable=True)
    sb = hb[perm]
    left = torch.searchsorted(sb, hp, side="left")
    right = torch.searchsorted(sb, hp, side="right")
    counts = torch.where(hp != _DEAD_PROBE, right - left, 0)
    cum = torch.cumsum(counts, 0)
    total = cum[p_n - 1]

    k = torch.arange(out_cap, dtype=torch.int64, device=hb.device)
    li = torch.searchsorted(cum, k, side="right")
    li_c = torch.clamp(li, 0, p_n - 1)
    start = cum[li_c] - counts[li_c]
    pos = left[li_c] + (k - start)
    ri = perm[torch.clamp(pos, 0, b_n - 1)]
    ok = k < torch.clamp(total, max=out_cap)
    # exact key verification: candidates from colliding hashes drop here
    for bd, pd in zip(bd_lanes, pd_lanes):
        ok = ok & (bd[ri] == pd[li_c])
    return li_c, ri, ok, total


def host_match_pairs(build_keys, probe_keys, nb: int, np_: int):
    """Vectorized numpy pair matcher: the same sort join with dynamic
    shapes, for inputs too small to pay a dispatch.
    -> (li, ri) numpy index arrays of matching (probe, build) pairs."""
    if nb == 0 or np_ == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    b_valid = np.ones(nb, dtype=bool)
    for _d, v in build_keys:
        b_valid &= v[:nb]
    p_valid = np.ones(np_, dtype=bool)
    for _d, v in probe_keys:
        p_valid &= v[:np_]
    hb = host_hash_keys([(d[:nb], v[:nb] & b_valid)
                         for d, v in build_keys], nb, SEED)
    hp = host_hash_keys([(d[:np_], v[:np_] & p_valid)
                         for d, v in probe_keys], np_, SEED)
    hb = np.where(b_valid, hb, _DEAD_BUILD)
    hp = np.where(p_valid, hp, _DEAD_PROBE)
    perm = np.argsort(hb, kind="stable")
    sb = hb[perm]
    left = np.searchsorted(sb, hp, side="left")
    right = np.searchsorted(sb, hp, side="right")
    counts = np.where(hp != _DEAD_PROBE, right - left, 0)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    li = np.repeat(np.arange(np_, dtype=np.int64), counts)
    # position within each probe row's candidate run
    run_start = np.cumsum(counts) - counts
    pos = left[li] + (np.arange(total, dtype=np.int64) - run_start[li])
    ri = perm[pos]
    # exact key verification discards hash-collision candidates
    ok = np.ones(total, dtype=bool)
    for (bd, _bv), (pd_, _pv) in zip(build_keys, probe_keys):
        ok &= bd[:nb][ri] == pd_[:np_][li]
    return li[ok], ri[ok]


class _PendingJoin:
    """In-flight matcher dispatch: the padded device-resident key lanes
    ride along so an overflow retry re-runs WITHOUT re-padding or
    re-transferring either side."""

    __slots__ = ("bk", "pk", "nb", "np_", "cap", "res")

    def __init__(self, bk, pk, nb, np_, cap, res):
        self.bk, self.pk = bk, pk
        self.nb, self.np_ = nb, np_
        self.cap = cap
        self.res = res


class JoinKernel:
    """Pair matcher for one key-lane signature on one device."""

    def __init__(self, num_keys: int, device=None):
        self.num_keys = num_keys
        self.device = runtime.resolve_device(device)

    def build_nbytes(self, nb: int) -> int:
        """Device bytes prepare_build stages: one padded 8-byte data lane
        plus a bool validity lane per key."""
        return self.num_keys * 9 * runtime.bucket_size(max(nb, 1))

    def dispatch_nbytes(self, np_: int, out_cap: int | None = None) -> int:
        """Device bytes one probe dispatch stages, from shapes alone: the
        padded probe key lanes plus the static-capacity pair buffers (li
        and ri int64, ok bool). Billed at dispatch, credited back at
        finalize."""
        cap = out_cap or runtime.bucket_size(max(np_ * 2, 1024))
        return self.num_keys * 9 * runtime.bucket_size(max(np_, 1)) \
            + cap * 17

    def prepare_build(self, build_keys, nb: int):
        """Pad + transfer the build-side key lanes once; the returned
        device lanes feed every probe batch's dispatch."""
        bb = runtime.bucket_size(max(nb, 1))
        return runtime.put_lanes(build_keys, nb, bb, self.device)

    def _program(self, bkeys, pkeys, nb: int, np_: int, out_cap: int):
        hb = side_hashes(bkeys, nb, _DEAD_BUILD)
        hp = side_hashes(pkeys, np_, _DEAD_PROBE)
        return match_pairs(hb, hp, [d for d, _v in bkeys],
                           [d for d, _v in pkeys], out_cap)

    def dispatch(self, build_keys, probe_keys, nb: int, np_: int,
                 out_cap: int | None = None, build_dev=None) -> _PendingJoin:
        """Async half: transfer the probe keys and enqueue the matcher for
        one probe batch, with no host sync (the pipeline's overlap point).
        build_dev, when given, is the prepare_build() result reused across
        batches."""
        bk = build_dev if build_dev is not None \
            else self.prepare_build(build_keys, nb)
        pb = runtime.bucket_size(max(np_, 1))
        cap = out_cap or runtime.bucket_size(max(np_ * 2, 1024))
        pk = runtime.put_lanes(probe_keys, np_, pb, self.device)
        return _PendingJoin(bk, pk, nb, np_, cap,
                            self._program(bk, pk, nb, np_, cap))

    def finalize(self, p: _PendingJoin):
        """Blocking half: read the pair total first (one scalar: an
        overflow retry then discards the capacity-sized buffers without
        transferring them), regrow the capacity over the same device lanes
        until it fits, then copy the verified pairs back in one copy."""
        while True:
            li, ri, ok, total = p.res
            total = int(total)
            if total <= p.cap:
                break
            p.cap = runtime.bucket_size(total)
            p.res = self._program(p.bk, p.pk, p.nb, p.np_, p.cap)
        pairs = torch.stack((li, ri))[:, ok].cpu().numpy()
        return pairs[0], pairs[1]

    def __call__(self, build_keys, probe_keys, nb: int, np_: int,
                 out_cap: int | None = None):
        """build_keys/probe_keys: [(np data, np valid)] aligned fixed-width
        lanes (JoinKeyEncoder). -> (li, ri) numpy index arrays of matching
        (probe, build) row pairs."""
        return self.finalize(self.dispatch(build_keys, probe_keys, nb, np_,
                                           out_cap=out_cap))
