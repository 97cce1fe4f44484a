"""Plane shuffle hash join: all_to_all repartition + per-shard sort join.

The port of the JAX package's ops/meshshuffle.py. Each shard buckets its
row shard by destination shard (hash mod n), an `all_to_all` over the
``"batch"`` axis exchanges the buckets, and every shard then joins only
its hash partition with the sort matcher of the single-device kernel
(ops/join.match_pairs). Per-shard memory is O(N/ndev) for both sides, so
duplicate keys on either side and build sides too large to replicate
are fine. On a 1-shard plane the kernel delegates to the single-device
JoinKernel: no shuffle at all.

The reference's body calls the all_to_all in the middle of one traced
program; here the body is split there into a per-shard bucketing stage,
the exchange (devplane.all_to_all over per-shard lists) and a per-shard
matcher stage. Static capacities and their retry protocol are the
reference's:

* send buckets have a fixed per-destination capacity; the true bucket
  fills are read back and the host retries with larger buckets;
* the matcher emits into a fixed pair capacity with the same
  total-count overflow retry as ops/join.py. The shards are separate
  launches here, so each has its own capacity: a retry regrows only the
  shards whose pairs overflowed (the reference's one SPMD program gives
  every chip the largest);
* past 8 attempts `ShuffleOverflowError` is raised.
"""

from __future__ import annotations

import numpy as np
import torch

from tidb_tpu_torch import devplane
from tidb_tpu_torch.ops import runtime
from tidb_tpu_torch.ops.hashagg import _FILL, _SENTINEL_MASKED, _hash_keys
from tidb_tpu_torch.ops.join import JoinKernel, match_pairs

__all__ = ["MeshShuffleJoinKernel", "ShuffleOverflowError"]

_DEAD_BUILD = _SENTINEL_MASKED
_DEAD_PROBE = _FILL
_HASH_SEED = 0x9E3779B97F4A7C15


class ShuffleOverflowError(Exception):
    """A shuffle bucket or the pair output exceeded its static capacity
    beyond the retry budget (extreme hash skew)."""


# lint: exempt[dtype-discipline] route lanes ride the int64 hash dtype (dead-row sentinel = ndev)
def _bucketize(ndev: int, cap: int, dst, keep, lanes, fills):
    """Scatter each row's lanes into its destination bucket.
    -> ([ndev*cap] buffers per lane, local max bucket fill)."""
    n = dst.shape[0]
    dev = dst.device
    order = torch.argsort(dst, stable=True)
    sdst = dst[order]
    first = torch.searchsorted(sdst, sdst, side="left")
    rank = torch.arange(n, dtype=torch.int64, device=dev) - first
    # dropped rows (dead/padding) and overflowing ranks park on a dump
    # slot past the buffer end
    kept = keep[order]
    ok = kept & (rank < cap)
    slot = torch.where(ok, sdst * cap + rank, ndev * cap)
    out = []
    for lane, fill in zip(lanes, fills):
        buf = torch.full((ndev * cap + 1,), fill, dtype=lane.dtype,
                         device=dev)
        buf.scatter_(0, slot, lane[order])
        out.append(buf[:-1])
    maxfill = torch.amax(torch.where(kept, rank + 1, 0)) if n else \
        torch.zeros((), dtype=torch.int64, device=dev)
    return out, maxfill


class MeshShuffleJoinKernel:
    """Distributed equi-join pair matcher. Call signature mirrors
    ops/join.py JoinKernel: fixed-width key lanes in, (probe_idx,
    build_idx) numpy pair arrays out, so the executor's host-side payload
    gather is unchanged."""

    def __init__(self, mesh, num_keys: int):
        self.mesh = mesh
        self.ndev = devplane.ndev(mesh)
        self.num_keys = num_keys
        self._single = JoinKernel(num_keys, device=mesh.devices.flat[0]) \
            if self.ndev == 1 else None
        # one-slot build-side transfer memo: a streamed probe calls the
        # kernel once per super-batch against the SAME build keys object;
        # pinning it (identity compare) makes every batch after the first
        # re-send only the probe. One slot bounds pinned device memory.
        self._build_memo = None       # (build_keys_obj, shard_len, lanes)
        self._prog = devplane.plane_jit(self._program)

    # -- plane program -------------------------------------------------------

    def _shard_side(self, i, keys, n, shard_len, cap, dead):
        """Stage 1 on shard i: hash, route and bucket one side's rows."""
        ndev = self.ndev
        dev = keys[0][0].device
        offs = i * shard_len
        # lint: exempt[dtype-discipline] global row offsets are exact int64 (shard base can exceed int32)
        gidx = offs + torch.arange(shard_len, dtype=torch.int64, device=dev)
        valid = gidx < n
        for _d, v in keys:
            valid = valid & v
        h = _hash_keys([(d, v & valid) for d, v in keys], shard_len,
                       _HASH_SEED, dev)
        h = torch.where(valid, h, dead)
        # dead rows (NULL keys, shard padding) route past every real
        # bucket so they never inflate a live bucket's ranks; the uint64
        # remainder of the hash bits, as the reference takes it
        hu = torch.where(h < 0, (h & ((1 << 63) - 1)) % ndev +
                         (1 << 63) % ndev, h % ndev) % ndev
        dst = torch.where(valid, hu, ndev)
        lanes = [h, gidx] + [d for d, _v in keys]
        fills = [dead, -1] + [0 for _d, _v in keys]
        return _bucketize(ndev, cap, dst, valid, lanes, fills)

    def _program(self, lk, rk, nl, nr, ls, rs, cap_l, cap_r, out_caps):
        ndev = self.ndev
        sides = []
        for keys, n, shard_len, cap, dead in (
                (lk, nl, ls, cap_l, _DEAD_PROBE),
                (rk, nr, rs, cap_r, _DEAD_BUILD)):
            bufs, fills = [], []
            for i, dev in enumerate(self.mesh.devices.flat):
                with devplane.device_scope(dev):
                    b, f = self._shard_side(i, keys[i], n, shard_len, cap,
                                            dead)
                bufs.append(b)
                fills.append(f)
            # the exchange: lane by lane, shard j receives bucket j of
            # every shard
            exch = [devplane.all_to_all(
                [bufs[i][k].reshape(ndev, cap) for i in range(ndev)],
                self.mesh) for k in range(len(bufs[0]))]
            sides.append(([[e[i].reshape(ndev * cap) for e in exch]
                           for i in range(ndev)], fills))
        (pl, ofl_l), (pr, ofl_r) = sides
        outs = []
        for i, dev in enumerate(self.mesh.devices.flat):
            with devplane.device_scope(dev):
                hp, pli, pd = pl[i][0], pl[i][1], pl[i][2:]
                hb, bli, bd = pr[i][0], pr[i][1], pr[i][2:]
                # per-partition sort join: the shared matcher of
                # ops/join.py
                li_c, ri, ok, total = match_pairs(hb, hp, bd, pd,
                                                  out_caps[i])
                gl = torch.where(ok, pli[li_c], -1)
                gr = torch.where(ok, bli[ri], -1)
                outs.append((gl, gr, ok, total, ofl_l[i], ofl_r[i]))
        return outs

    # -- host side -----------------------------------------------------------

    def _put_side(self, keys, shard_len):
        """Pad one side's key lanes and shard them over the plane (each
        shard's lanes in one pinned buffer and one copy)."""
        lanes = [(np.ascontiguousarray(d), np.asarray(v, dtype=bool))
                 for d, v in keys]
        n = len(lanes[0][0])
        return runtime.shard_put(lanes, n, shard_len, self.mesh)

    @staticmethod
    # lint: exempt[dtype-discipline] the one readback buffer packs every shard's lanes as int64 words (one copy back)
    def finalize(pending):
        """One batched device->host readback of a list of per-shard
        tensors (the kernel's output boundary)."""
        dev = pending[0].device
        flat = torch.cat([t.reshape(-1).to(torch.int64).to(dev)
                          for t in pending])
        host = flat.cpu().numpy()
        out, off = [], 0
        for t in pending:
            out.append(host[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
        return out

    def __call__(self, probe_keys, build_keys, nb: int, np_: int):
        """probe/build key lanes [(data, valid)] -> (li, ri) pair arrays.
        Probe first, sizes last (JoinKernel takes the build first)."""
        if self._single is not None:
            return self._single(build_keys, probe_keys, nb, np_)
        if nb == 0 or np_ == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int64))
        ndev = self.ndev
        ls = runtime.bucket_size(-(-max(np_, 1) // ndev))
        rs = runtime.bucket_size(-(-max(nb, 1) // ndev))
        # expected per-destination fill is shard/ndev; 4x slack absorbs
        # ordinary skew, the retry loop the rest
        cap_l = min(ls, runtime.bucket_size(max(-(-ls // ndev) * 4, 16)))
        cap_r = min(rs, runtime.bucket_size(max(-(-rs // ndev) * 4, 16)))
        out_caps = [runtime.bucket_size(max(2 * ls, 1024))] * ndev
        lk = self._put_side(probe_keys, ls)
        memo = self._build_memo
        if memo is not None and memo[0] is build_keys and memo[1] == rs:
            rk = memo[2]
        else:
            rk = self._put_side(build_keys, rs)
            self._build_memo = (build_keys, rs, rk)
        for _ in range(8):
            outs = self._prog(lk, rk, np_, nb, ls, rs, cap_l, cap_r,
                              out_caps)
            # small control values first: an overflow retry then discards
            # the capacity-sized pair buffers without transferring them
            ctl = self.finalize([t for o in outs for t in o[3:]])
            totals, fl, fr = ctl[0::3], ctl[1::3], ctl[2::3]
            need_l = int(max(int(x) for x in fl))
            need_r = int(max(int(x) for x in fr))
            if need_l > cap_l:
                cap_l = min(ls, runtime.bucket_size(need_l))
                continue
            if need_r > cap_r:
                cap_r = min(rs, runtime.bucket_size(need_r))
                continue
            over = [i for i, t in enumerate(totals) if int(t) > out_caps[i]]
            if over:
                out_caps = [runtime.bucket_size(int(totals[i]))
                            if i in over else c
                            for i, c in enumerate(out_caps)]
                continue
            pairs = self.finalize([torch.stack((o[0], o[1]))[:, o[2]]
                                   for o in outs])
            # lint: exempt[memtrack-alloc] the matcher's output boundary: one index pair per joined row, the rows the executor's emit bills as it gathers them
            li, ri = (np.concatenate([p[k] for p in pairs]) for k in (0, 1))
            return li.astype(np.int64), ri.astype(np.int64)
        raise ShuffleOverflowError("shuffle join retry budget exhausted")
