"""Skew-aware partitioned hybrid hash join and aggregation.

The port of the JAX package's ops/hybrid.py. Two mechanisms keep a
capacity or collision miss from sending a whole operator to the host:

  * **Radix partitioning.** Build and probe keys split into
    `tidb_tpu_join_partitions` hash partitions (equal keys -> equal hash
    -> same partition), so each partition sees ~1/P of the pairs or
    groups, and a partition that still misses falls back alone.
  * **Heavy-hitter lane.** Keys whose build-side duplication or
    probe-side frequency reaches `tidb_tpu_skew_threshold` rows route to
    a dedicated broadcast lane sized exactly from known per-key counts.
    The initial hot set comes from exact build-side counts plus, where a
    caller has one, the probe table's ANALYZE-time `CMSketch`; a
    streaming sketch over OBSERVED probe keys promotes late-discovered
    hot keys mid-stream.

Routing runs on the host over `host_hash_keys` (bit-identical to the
matcher's device hash); each partition's key lanes upload once and stay
resident on the device across probe batches. The build bills its
gathered host copy and every resident partition to its operator's
memtrack node, and registers a quota spill action that sheds the cold
resident partitions (executor/join.py then stages probe rows for them
and drains them partition by partition).

Each partition upload, and each partition of the aggregation below, is
one `join.partition` trace span; each partition's device attempt and the
escalated whole-chunk retry hold a scheduler slot (sched.device_slot),
and a partition's host fallback bills the tenant meter as host time.

Aggregation gets the same treatment via `partitioned_agg`: rows
radix-partition by group-key hash, each partition re-runs the device
kernel with its own capacity escalation, and only a partition that still
misses aggregates on the host. Groups never span partitions, so the
per-partition GroupResults concatenate into one exact result.
"""

from __future__ import annotations

import threading

import numpy as np

from tidb_tpu_torch import config, memtrack, meter, metrics, sched, trace
from tidb_tpu_torch.ops import runtime
from tidb_tpu_torch.ops.hashagg import (CapacityError, CollisionError,
                                        DeviceRejectError, GroupResult,
                                        host_hash_keys, kernel_for)
from tidb_tpu_torch.ops.join import SEED, _DEAD_BUILD, _DEAD_PROBE

__all__ = ["HybridJoinBuild", "partitioned_agg", "agg_retry",
           "concat_group_results", "group_key_hashes", "build_hashes",
           "probe_hashes", "partition_ids", "detect_hot_hashes",
           "dup_hot_hashes", "sketch_hot_hashes", "escalated_capacity"]

_MAX_AGG_CAPACITY = 1 << 20   # the escalation ceiling
_BASE_AGG_CAPACITY = 4096
_MAX_HOT = 1024               # hot-lane key budget (it must stay tiny)
_MAX_PROMOTIONS = 4           # re-layouts are O(nb): bound them
# max distinct build keys to probe a sketch for (one blake2b per key)
_CMS_SCAN_LIMIT = 1 << 16

_REMIX = np.uint64(0xFF51AFD7ED558CCD)   # murmur3 fmix64 constant


def partition_ids(h: np.ndarray, parts: int) -> np.ndarray:
    """Partition id in [0, parts) per row hash. The hash bits are remixed
    first so partition membership is independent of the raw hash ORDER
    the sort-based kernels consume."""
    u = h.astype(np.uint64)
    u = (u ^ (u >> np.uint64(33))) * _REMIX
    u = u ^ (u >> np.uint64(29))
    return (u % np.uint64(max(parts, 1))).astype(np.int64)


def _side_hashes(keys, n: int, dead: int) -> np.ndarray:
    valid = np.ones(n, dtype=bool)
    for _d, v in keys:
        valid &= np.asarray(v[:n], dtype=bool)
    h = host_hash_keys([(np.asarray(d[:n]),
                         np.asarray(v[:n], dtype=bool) & valid)
                        for d, v in keys], n, SEED)
    return np.where(valid, h, dead)


def build_hashes(bk, nb: int) -> np.ndarray:
    """Row hashes of encoded build key lanes; any-NULL rows get
    _DEAD_BUILD (they match nothing, exactly like the matcher)."""
    return _side_hashes(bk, nb, _DEAD_BUILD)


def probe_hashes(pk, n: int) -> np.ndarray:
    """Probe-side twin of build_hashes (_DEAD_PROBE for NULL rows)."""
    return _side_hashes(pk, n, _DEAD_PROBE)


def _hash_key_bytes(h: int) -> bytes:
    """CMSketch key for a row HASH (the streaming probe sketch counts
    hashes, not raw values: both sides already agree on them)."""
    return int(h).to_bytes(8, "little", signed=True)


def escalated_capacity(needed: int) -> int | None:
    """Next capacity for a CapacityError retry (2x the true group count,
    power of two); None when the overflow is hopeless."""
    cap = 1 << max(needed * 2 - 1, 1).bit_length()
    if not needed or cap > _MAX_AGG_CAPACITY:
        return None
    return cap


def dup_hot_hashes(h: np.ndarray, threshold: int) -> np.ndarray:
    """Build-side duplication leg of heavy-hitter detection: exact (the
    build is materialized): any key with >= threshold build rows goes
    hot."""
    if not threshold:
        return np.empty(0, dtype=np.int64)
    live = h[h != _DEAD_BUILD]
    if not live.size:
        return np.empty(0, dtype=np.int64)
    uniq, cnt = np.unique(live, return_counts=True)
    return uniq[cnt >= threshold][:_MAX_HOT]


def sketch_hot_hashes(h: np.ndarray, threshold: int, raw_key,
                      probe_cms) -> np.ndarray:
    """Probe-side frequency leg: the probe table's CMSketch (`probe_cms`)
    queried per distinct build key VALUE (`raw_key` = the pre-encoding
    (data, valid) lane of the first join key), only when the distinct
    count is small enough for per-key queries."""
    if not threshold or probe_cms is None or raw_key is None:
        return np.empty(0, dtype=np.int64)
    live = h[h != _DEAD_BUILD]
    uniq = np.unique(live)
    if not 0 < uniq.size <= _CMS_SCAN_LIMIT:
        return np.empty(0, dtype=np.int64)
    from tidb_tpu_torch.statistics import cm_key
    d, v = raw_key
    idx = np.flatnonzero(np.asarray(v[:len(h)], dtype=bool))
    if not idx.size:
        return np.empty(0, dtype=np.int64)
    try:
        vals, first = np.unique(np.asarray(d)[idx], return_index=True)
    except TypeError:                # mixed/unorderable values: skip
        return np.empty(0, dtype=np.int64)
    sel = [int(i) for i, val in zip(first, vals)
           if probe_cms.query(cm_key(val)) >= threshold]
    if not sel:
        return np.empty(0, dtype=np.int64)
    return np.unique(h[idx[np.asarray(sel, dtype=np.int64)]])[:_MAX_HOT]


def detect_hot_hashes(h: np.ndarray, threshold: int, raw_key=None,
                      probe_cms=None) -> np.ndarray:
    """Initial heavy-hitter hash set for a build side: exact build-side
    duplication plus sketch-estimated probe-side frequency."""
    hot = np.union1d(dup_hot_hashes(h, threshold),
                     sketch_hot_hashes(h, threshold, raw_key, probe_cms))
    return hot[:_MAX_HOT]


class HybridJoinBuild:
    """Radix-partitioned, device-resident build side of the hybrid hash
    join, with a heavy-hitter broadcast lane and the memtrack quota
    spill.

    Layout: build rows sort (stably) by partition id, cold partitions
    0..parts-1 by remixed key hash and the hot lane at index `parts`, so
    every partition is one contiguous slice of the gathered key lanes.
    `ensure(p)` uploads a partition's lanes once and keeps them resident
    across probe batches. The registered quota spill action
    (`_quota_spill`) sheds every resident cold partition except the one
    being probed; after it, `want_immediate` steers newly arriving probe
    rows for spilled partitions into host staging, which the executor
    drains partition by partition at the end of the stream. `pin` and
    `unpin` mark in-flight dispatches, so neither a spill nor a
    promotion credits back (or retires) a partition a pending token
    still reads.

    `plan` is the operator whose memtrack node the build bills (none
    without an active statement root); `stats`, when given, counts
    partition uploads. Threading: the probe driver is the only mutator
    of the layout arrays; `_mu` protects the residency map and the hot
    set against the spill action, which fires on whatever thread crossed
    the quota."""

    def __init__(self, kernel, bk, nb: int, parts: int, stats=None,
                 hot_hashes=None, threshold: int | None = None, h=None,
                 plan=None):
        self.kernel = kernel
        self.nb = nb
        self.parts = max(int(parts), 1)
        self.stats = stats
        self.threshold = config.skew_threshold() \
            if threshold is None else threshold
        self._bk = bk
        self._mu = threading.Lock()
        self._resident: dict[int, tuple] = {}   # guarded-by: _mu
        self._pins: dict[int, int] = {}         # guarded-by: _mu
        self._zombies: dict[int, list] = {}     # guarded-by: _mu
        self._active = -1                       # guarded-by: _mu
        self._spill_fired = False               # guarded-by: _mu
        self.spilled = 0                        # guarded-by: _mu
        self.hot_rows = 0          # probe rows routed through the lane
        self._promotions = 0
        self._obs = None           # streaming probe-side CMSketch
        # the tracker node is captured HERE: the spill action may fire on
        # another thread, and the release must hit the ledger charged
        self._node = memtrack.op_node(plan) if plan is not None else None
        self._host_tracked = 0                  # guarded-by: _mu
        self.h = h if h is not None else build_hashes(bk, nb)
        self._build_uniq = np.unique(self.h[self.h != _DEAD_BUILD])
        hot = np.asarray(hot_hashes if hot_hashes is not None else [],
                         dtype=np.int64)
        self.hot = np.unique(hot)[:_MAX_HOT]    # guarded-by: _mu
        with self._mu:
            delta = self._layout_locked()
        try:
            self._apply_host_delta(delta)
        except BaseException:
            # the quota cancel can fire on this very charge, before the
            # caller's close() exists: credit the gathered copy back here
            if self._node is not None and self._host_tracked:
                self._node.release(host=self._host_tracked)
                self._host_tracked = 0
            raise
        self._unregister = memtrack.register_spill(self._quota_spill) \
            if self._node is not None else (lambda: None)

    # -- layout --------------------------------------------------------------

    def _layout_locked(self) -> int:
        """(Re)compute the partition layout from the pristine key lanes:
        one stable argsort by partition id, one gather per lane. Caller
        holds _mu and has already drained _resident if the hot set
        changed. Returns the host-byte delta of the gathered copy for
        the caller to apply OUTSIDE the lock (a consume here could fire
        the quota chain, whose spill action takes _mu)."""
        pid = partition_ids(self.h, self.parts)
        if self.hot.size:
            pid = np.where(np.isin(self.h, self.hot), self.parts, pid)
        order = np.argsort(pid, kind="stable")
        self._order = order
        self._bounds = np.searchsorted(pid[order],
                                       np.arange(self.parts + 2))
        self._lanes = [(np.asarray(d[:self.nb])[order],
                        np.asarray(v[:self.nb], dtype=bool)[order])
                       for d, v in self._bk]
        self._hs = self.h[order]
        hs, he = int(self._bounds[self.parts]), \
            int(self._bounds[self.parts + 1])
        if he > hs:
            self._hot_uniq, self._hot_cnt = np.unique(
                self._hs[hs:he], return_counts=True)
        else:
            self._hot_uniq = np.empty(0, dtype=np.int64)
            self._hot_cnt = np.empty(0, dtype=np.int64)
        if self._node is None:
            return 0
        nbytes = sum(d.nbytes + v.nbytes for d, v in self._lanes)
        delta = nbytes - self._host_tracked
        self._host_tracked = nbytes
        return delta

    def _apply_host_delta(self, delta: int) -> None:
        if self._node is None or not delta:
            return
        if delta > 0:
            # lint: exempt[paired-resource] ownership transfer: the gathered build copy releases on close()
            self._node.consume(host=delta)
        else:
            self._node.release(host=-delta)

    def part_span(self, p: int) -> tuple[int, int]:
        return int(self._bounds[p]), int(self._bounds[p + 1])

    def part_rows(self, p: int) -> int:
        s, e = self.part_span(p)
        return e - s

    def build_rows(self, p: int) -> np.ndarray:
        """Global build row index per partition-local row (maps the
        matcher's ri back onto the original build chunk)."""
        s, e = self.part_span(p)
        return self._order[s:e]

    # -- residency / spill ---------------------------------------------------

    def ensure(self, p: int):
        """Device-resident key lanes for partition `p`, uploaded (and
        billed to the device ledger) on first touch or after a spill.
        Marks `p` active so the quota action cannot shed the partition
        it is making room for."""
        with self._mu:
            self._active = p
            ent = self._resident.get(p)
            if ent is not None:
                return ent[0]
            s, e = self.part_span(p)
            lanes = [(d[s:e], v[s:e]) for d, v in self._lanes]
        nbytes = self.kernel.build_nbytes(max(e - s, 1))
        if self._node is not None:
            # may fire the quota chain, including our own spill action,
            # which skips the active partition
            # lint: exempt[paired-resource] ownership transfer: resident-partition bytes release on evict/spill/close
            self._node.consume(device=nbytes)
        try:
            # partition upload (first touch / post-spill re-upload) is
            # a partition phase on the statement timeline
            with trace.span("join.partition", partition=p, upload=1,
                            rows=e - s):
                dev = self.kernel.prepare_build(lanes, e - s)
        except BaseException:
            if self._node is not None:
                self._node.release(device=nbytes)
            raise
        if self.stats is not None:
            self.stats.partition_uploads += 1
        with self._mu:
            self._resident[p] = (dev, nbytes)
        return dev

    def pin(self, p: int) -> None:
        """Mark one in-flight dispatch against partition `p`: until the
        matching unpin(), neither the quota spill nor a promotion credits
        the partition's device bytes back (the pending token still reads
        the buffers)."""
        with self._mu:
            self._pins[p] = self._pins.get(p, 0) + 1

    def unpin(self, p: int) -> None:
        """Drop one in-flight reference; frees any residency a promotion
        or eviction parked while the partition was pinned."""
        freed = 0
        with self._mu:
            left = self._pins.get(p, 1) - 1
            if left > 0:
                self._pins[p] = left
            else:
                self._pins.pop(p, None)
                for _dev, nbytes in self._zombies.pop(p, ()):
                    freed += nbytes
        if freed and self._node is not None:
            self._node.release(device=freed)

    def want_immediate(self, p: int) -> bool:
        """Probe partition `p` now? The hot lane and resident partitions
        always; cold partitions only until the first quota spill. After
        it their probe rows stage on the host and re-stream in the drain
        phase (re-uploading an evicted build per probe batch would thrash
        exactly the memory the spill just freed)."""
        with self._mu:
            return p == self.parts or p in self._resident or \
                not self._spill_fired

    def _quota_spill(self) -> None:
        """memtrack OOM action: shed every device-resident cold build
        partition except the active one and the pinned ones (and the hot
        lane, which stays: it is small by construction and carries the
        skew). Host key lanes remain, so spilled partitions re-stream
        later."""
        freed = 0
        dropped = []
        with self._mu:
            for p in list(self._resident):
                if p == self._active or p == self.parts or \
                        p in self._pins:
                    continue
                dev, nbytes = self._resident.pop(p)
                dropped.append(dev)
                freed += nbytes
                self.spilled += 1
            if dropped:
                self._spill_fired = True
        n = len(dropped)
        del dropped          # device references dropped outside the lock
        if freed:
            if self._node is not None:
                self._node.release(device=freed)
            metrics.counter(metrics.JOIN_SPILL_PARTITIONS, inc=n)

    def evict(self, p: int) -> None:
        """Voluntarily drop one resident partition (drain phase: a
        just-drained cold partition makes room for the next). A pinned
        partition parks in the zombie list until its unpin()."""
        with self._mu:
            ent = self._resident.pop(p, None)
            if self._active == p:
                self._active = -1
            if ent is not None and p in self._pins:
                self._zombies.setdefault(p, []).append(ent)
                ent = None
        if ent is not None and self._node is not None:
            self._node.release(device=ent[1])

    def under_pressure(self) -> bool:
        with self._mu:
            return self._spill_fired

    def close(self) -> None:
        """Release every ledgered byte, drop every device reference and
        unhook the spill action (the probe generator's finally)."""
        self._unregister()
        with self._mu:
            freed = sum(nb for _dev, nb in self._resident.values())
            freed += sum(nb for ents in self._zombies.values()
                         for _dev, nb in ents)
            self._resident.clear()
            self._zombies.clear()
            host = self._host_tracked
            self._host_tracked = 0
        if self._node is not None:
            if freed:
                self._node.release(device=freed)
            if host:
                self._node.release(host=host)

    # -- probe routing -------------------------------------------------------

    def route(self, pk, n: int):
        """Split one probe batch by partition. -> (hp, tasks) with
        tasks = [(pid, idx)] (idx ascending within each task) covering
        every probe row whose partition holds at least one build row;
        rows routed to an empty partition can match nothing and are left
        for the caller's unmatched handling."""
        hp = probe_hashes(pk, n)
        with self._mu:
            hot = self.hot
        is_hot = np.isin(hp, hot) if hot.size else None
        pid = partition_ids(hp, self.parts)
        if is_hot is not None:
            pid = np.where(is_hot, self.parts, pid)
            nhot = int(is_hot.sum())
            if nhot:
                self.hot_rows += nhot
                metrics.counter(metrics.JOIN_HOT_ROWS, inc=nhot)
        order = np.argsort(pid, kind="stable")
        spid = pid[order]
        tasks = []
        for p in range(self.parts + 1):
            s, e = np.searchsorted(spid, [p, p + 1])
            if e > s and self.part_rows(p) > 0:
                tasks.append((int(p), order[s:e]))
        return hp, tasks

    def hot_out_cap(self, hp_sub: np.ndarray) -> int | None:
        """EXACT pair capacity for a hot-lane dispatch: per-key build
        counts are known, so the matcher never pays an overflow retry
        however skewed the probe batch is."""
        if not self._hot_uniq.size:
            return None
        pos = np.searchsorted(self._hot_uniq, hp_sub)
        pos = np.clip(pos, 0, self._hot_uniq.size - 1)
        cnt = np.where(self._hot_uniq[pos] == hp_sub, self._hot_cnt[pos],
                       0)
        return runtime.bucket_size(max(int(cnt.sum()), 1024))

    # -- dynamic heavy-hitter promotion --------------------------------------

    def observe(self, hp: np.ndarray):
        """Feed the streaming probe-side CMSketch with one batch's key
        hashes; -> build hashes newly crossing the skew threshold (to pass
        to promote()), or None. Only keys already frequent WITHIN the
        batch are inserted (>= threshold/8), bounding sketch work."""
        if not self.threshold or self._promotions >= _MAX_PROMOTIONS:
            return None
        live = hp[hp != _DEAD_PROBE]
        if not live.size:
            return None
        from tidb_tpu_torch.statistics import CMSketch
        if self._obs is None:
            self._obs = CMSketch(depth=4, width=4096)
        uniq, cnt = np.unique(live, return_counts=True)
        sel = cnt >= max(1, self.threshold // 8)
        cand = []
        for hv, c in zip(uniq[sel].tolist(), cnt[sel].tolist()):
            key = _hash_key_bytes(hv)
            self._obs.insert(key, int(c))
            if self._obs.query(key) >= self.threshold:
                cand.append(hv)
        if not cand:
            return None
        arr = np.asarray(cand, dtype=np.int64)
        with self._mu:
            if self.hot.size:
                arr = arr[~np.isin(arr, self.hot)]
        arr = arr[np.isin(arr, self._build_uniq)]
        return arr if arr.size else None

    def promote(self, hashes: np.ndarray) -> bool:
        """Move newly-hot keys' build rows into the broadcast lane.
        Re-layouts the build (one argsort) and drops residency:
        partitions re-upload lazily with the new layout. Bounded by
        _MAX_PROMOTIONS / _MAX_HOT."""
        freed = 0
        with self._mu:
            if self._promotions >= _MAX_PROMOTIONS or \
                    self.hot.size + hashes.size > _MAX_HOT:
                return False
            self._promotions += 1
            self.hot = np.union1d(self.hot, hashes)
            for p in list(self._resident):
                ent = self._resident.pop(p)
                if p in self._pins:
                    # still read by an in-flight token: its bytes stay
                    # charged until its unpin() retires them
                    self._zombies.setdefault(p, []).append(ent)
                else:
                    freed += ent[1]
            delta = self._layout_locked()
        if freed and self._node is not None:
            self._node.release(device=freed)
        self._apply_host_delta(delta)
        return True


# -- partitioned aggregation -------------------------------------------------


# lint: exempt[memtrack-alloc] one int64 code lane over a chunk the caller already bills (the retry path's input)
def group_key_hashes(group_exprs, chunk) -> np.ndarray:
    """Host-side row hash over the group-key tuple (NULLs keyed
    distinctly, same contract as the device kernel's hash). Varlen lanes
    factorize to per-chunk int64 codes first."""
    n = chunk.num_rows
    lanes = []
    for g in group_exprs:
        d, v = g.eval(chunk)
        d = np.asarray(d)
        v = np.asarray(v, dtype=bool)
        if d.dtype == np.dtype(object):
            codes = np.zeros(n, dtype=np.int64)
            idx = np.flatnonzero(v)
            if idx.size:
                _vals, inv = np.unique(d[idx], return_inverse=True)
                codes[idx] = inv + 1
            d = codes
        lanes.append((d, v))
    return host_hash_keys(lanes, n, SEED)


# lint: exempt[memtrack-alloc] merged partial lanes: one row per LIVE GROUP, bounded by the agg state the caller already bills via approx_bytes
def concat_group_results(results: list[GroupResult], aggs) -> GroupResult:
    """Merge per-partition GroupResults whose key sets are DISJOINT (the
    partition id is a function of the full key hash) by concatenation."""
    results = [r for r in results if r is not None and len(r.keys)]
    if len(results) == 1:
        return results[0]
    if not results:
        return GroupResult(keys=[], partials=[[] for _ in aggs],
                           counts=np.empty(0, dtype=np.int64))
    keys = []
    for r in results:
        keys.extend(r.keys)
    partials = []
    for ai in range(len(aggs)):
        nlanes = len(results[0].partials[ai])
        partials.append([np.concatenate(
            [np.asarray(r.partials[ai][li]) for r in results])
            for li in range(nlanes)])
    counts = np.concatenate([np.asarray(r.counts) for r in results])
    return GroupResult(keys=keys, partials=partials, counts=counts)


def _note_fallback(stats, reason: str) -> None:
    if stats is not None:
        stats.note_fallback(reason)


def _one_partition_agg(sub, filter_expr, group_exprs, aggs, stats,
                       reason: str, device) -> GroupResult:
    """Device agg over ONE partition's rows with its own capacity-
    escalation chain; only this partition lands on the host if the
    device still cannot serve it."""
    from tidb_tpu_torch.ops.hostagg import host_hash_agg
    cap = _BASE_AGG_CAPACITY
    # one partition = one span: how long each radix partition held the
    # device, and which ones fell to the host
    with trace.span("join.partition", rows=sub.num_rows):
        while True:
            try:
                k = kernel_for(filter_expr, group_exprs, aggs,
                               capacity=cap, device=device)
                with sched.device_slot():
                    return k(sub)
            except CapacityError as e:
                nxt = escalated_capacity(getattr(e, "needed", 0))
                if nxt is None or nxt <= cap:
                    reason = "capacity"
                    break
                cap = nxt
            except CollisionError:
                reason = "collision"
                break
            except (DeviceRejectError, NotImplementedError):
                reason = "unsupported"
                break
        _note_fallback(stats, reason)
        with meter.busy_section("host"), \
                trace.span("host.fallback", rows=sub.num_rows):
            return host_hash_agg(sub, filter_expr, group_exprs, aggs)


def partitioned_agg(chunk, filter_expr, group_exprs, aggs, stats=None,
                    parts: int | None = None, reason: str = "capacity",
                    device=None) -> GroupResult:
    """Radix-partitioned device aggregation: the retry that replaces the
    whole-operator host fallback after a capacity/collision miss.

    Rows radix-partition by group-key hash on the host; each partition
    re-runs the device kernel with its own escalation chain; a partition
    that still misses aggregates on the host ALONE (counted on `stats` as
    a fallback with the surviving reason). Row order within a partition
    is preserved, so FIRST_ROW/representative-row semantics match the
    unpartitioned kernel."""
    from tidb_tpu_torch.ops.hostagg import host_hash_agg
    device = runtime.resolve_device(device)
    parts = config.join_partitions() if parts is None else parts
    n = chunk.num_rows
    if parts <= 1 or not group_exprs or n == 0:
        _note_fallback(stats, reason)
        return host_hash_agg(chunk, filter_expr, group_exprs, aggs)
    try:
        h = group_key_hashes(group_exprs, chunk)
    except TypeError:
        # unorderable key values: the host path evaluates them row-wise
        _note_fallback(stats, reason)
        return host_hash_agg(chunk, filter_expr, group_exprs, aggs)
    pid = partition_ids(h, parts)
    order = np.argsort(pid, kind="stable")
    bounds = np.searchsorted(pid[order], np.arange(parts + 1))
    results = []
    for p in range(parts):
        idx = order[bounds[p]:bounds[p + 1]]
        if not idx.size:
            continue
        results.append(_one_partition_agg(chunk.take(idx), filter_expr,
                                          group_exprs, aggs, stats, reason,
                                          device))
    return concat_group_results(results, aggs)


def agg_retry(chunk, filter_expr, group_exprs, aggs, err, stats=None,
              device=None) -> GroupResult:
    """Full recovery chain after a device agg miss `err`: one whole-chunk
    escalated retry on capacity, then the radix-partitioned path. Never
    raises the miss onward: the worst case is per-partition host
    aggregation."""
    reason = "collision" if isinstance(err, CollisionError) else "capacity"
    if isinstance(err, CapacityError):
        cap = escalated_capacity(getattr(err, "needed", 0))
        if cap is not None:
            try:
                k = kernel_for(filter_expr, group_exprs, aggs,
                               capacity=cap, device=device)
                with sched.device_slot():
                    return k(chunk)
            except (CapacityError, CollisionError) as e2:
                reason = "collision" if isinstance(e2, CollisionError) \
                    else "capacity"
            except (DeviceRejectError, NotImplementedError):
                from tidb_tpu_torch.ops.hostagg import host_hash_agg
                _note_fallback(stats, "unsupported")
                return host_hash_agg(chunk, filter_expr, group_exprs, aggs)
    return partitioned_agg(chunk, filter_expr, group_exprs, aggs, stats,
                           reason=reason, device=device)
