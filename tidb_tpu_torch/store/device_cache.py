"""HBM-resident columnar region-block cache: hot columns live where the
compute is.

The port's copy of the JAX package's store/device_cache.py. The storage
node keeps the PADDED, DICT-ENCODED device tensors of each region block
resident on the card, keyed by (region, schema fingerprint, range) and
validated by the engine's data version, so a repeated scan reads
straight from device memory and the fused scan->filter->partial-agg
dispatch (store/copr.py) starts from resident columns.

MVCC correctness is inherited from the chunk cache's contract — the
(fill_version, fill_ts, delta_watermark) freshness triple
(store/chunk_cache.py): an entry records the engine's STRUCTURAL
data_version and the fill snapshot ts, and is served only when the
version is unchanged AND read_ts >= fill_ts. Committed ROW mutations are
journaled by the delta store (store/delta.py) and folded INTO the
resident block on the device: get() applies the journal window
(fill_ts, read_ts] (updates overwrite, deletes swap-remove, inserts fill
the padding tail, dict columns extend incrementally) and advances
fill_ts to the delta watermark, so an OLTP write stream does not re-cold
the device tier.

Budget: `tidb_tpu_device_cache_bytes` bounds resident bytes with LRU
eviction (re-read on every lookup and fill). Residency is charged to the
`hbm-cache` memtrack node under the SERVER root (device ledger), and
`shed()` is registered on SERVER's spill-action chain, so one call
reclaims every live cache.

Torch in place of XLA: a block is one `runtime.device_put_chunk` upload
(one pinned buffer, one copy, no memo on the chunk); the patch's
functional `data.at[idx].set(v)` becomes a `clone()` of the resident
tensor followed by `index_copy_`, so readers holding the old block keep
an immutable snapshot; its index vectors and delta lanes travel to the
card in one pinned, non-blocking copy, and nothing in it reads a device
value back.

On a device plane of more than one shard (devplane.py) a block is
replicated, as in the reference: one copy on the cache's device and one
on each OTHER distinct device of the plane (`DeviceBlock.replicas`,
patched with the primary). The reference holds one copy per chip and
bills nbytes x ndev; here shards that share a device share its copy,
and fill() bills nbytes x the copies actually held (`block_replicas`),
so the hbm-cache ledger equals the resident bytes on every plane.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict

import numpy as np
import torch

from tidb_tpu_torch import config, memtrack, metrics, trace
from tidb_tpu_torch.util import failpoint

__all__ = ["DeviceBlock", "DeviceCache", "upload_block", "scatter_block",
           "tracker", "shed_all", "block_replicas", "replica_devices"]


_tracker_lock = threading.Lock()
_tracker: memtrack.MemTracker | None = None   # guarded-by: _tracker_lock

# every live cache, for the single server-wide OOM shed action; weak so
# short-lived test storages don't accumulate forever
_caches: "weakref.WeakSet[DeviceCache]" = \
    weakref.WeakSet()               # guarded-by: _tracker_lock
_shed_registered = False            # guarded-by: _tracker_lock


def tracker() -> memtrack.MemTracker:
    """The shared server-scope tracker node all device caches charge
    (label `hbm-cache`, device ledger)."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = memtrack.server_node("hbm-cache")
        return _tracker


def _shed_all() -> None:
    """The registered memtrack OOM action: drop every resident block in
    every live cache, returning the hbm-cache ledger to zero. The
    WeakSet is snapshotted under its lock — iterating it bare races a
    concurrent cache construction's add() and raises RuntimeError,
    which the spill chain would silently swallow."""
    with _tracker_lock:
        caches = list(_caches)
    for cache in caches:
        cache.shed()


def shed_all() -> None:
    """Invalidate every resident block in every live cache — the
    memtrack OOM action, and the device-quarantine path
    (sched.DeviceHealth): blocks uploaded through a faulting device
    plane are not trustworthy, and nothing can consume them while the
    device is quarantined anyway."""
    _shed_all()


def _release_resident(resident: list) -> None:
    """GC finalizer: credit back whatever a dead cache still held."""
    freed, resident[0] = resident[0], 0
    if freed:
        tracker().release(device=freed)


def _register(cache: "DeviceCache") -> None:
    global _shed_registered
    with _tracker_lock:
        _caches.add(cache)
        if not _shed_registered:
            memtrack.SERVER.add_spill_action(_shed_all)
            _shed_registered = True


def upload_block(chunk, size: int, device):
    """The ONE upload site for region columns: pad + dict-encode + copy
    every column to `device` without the per-chunk memo (the cache owns
    residency; a second resident copy memoized on the chunk would double
    device memory). -> (cols, dicts)."""
    from tidb_tpu_torch.ops import runtime
    return runtime.device_put_chunk(chunk, device, size, memo=False)


def _same_device(a, b) -> bool:
    """Device equality with "cuda" read as the current CUDA device."""
    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


def replica_devices(device) -> list:
    """The devices other than `device` on which a block uploaded NOW keeps
    a copy: the other distinct devices of a plane of more than one shard
    (none without one)."""
    from tidb_tpu_torch import devplane
    mesh = devplane.active_mesh()
    if mesh is None or devplane.ndev(mesh) <= 1:
        return []
    return [d for d in mesh.distinct() if not _same_device(d, device)]


def block_replicas(device) -> int:
    """Copies of a block uploaded NOW: fill() bills nbytes x this, so the
    hbm-cache ledger carries the plane's true footprint."""
    return 1 + len(replica_devices(device))


def _to_device(host_arrays, device):
    """Numpy arrays (int64/float64 first, then bool) -> tensors on
    `device`, packed into ONE pinned host buffer and copied with one
    non-blocking copy (a CPU device uses the buffer as it is)."""
    from tidb_tpu_torch.ops import runtime
    sizes = [a.nbytes for a in host_arrays]
    total = sum(sizes)
    host = torch.empty(max(total, 1), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    # lint: exempt[device-sync] `host` is the pinned HOST staging buffer: .numpy() views its bytes, no device copy
    hb = host.numpy()
    views, off = [], 0
    for a, nb in zip(host_arrays, sizes):
        hb[off:off + nb].view(a.dtype)[:] = a
        views.append((off, nb, a.dtype))
        off += nb
    buf = host.to(device, non_blocking=True) if device.type == "cuda" \
        else host
    runtime.note_put(total)
    tdt = {np.dtype(np.int64): torch.int64,
           np.dtype(np.float64): torch.float64,
           np.dtype(bool): torch.bool}
    return [buf[o:o + nb].view(tdt[np.dtype(dt)]) for o, nb, dt in views]


def scatter_block(cols, move_src, move_dst, write_idx, wvals, wvalids,
                  device) -> list:
    """B11's device program: the resident lanes `cols` ([(data, valid)])
    -> new lanes where the rows at `move_src` moved to `move_dst`
    (gathered from the pre-move block), then `wvals[j]` / `wvalids[j]`
    written at `write_idx` in column j. Each lane is a clone() of the
    resident tensor plus index_copy_, so readers holding the old block
    keep it; the index vectors and the delta lanes travel in one pinned
    copy. Enqueued on the device's stream, no host sync."""
    dev = _to_device([move_src, move_dst, write_idx] + wvals + wvalids,
                     device)
    d_msrc, d_mdst, d_widx = dev[:3]
    d_vals, d_valids = dev[3:3 + len(wvals)], dev[3 + len(wvals):]
    new_cols = []
    for j, (data, valid) in enumerate(cols):
        nd, nv = data.clone(), valid.clone()
        if len(move_src):
            # movers first, gathered from the pre-move block
            nd.index_copy_(0, d_mdst, data.index_select(0, d_msrc))
            nv.index_copy_(0, d_mdst, valid.index_select(0, d_msrc))
        if len(write_idx):
            nd.index_copy_(0, d_widx, d_vals[j])
            nv.index_copy_(0, d_widx, d_valids[j])
        new_cols.append((nd, nv))
    return new_cols


_TORCH_OF = {np.dtype(np.int64): torch.int64,
             np.dtype(np.float64): torch.float64}


class DeviceBlock:
    """One resident region block: the padded device columns exactly as a
    kernel dispatch consumes them, plus the host dictionaries needed to
    decode varlen lanes.

    Blocks are IMMUTABLE once handed out: the delta patch path
    (apply-pending, store/delta.py) builds a NEW block from scatter
    updates over this one's device arrays and swaps the cache entry, so
    a reader that captured this block mid-dispatch keeps a consistent
    (cols, nrows) pair. `handles`/`pos_handles`/`hmap` are the
    host-side row-position index that makes the device patch possible;
    they hand off to the successor block (only the entry's current
    block is ever patched)."""

    __slots__ = ("cols", "dicts", "nrows", "size", "nbytes",
                 "handles", "pos_handles", "hmap", "dictmaps", "patched",
                 "host_rows", "replicas")

    def __init__(self, cols, dicts, nrows: int, size: int, nbytes: int,
                 handles=None, replicas=None):
        self.cols = cols
        # device -> the same lanes on another device of the plane
        self.replicas = replicas or {}
        self.dicts = dicts
        self.nrows = nrows
        self.size = size
        self.nbytes = nbytes
        self.handles = handles      # np int64 [nrows] or None
        self.pos_handles = None     # np int64 [size], built lazily
        self.hmap = None            # handle -> row position
        self.dictmaps = None        # col idx -> value -> code
        # a patched block's rows are in device order (swap-removes,
        # tail appends), not the host chunk's handle order
        self.patched = False
        self.host_rows = None       # (host chunk, its view in this order)


class DeviceCache:
    """LRU over device-resident region blocks, bounded by the
    `tidb_tpu_device_cache_bytes` budget (read per operation, so SET
    takes effect immediately), accounted on the shared hbm-cache
    memtrack node."""

    def __init__(self, device=None):
        from tidb_tpu_torch.ops.runtime import resolve_device
        self.device = resolve_device(device)
        self._mu = threading.Lock()
        self._entries: OrderedDict = OrderedDict()   # guarded-by: _mu
        # resident bytes live in a one-slot list shared with a GC
        # finalizer: a cache dropped without close() (test storages,
        # abandoned servers) still returns its ledger share, so the
        # hbm-cache node stays exact over the process lifetime
        self._resident = [0]        # guarded-by: _mu
        # bytes dropped under the lock, not settled
        self._pending = 0           # guarded-by: _mu
        self.patches = 0            # guarded-by: _mu  blocks patched
        weakref.finalize(self, _release_resident, self._resident)
        _register(self)

    @staticmethod
    def key(region, plan, s: bytes, e: bytes):
        """(region, schema fingerprint, range): region id+version, table/
        index ids, the column ids AND their field-type codes (a DDL that
        re-types a column without re-numbering it must not alias), the
        handle flag, and the clamped scan range."""
        from tidb_tpu_torch.store.chunk_cache import ChunkCache
        return (ChunkCache.key(region, plan, s, e),
                tuple(getattr(c.ft, "tp", None) for c in plan.cols))

    def enabled(self) -> bool:
        """Consulted on every agg request. A budget of 0 not only stops
        lookups, it RECLAIMS: resident blocks shed on the next consult,
        so `SET tidb_tpu_device_cache_bytes = 0` actually frees the HBM
        it promises to (the shrink-on-lookup path in get() is
        unreachable once this gate stops all lookups). A transient
        `tidb_tpu_device = 0` keeps residency: flipping the device off
        and on must not cold-start the cache."""
        if config.device_cache_bytes() <= 0:
            if self._resident[0]:
                self.shed()
            return False
        return config.device_enabled()

    def resident_bytes(self) -> int:
        with self._mu:
            return self._resident[0]

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    # -- lookup / fill -------------------------------------------------------

    def get(self, key, data_version: int, read_ts: int,
            pend_fn=None) -> DeviceBlock | None:
        """Resident block for `key`, valid for a reader at `read_ts`
        under the current engine `data_version`; a version/ts mismatch
        drops the stale entry (counted as an eviction). The budget is
        re-read here too, so a shrunk `tidb_tpu_device_cache_bytes`
        takes effect on the next lookup — not only at the next fill —
        evicting LRU entries (the served block last) until residency
        fits.

        `pend_fn(lo_ts, hi_ts)` — supplied by the coprocessor serve
        path (store/copr.py) — returns the table's staged delta for
        this block's range in (lo_ts, hi_ts] (store/delta.py): a
        PendingDelta with its plan-layout decode, delta.STALE when the
        journal was truncated under the entry, or None. A pending delta
        is folded INTO the resident block in place — value/validity
        scatters plus tail appends into the padding, dict columns
        extended incrementally — and the entry's fill_ts advances to
        the watermark, so the HBM plane stays hot across OLTP writes
        instead of re-uploading the whole block."""
        budget = config.device_cache_bytes()
        for _ in range(4):      # bounded retry under patch races
            with self._mu:
                ent = self._entries.get(key)
                if ent is None:
                    metrics.counter(metrics.HBM_CACHE_MISSES)
                    return None
                fill_version, fill_ts, block = ent
                if fill_version != data_version:
                    # stale for EVERY reader: drop now, not at LRU
                    # pressure
                    self._drop_locked(key)
                    metrics.counter(metrics.HBM_CACHE_MISSES)
                    metrics.counter(metrics.HBM_CACHE_EVICTIONS)
                    stale = True
                elif read_ts < fill_ts:
                    # too old for THIS reader only — newer snapshots
                    # still serve from it, so the entry stays
                    metrics.counter(metrics.HBM_CACHE_MISSES)
                    return None
                else:
                    stale = False
            if stale:
                self._settle()
                return None
            # the delta query + plan-layout decode run with _mu
            # dropped; the patch below re-validates the entry under it
            pend = pend_fn(fill_ts, read_ts) if pend_fn is not None \
                else None
            if pend is None:
                with self._mu:
                    if self._entries.get(key) is not None:
                        self._entries.move_to_end(key)
                    while self._resident[0] > budget and self._entries:
                        self._drop_locked(next(iter(self._entries)))
                        metrics.counter(metrics.HBM_CACHE_EVICTIONS)
                    # the served block stays alive through the returned
                    # reference even if it was the one over budget; it
                    # is simply no longer resident for the next reader
                    metrics.counter(metrics.HBM_CACHE_HITS)
                self._settle()
                return block
            if getattr(pend, "watermark", None) is None:
                # delta.STALE sentinel: journal truncated under the
                # entry — it cannot be patched forward any more
                self.drop(key, if_block=block)
                metrics.counter(metrics.HBM_CACHE_MISSES)
                self._settle()
                return None
            with self._mu:
                ent2 = self._entries.get(key)
                if ent2 is None or ent2[2] is not block or \
                        ent2[1] != fill_ts:
                    continue    # raced with another patch: re-evaluate
                with trace.span("hbm.patch",
                                rows=len(pend.upsert_handles)):
                    patched = self._patch_locked(key, ent2, pend)
            if patched is not None:
                with self._mu:
                    self.patches += 1
                metrics.counter(metrics.HBM_CACHE_HITS)
                self._settle()
                # THIS thread's patched block — at exactly pend's
                # watermark — never the entry's current one: a newer
                # reader may already have patched past this reader's
                # read_ts, and handing that block back here would leak
                # later commits into an older snapshot
                return patched
            # unpatchable (no handles, dtype drift, tail overflow):
            # drop; the caller re-fills from the merged host chunk
            self.drop(key, if_block=block)
            metrics.counter(metrics.HBM_CACHE_MISSES)
            self._settle()
            return None
        metrics.counter(metrics.HBM_CACHE_MISSES)
        return None

    def fill(self, key, data_version: int, fill_ts: int,
             chunk) -> DeviceBlock | None:
        """Upload `chunk`'s padded columns and insert. Returns None (no
        upload) when the block alone would exceed the budget. The caller
        owns the MVCC fill contract (see module docstring)."""
        from tidb_tpu_torch.ops.runtime import bucket_size
        # injectable upload fault: a raise here (chaos arms
        # DeviceFaultError) is a device-plane fault the dispatch
        # site's retry/degrade chain absorbs
        failpoint.eval("hbm/fill")
        budget = config.device_cache_bytes()
        size = bucket_size(max(chunk.num_rows, 1))
        # a plane of several devices replicates the block to each of
        # them: the budget sees every copy
        others = replica_devices(self.device)
        nbytes = memtrack.device_put_bytes(chunk, size) * (1 + len(others))
        if nbytes > budget:
            return None
        with trace.span("hbm.fill", rows=chunk.num_rows, bytes=nbytes):
            cols, dicts = upload_block(chunk, size, self.device)
            replicas = {d: upload_block(chunk, size, d)[0] for d in others}
        block = DeviceBlock(cols, dicts, chunk.num_rows, size, nbytes,
                            handles=getattr(chunk, "_scan_handles",
                                            None), replicas=replicas)
        with self._mu:
            if key in self._entries:
                self._drop_locked(key)
            self._entries[key] = (data_version, fill_ts, block)
            self._resident[0] += nbytes
            while self._resident[0] > budget and len(self._entries) > 1:
                old = next(iter(self._entries))
                if old == key:      # never evict the entry just filled
                    break
                self._drop_locked(old)
                metrics.counter(metrics.HBM_CACHE_EVICTIONS)
        # lint: exempt[paired-resource] ownership transfer: residency releases on evict/shed; a GC finalizer backstops dead caches
        tracker().consume(device=nbytes)
        # evictions released under the lock tally in _pending_release;
        # settle them against the shared tracker outside the lock
        self._settle()
        return block

    def get_or_fill(self, key, data_version: int, read_ts: int, chunk,
                    fill_ts: int | None = None,
                    pend_fn=None) -> DeviceBlock | None:
        """get(); on miss, fill() when `fill_ts` is provided (the
        caller's signal that the MVCC fill conditions hold). `chunk` is
        the HOST-side truth for this reader — on the delta path the
        base⋈delta merge — so an unpatchable block re-fills from
        exactly the state the entry's new fill_ts describes."""
        hit = self.get(key, data_version, read_ts, pend_fn=pend_fn)
        if hit is not None:
            return hit
        if fill_ts is None:
            return None
        return self.fill(key, data_version, fill_ts, chunk)

    # -- the in-place delta patch (store/delta.py) ---------------------------

    def _patch_locked(self, key, ent, pend) -> "DeviceBlock | None":
        """Fold one PendingDelta into the entry's resident block:
        updates overwrite rows in place, deletes swap-remove (order is
        free — only agg plans consume resident blocks), inserts land in
        the padding tail (or freed holes), dict columns extend
        incrementally. Builds a NEW DeviceBlock over the scattered
        device arrays and swaps the entry, so concurrent readers keep a
        consistent (cols, nrows) snapshot. -> False when the block
        cannot be patched (no handles, layout drift, tail overflow);
        the caller then drops it and re-fills from the merged host
        chunk. Called under _mu; the clones and index copies are queued
        on the device's stream, never a host sync."""
        # injectable patch fault, fired BEFORE any state mutates (an
        # armed raise leaves the entry exactly as it was; _mu releases
        # on unwind). A returned sentinel simulates "unpatchable":
        # the caller drops the block and re-fills from the host chunk
        if failpoint.eval("hbm/patch") is not None:
            return None
        fill_version, _fill_ts, block = ent
        dchunk = pend.decoded
        if block.handles is None or dchunk is None or \
                dchunk.num_cols != len(block.cols):
            return None
        nrows, size = block.nrows, block.size
        if block.hmap is None:
            ph = np.full(size, -1, dtype=np.int64)
            ph[:nrows] = block.handles[:nrows]
            block.pos_handles = ph
            block.hmap = {int(h): i
                          for i, h in enumerate(block.handles[:nrows])}
        hmap, pos_handles = block.hmap, block.pos_handles
        upd_idx: list = []
        upd_src: list = []
        app_src: list = []
        dead: list = []
        for i, h in enumerate(pend.upsert_handles.tolist()):
            p = hmap.get(h)
            if p is not None:
                upd_idx.append(p)
                upd_src.append(i)
            else:
                app_src.append(i)
        for h in pend.delete_handles.tolist():
            p = hmap.get(h)
            if p is not None:
                dead.append(p)
        new_nrows = nrows - len(dead) + len(app_src)
        if new_nrows > size:
            return None             # padding exhausted: re-fill
        dead_set = set(dead)
        free = sorted(p for p in dead if p < new_nrows)
        if new_nrows > nrows:
            free.extend(range(nrows, new_nrows))
        # live rows stranded past the new row count move into leftover
        # holes (values gathered on device, no host round trip)
        movers = [p for p in range(new_nrows, nrows)
                  if p not in dead_set]
        app_dst = free[:len(app_src)]
        holes = free[len(app_src):]
        if len(holes) != len(movers):
            return None             # accounting drift: bail safely
        move_map = dict(zip(movers, holes))
        # pad index vectors to powers of two, repeating the last entry
        # (a duplicate index copies the same value, so index_copy_ stays
        # deterministic): the scatters see log2 shapes, as the
        # reference's compiled ones do
        write_idx, write_rows = self._pad_pow2(
            np.asarray([move_map.get(p, p) for p in upd_idx] + app_dst,
                       dtype=np.int64),
            np.asarray(upd_src + app_src, dtype=np.int64))
        move_src, move_dst = self._pad_pow2(
            np.asarray(movers, dtype=np.int64),
            np.asarray(holes, dtype=np.int64))
        wvals, wvalids = [], []
        for j, (data, _valid) in enumerate(block.cols):
            col = dchunk.columns[j]
            if j in block.dicts:
                codes, cvalid = self._encode_against(block, j, col)
            else:
                if _TORCH_OF.get(np.dtype(col.data.dtype)) != data.dtype:
                    return None     # layout drift since the fill
                codes, cvalid = col.data, col.valid
            wvals.append(np.ascontiguousarray(codes[write_rows]))
            wvalids.append(np.ascontiguousarray(cvalid[write_rows],
                                                dtype=bool))
        new_cols = scatter_block(block.cols, move_src, move_dst, write_idx,
                                 wvals, wvalids, self.device)
        new_reps = {d: scatter_block(rc, move_src, move_dst, write_idx,
                                     wvals, wvalids, d)
                    for d, rc in block.replicas.items()}
        # host-side position index follows the same moves/writes
        for src, dst in move_map.items():
            h = int(pos_handles[src])
            pos_handles[dst] = h
            hmap[h] = dst
        for p, i in zip(write_idx.tolist(), write_rows.tolist()):
            h = int(pend.upsert_handles[i])
            pos_handles[p] = h
            hmap[h] = p
        for h in pend.delete_handles.tolist():
            hmap.pop(int(h), None)
        pos_handles[new_nrows:nrows] = -1
        nb = DeviceBlock(new_cols, block.dicts, new_nrows, size,
                         block.nbytes, handles=None, replicas=new_reps)
        # the position index hands off: only the entry's CURRENT block
        # is ever patched, the predecessor keeps serving readers that
        # already hold it
        nb.pos_handles, nb.hmap = pos_handles, hmap
        nb.dictmaps = block.dictmaps
        nb.patched = True
        nb.handles = nb.pos_handles[:new_nrows]
        block.hmap = block.pos_handles = None
        self._entries[key] = (fill_version, pend.watermark, nb)
        return nb

    @staticmethod
    def _pad_pow2(*arrs):
        """Pad parallel index vectors to the next power of two by
        repeating their last element — scatter-idempotent padding."""
        n = len(arrs[0])
        if n == 0:
            return arrs
        b = 1
        while b < n:
            b <<= 1
        if b == n:
            return arrs
        return tuple(np.concatenate([a, np.repeat(a[-1:], b - n)])
                     for a in arrs)

    @staticmethod
    def _encode_against(block: DeviceBlock, j: int, col):
        """Dict-encode a delta column against the block's existing
        dictionary, EXTENDING it for unseen values (new codes append;
        old codes — and every reader holding them — stay valid).
        Mirrors chunk.dict_encode's collation keying."""
        values = block.dicts[j]
        if block.dictmaps is None:
            block.dictmaps = {}
        dmap = block.dictmaps.get(j)
        ci = col.ft.is_ci
        if ci:
            from tidb_tpu_torch.sqltypes import collation_key
        if dmap is None:
            if ci:
                dmap = {collation_key(v): c
                        for c, v in enumerate(values)}
            else:
                dmap = {v: c for c, v in enumerate(values)}
            block.dictmaps[j] = dmap
        codes = np.empty(len(col), dtype=np.int64)
        data, valid = col.data, col.valid
        for i in range(len(col)):
            if not valid[i]:
                codes[i] = -1
                continue
            v = data[i]
            k = collation_key(v) if ci else v
            c = dmap.get(k)
            if c is None:
                c = len(values)
                dmap[k] = c
                values.append(v)
            codes[i] = c
        return codes, valid & (codes >= 0)

    # -- eviction ------------------------------------------------------------

    def _drop_locked(self, key) -> None:
        _v, _t, block = self._entries.pop(key)
        self._resident[0] -= block.nbytes
        self._pending += block.nbytes

    def _settle(self) -> None:
        with self._mu:
            owed, self._pending = self._pending, 0
        if owed:
            tracker().release(device=owed)

    def drop(self, key, if_block: DeviceBlock | None = None) -> int:
        """Remove one entry (delta staleness, merge refresh). With
        `if_block`, drop only while the entry still holds that exact
        block — a reader invalidating a lagging block must not discard
        a successor another thread just patched/refilled in. -> bytes
        freed."""
        with self._mu:
            ent = self._entries.get(key)
            if ent is None or (if_block is not None and
                               ent[2] is not if_block):
                return 0
            freed = ent[2].nbytes
            self._drop_locked(key)
        metrics.counter(metrics.HBM_CACHE_EVICTIONS)
        self._settle()
        return freed

    def restamp(self, key, fill_ts: int, new_ts: int) -> bool:
        """Advance a resident block's fill snapshot from `fill_ts` to
        `new_ts` without touching the device (the delta merge, for a
        region no write touched in between); False when the entry is
        gone or was patched or re-filled meanwhile."""
        with self._mu:
            ent = self._entries.get(key)
            if ent is None or ent[1] != fill_ts:
                return False
            self._entries[key] = (ent[0], new_ts, ent[2])
            return True

    def snapshot_table(self, table_id: int) -> list:
        """[(key, fill_version, fill_ts)] for every resident block of
        one table — the delta merge walks this to refresh lagging
        blocks. Device keys are (chunk-cache key, ft codes); the chunk
        key embeds the table id at position 2."""
        with self._mu:
            return [(k, ent[0], ent[1])
                    for k, ent in self._entries.items()
                    if k[0][2] == table_id]

    def shed(self) -> int:
        """Drop every resident block (the OOM action / close path).
        -> bytes freed."""
        with self._mu:
            freed = self._resident[0]
            n = len(self._entries)
            self._entries.clear()
            self._resident[0] = 0
        if n:
            metrics.counter(metrics.HBM_CACHE_EVICTIONS, inc=n)
        if freed:
            tracker().release(device=freed)
        self._settle()
        return freed
