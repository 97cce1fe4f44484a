"""Fleet-side coprocessor serving: a stateless SQL server's OWN caches.

In fleet mode (store/remote.py `connect(..., local_cache=True)`) each
SQL-server process keeps its own columnar chunk cache and HBM device
cache, exactly the hierarchy a storage node runs (store/copr.py
exec_cached_cop). What a remote process cannot see is the store plane's
engine state — so before serving a region task locally it issues ONE
journal-window RPC (mockstore/rpc.py `journal_window`, Cmd 80) that
returns the engine's freshness meta (data_version / max_commit_ts /
lock state) plus the delta-journal window (fill_ts, read_ts] for the
task's range. The reply primes lookalike views of the engine and the
delta store, and the UNCHANGED cached-serve path runs against them:

  * resident block + empty window        -> serve as-is
  * resident block + shipped window      -> patch in place (base ⋈ delta,
                                            store/delta.py semantics)
  * journal truncated under the fill     -> STALE: drop, re-scan remotely
  * no resident block                    -> remote kv_scan fills the local
                                            cache (MVCC fill conditions
                                            re-checked against the meta)

MVCC correctness is the single-process argument verbatim: data_version
and max_commit_ts are sampled (via the meta RPC) BEFORE any scan, row
commits landing after the sample carry commit_ts > start_ts and ride
the journal, structural writes bump the version so the filled entry can
never serve a newer reader. A reader at T applies only deltas with
commit_ts <= T — the window the RPC ships is exactly (fill_ts, T].
Region epoch is checked by the store plane on the journal-window RPC
itself, so split/truncation races surface as RegionError into the
coprocessor client's existing re-locate/retry loop.

The port's copy of the JAX package's store/fleetcop.py: the views plug
into the port's `copr.exec_cached_cop` and chunk cache unchanged, and a
locally served task's kernels (HashAggKernel, whose sum lanes go to the
hand-written segment sum) run on this SQL server's own device.
"""

from __future__ import annotations

from tidb_tpu_torch import config, metrics
from tidb_tpu_torch.store import copr
from tidb_tpu_torch.store import delta as deltamod

__all__ = ["exec_local"]


def _decode_wire_delta(d):
    """Wire-native journal window -> delta.py's read-side vocabulary.
    The STALE sentinel cannot cross the wire; it travels as "stale"."""
    if d is None:
        return None
    if d == "stale":
        return deltamod.STALE
    _tag, watermark, upsert_rows, upsert_handles, delete_handles = d
    return deltamod.PendingDelta(watermark, list(upsert_rows),
                                 upsert_handles, delete_handles)


def _pull_outcome(meta, fill_ts) -> str:
    if fill_ts is None:
        return "meta"
    d = meta.get("delta")
    if d == "stale" or meta.get("index_stale"):
        return "stale"
    return "empty" if d is None else "window"


class _EngineView:
    """MVCCStore-lookalike over one meta sample + remote scans. The
    freshness fields are frozen at the RPC: that IS the version-sampled-
    before-scan discipline of the local path."""

    def __init__(self, shim, ctx, meta):
        self._shim = shim
        self._ctx = ctx
        self.data_version = meta["data_version"]
        self.max_commit_ts = meta["max_commit_ts"]
        # truthiness is all the serve path consults (cacheable veto)
        self._locked_keys = ("remote",) if meta["any_locks"] else ()
        self._range_locked = meta["locked"]

    def locked_in_range(self, s, e, ts) -> bool:
        return self._range_locked

    def scan(self, start, end, limit, ts, isolation, desc=False):
        # KeyLockedError raised store-side rides the wire typed and
        # reaches the cop client's resolve loop unchanged
        return self._shim.kv_scan(self._ctx, start, end, limit, ts,
                                  isolation=isolation, desc=desc)


class _DeltaView:
    """DeltaStore-lookalike serving journal windows pulled over the
    wire. The task's own (fill_ts, read_ts] window arrives primed on
    the meta RPC; any other window a consumer asks for — the HBM entry
    may lag or lead the host entry — is one more pull."""

    def __init__(self, shim, ctx, table_id, s, e, index_id):
        self._shim = shim
        self._ctx = ctx
        self._table_id = table_id
        self._s = s
        self._e = e
        self._index_id = index_id
        self._windows: dict = {}    # (s, e, lo, hi) -> pending|None|STALE
        self._index: dict = {}      # (lo, hi) -> bool

    def enabled(self) -> bool:
        return True

    def prime(self, s, e, lo_ts, hi_ts, wire_delta) -> None:
        self._windows[(s, e, lo_ts, hi_ts)] = _decode_wire_delta(wire_delta)

    def prime_index(self, lo_ts, hi_ts, stale) -> None:
        self._index[(lo_ts, hi_ts)] = bool(stale)

    def pending(self, table_id, s, e, lo_ts, hi_ts):
        k = (s, e, lo_ts, hi_ts)
        if k not in self._windows:
            meta = self._shim.journal_window(self._ctx, table_id, s, e,
                                             lo_ts, hi_ts)
            outcome = _pull_outcome(meta, lo_ts)
            metrics.counter(metrics.FLEET_JOURNAL_PULLS,
                            {"outcome": outcome})
            self._windows[k] = _decode_wire_delta(meta.get("delta"))
        return self._windows[k]

    def index_stale(self, table_id, fill_ts, read_ts) -> bool:
        k = (fill_ts, read_ts)
        if k not in self._index:
            meta = self._shim.journal_window(
                self._ctx, table_id, self._s, self._e, fill_ts, read_ts,
                index_id=self._index_id)
            outcome = _pull_outcome(meta, fill_ts)
            metrics.counter(metrics.FLEET_JOURNAL_PULLS,
                            {"outcome": outcome})
            self._index[k] = bool(meta.get("index_stale"))
        return self._index[k]

    def note_base_rows(self, table_id, nrows) -> None:
        # merge-trigger feedback is the store plane's concern; remote
        # base sizes reach it via the scans themselves
        pass

    def patch_chunk(self, cache, key, plan, chunk, pend):
        # the fold itself is pure host-side chunk algebra + per-chunk
        # memoization: borrow the real implementation unbound
        merged = deltamod.DeltaStore.patch_chunk(self, cache, key, plan,
                                                 chunk, pend)
        if merged is not None:
            metrics.counter(metrics.FLEET_PATCHED_ROWS,
                            inc=len(pend.upsert_handles) +
                            len(pend.delete_handles))
        return merged


class _StoreView:
    """The storage-shaped bundle exec_cached_cop consumes: this
    process's caches, the meta-frozen engine view, the wire-backed
    delta view (None when the store plane runs with delta capture
    off — version-bump coherence then applies unchanged)."""

    def __init__(self, storage, engine, dstore):
        self.device = storage.device    # this SQL server's own device
        self.chunk_cache = storage.chunk_cache
        self.device_cache = getattr(storage, "device_cache", None)
        self.engine = engine
        self.delta_store = dstore


def exec_local(storage, shim, ctx, req):
    """Serve one region cop task from this SQL server's caches, primed
    by a single journal-window RPC. -> (list[CopResponse], s, e) with
    the clamped range (the streaming shim's frame boundary), or None
    when the task is not locally servable (caller executes it on the
    store plane). Typed KV errors (RegionError, KeyLockedError, ...)
    propagate exactly as the remote path raises them."""
    plan = req.plan
    if not config.fleet_local_cache() or \
            not copr.use_cached_path(storage, plan):
        return None
    loc = storage.region_cache.locate(req.ranges[0].start)
    region = loc.region
    if region.id != ctx.region_id or region.version != ctx.version:
        # routing raced a split/reload: the store plane's own epoch
        # check must arbitrate
        return None
    s, e = copr.clamp_range(region, req.ranges[0])
    from tidb_tpu_torch.store.chunk_cache import ChunkCache
    ent = storage.chunk_cache.entry_state(ChunkCache.key(region, plan,
                                                         s, e))
    # prime the pull with the resident entry's own fill snapshot; an
    # entry the freshness predicate would reject anyway (reader older
    # than the fill) gets a meta-only pull
    fill_ts = ent[1] if ent is not None and req.start_ts >= ent[1] \
        else None
    index_id = plan.index.id if plan.index is not None else None
    meta = shim.journal_window(ctx, plan.table.id, s, e, fill_ts,
                               req.start_ts, index_id=index_id)
    outcome = _pull_outcome(meta, fill_ts)
    metrics.counter(metrics.FLEET_JOURNAL_PULLS,
                    {"outcome": outcome})
    dstore = None
    if meta["delta_enabled"]:
        dstore = _DeltaView(shim, ctx, plan.table.id, s, e, index_id)
        if fill_ts is not None:
            if index_id is not None:
                dstore.prime_index(fill_ts, req.start_ts,
                                   meta["index_stale"])
            else:
                dstore.prime(s, e, fill_ts, req.start_ts, meta["delta"])
    view = _StoreView(storage, _EngineView(shim, ctx, meta), dstore)
    out = copr.exec_cached_cop(view, region, plan, s, e, req)
    metrics.counter(metrics.FLEET_LOCAL_COP, {"path": "cached"})
    return out, s, e
