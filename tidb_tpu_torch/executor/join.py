"""The join operators: the ports of the JAX package's HashJoinExec,
MergeJoinExec and IndexJoinExec (the last two at the end of the file).

Equi-join with the build side the right child, probe chunks streaming
from the left. The build side is materialized once; then, by size:

  * a build over `tidb_tpu_superchunk_rows` (or with heavy-hitter keys)
    takes the partitioned hybrid path (ops/hybrid.py): probe superchunks
    route per partition on the host and each (superchunk, partition) task
    runs the device matcher against that partition's resident key lanes;
  * otherwise probe superchunks stream through the dispatch-ahead
    pipeline against a build whose key lanes upload once
    (`_pipelined_probe`); a probe batch too small to pay a dispatch
    matches on the host.

Pairs come back as (li, ri) index arrays and `_post_match` emits the
joined rows on the host: inner, left (NULL-extended), semi, anti, and
the right-unmatched pass. With `tidb_tpu_device = 0` every probe chunk
matches on the host (host_match_pairs), as in the reference.

The heavy-hitter lane is seeded from the build side's duplication and,
where the planner traced a single probe key to an analyzed base column,
from that column's CMSketch (`probe_cms`).

Memory: the materialized build, the device-resident build lanes, each
dispatch's probe lanes and pair buffers, the superchunks in flight and
the staged probe rows bill the operator's memtrack node, as the JAX
package bills them. Under a statement quota every join with a build of
_DEVICE_MIN_BUILD rows takes the hybrid path, whose build registers the
quota spill action.

Every dispatch goes through the device plane: the pipelined and hybrid
probes take a scheduler slot per in-flight token (ops/runtime.
pipeline_map), the per-chunk path one per sync call (sched.device_slot).

A join without an equi-key is a cross join (`_cross_join`): the build
materializes once and each probe chunk joins with all of it on the host.

On a device plane of more than one shard (devplane.py) a build of at
least _DEVICE_MIN_BUILD rows joins through the plane's shuffle kernel
(ops/meshshuffle.py: an all_to_all repartition of both sides, then a
sort join per shard), probe chunks re-batched into super-batches of up
to `tidb_tpu_stream_rows`; a probe smaller than _DEVICE_MIN_PROBE rows
does not pay the repartition and takes the single-device paths.
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from tidb_tpu_torch import (config, devplane, kv, memtrack, runtime_stats,
                            sched, tablecodec)
from tidb_tpu_torch import ranger as rg
from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.executor.reader import txn_is_dirty
from tidb_tpu_torch.executor.write import _index_datum
from tidb_tpu_torch.kv import CopRequest, ReqType
from tidb_tpu_torch.ops import hybrid as op_hybrid
from tidb_tpu_torch.ops import runtime as op_runtime
from tidb_tpu_torch.ops.join import (JoinKernel, JoinKeyEncoder,
                                     host_match_pairs)
from tidb_tpu_torch.ops.runtime import eval_filter_host
from tidb_tpu_torch.plan.physical import CopPlan
from tidb_tpu_torch.sqltypes import EvalType, np_dtype_for, object_fill
from tidb_tpu_torch.store.copr import exec_cop_plan
from tidb_tpu_torch.table import index_kvrows_to_chunk, kvrows_to_chunk

__all__ = ["HashJoin", "MergeJoin", "IndexJoin"]

# plane shuffle kernels, one per (plane generation, key arity): the
# kernel's build memo and shape state survive across queries
_SHUFFLE_KERNELS: dict = {}
_SHUFFLE_KERNELS_LOCK = threading.Lock()


def _drop_stale_shuffle_kernels() -> None:
    """Topology listener: kernels of an older plane never run again."""
    gen = devplane.mesh_generation()
    with _SHUFFLE_KERNELS_LOCK:
        for k in [k for k in _SHUFFLE_KERNELS if k[0] != gen]:
            del _SHUFFLE_KERNELS[k]


devplane.on_topology_change(_drop_stale_shuffle_kernels)


class HashJoin:
    """Equi-join of `left` (probe) and `right` (build) on `left_keys` =
    `right_keys` (expressions over each child's schema)."""

    # below these sizes the dispatch costs more than the device wins
    _DEVICE_MIN_PROBE = 1024
    _DEVICE_MIN_BUILD = 4096

    def __init__(self, left, right, left_keys, right_keys,
                 join_type: str = "inner", other_cond=None,
                 probe_cms=None):
        self.left = left
        self.right = right
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.other_cond = other_cond
        self.probe_cms = probe_cms
        self.schema = left.schema + right.schema
        self._kernel = None

    def _eval_keys(self, exprs, chunk):
        """-> [(data, valid)] with both sides brought to one comparable
        representation: decimal-vs-decimal/int rescale to the common frac
        as exact scaled ints (double when the scaled value could overflow
        int64); anything involving a REAL side compares as double."""
        out = []
        for e, oe in zip(exprs, self._other_keys(exprs)):
            d, v = e.eval(chunk)
            d, v = np.asarray(d), np.asarray(v)
            if d.dtype == np.dtype(object) and \
                    (e.ft.is_ci or oe.ft.is_ci):
                from tidb_tpu_torch.sqltypes import fold_column
                d = fold_column(d)           # _ci join keys
            et, ot = e.ft.eval_type, oe.ft.eval_type
            my = e.ft.frac if et == EvalType.DECIMAL else 0
            their = oe.ft.frac if ot == EvalType.DECIMAL else 0
            if EvalType.REAL in (et, ot):
                if et == EvalType.DECIMAL:
                    d = d.astype(np.float64) / (10 ** my)
                elif d.dtype != np.float64 and d.dtype != np.dtype(object):
                    d = d.astype(np.float64)
            elif EvalType.DECIMAL in (et, ot):
                common = max(my, their)
                dig = (e.ft.flen if et == EvalType.DECIMAL else 19) \
                    + common - my
                odig = (oe.ft.flen if ot == EvalType.DECIMAL else 19) \
                    + common - their
                if max(dig, odig) > 18:   # scaled int64 could overflow
                    d = d.astype(np.float64) / (10 ** my)
                elif common > my:
                    d = d * np.int64(10 ** (common - my))
            out.append((d, v))
        return out

    def _other_keys(self, exprs):
        return self.right_keys if exprs is self.left_keys \
            else self.left_keys

    def _encoded_keys(self, exprs, chunk):
        """Pre-encoded (codes, values) key lanes for bare varlen
        ColumnRefs (ops/encoded.py, `tidb_tpu_encoded_exec`), engaged per
        key only when BOTH sides are plain string columns with matching
        collation."""
        if not config.encoded_exec_enabled():
            return None
        from tidb_tpu_torch.ops import encoded as op_encoded
        out = []
        any_lane = False
        for e, oe in zip(exprs, self._other_keys(exprs)):
            lane = None
            if (e.ft.eval_type == EvalType.STRING and
                    oe.ft.eval_type == EvalType.STRING and
                    bool(e.ft.is_ci) == bool(oe.ft.is_ci)):
                lane = op_encoded.encoded_lane(e, chunk)
            out.append(lane)
            any_lane = any_lane or lane is not None
        return out if any_lane else None

    def _probe_keys(self, enc, chunk):
        """One probe batch's aligned key lanes."""
        return enc.transform_probe(
            self._eval_keys(self.left_keys, chunk),
            encoded=self._encoded_keys(self.left_keys, chunk))

    def _fit_build(self, build):
        """-> (enc, bk, raw_bk) for a materialized build chunk: raw_bk
        are the evaluated key lanes, bk the encoded ones."""
        enc = JoinKeyEncoder(len(self.right_keys))
        raw_bk = self._eval_keys(self.right_keys, build)
        bk = enc.fit_build(raw_bk,
                           encoded=self._encoded_keys(self.right_keys,
                                                      build),
                           ci=[e.ft.is_ci for e in self.right_keys])
        return enc, bk, raw_bk

    def _mesh_kernel(self, nb: int):
        """The plane's shuffle-join kernel when a plane of more than one
        shard is active and the build side is big enough to be worth a
        repartition, else None. Cached per (plane generation, key
        arity)."""
        mesh = devplane.active_mesh()
        if mesh is None or mesh.devices.size <= 1 or \
                nb < self._DEVICE_MIN_BUILD or not config.device_enabled():
            return None
        from tidb_tpu_torch.ops.meshshuffle import MeshShuffleJoinKernel
        key = (devplane.mesh_generation(), len(self.left_keys))
        with _SHUFFLE_KERNELS_LOCK:
            kernel = _SHUFFLE_KERNELS.get(key)
            if kernel is None:
                kernel = MeshShuffleJoinKernel(mesh, len(self.left_keys))
                _SHUFFLE_KERNELS[key] = kernel
        return kernel

    def build_label(self) -> str:
        """The build side's table name, where it is a scan."""
        return getattr(self.right, "table", "?")

    def chunks(self, ctx):
        if not self.left_keys:
            yield from self._cross_join(ctx)
            return
        build = Chunk.concat_all(list(self.right.chunks(ctx)))
        nb = build.num_rows if build is not None else 0
        # the materialized build side is the join's dominant host buffer:
        # held on this operator's ledger for the whole probe phase
        tracked = memtrack.track_to(
            self, memtrack.chunk_bytes(build) if nb else 0)
        try:
            yield from self._probe_join(ctx, build, nb)
        finally:
            memtrack.release(self, host=tracked)

    def _probe_join(self, ctx, build, nb: int, prepared=None):
        """`prepared` = (enc, bk, hot, h) from a caller that
        already encoded the build keys and ran the hybrid-engage scan
        (the fused fragment's stand-aside path), so that O(nb) work does
        not run twice."""
        if prepared is not None and nb:
            enc, bk, pre_hot, pre_h = prepared
            raw_bk = None
        else:
            enc, bk, raw_bk = self._fit_build(build) if nb \
                else (JoinKeyEncoder(len(self.right_keys)), None, None)
            pre_hot = pre_h = None
        self._kernel = JoinKernel(len(self.left_keys), device=ctx.device)
        matched_build = np.zeros(nb, dtype=bool)
        probe_iter = self.left.chunks(ctx)
        mesh_kernel = self._mesh_kernel(nb)
        if mesh_kernel is not None:
            # each shuffle-join call is one all_to_all repartition of both
            # sides over the plane, so probe chunks re-batch into large
            # super-batches, bounded by tidb_tpu_stream_rows (the build
            # side's sharded transfer is memoized across batches). A
            # small probe does not pay for the collective at all
            buffered, total = [], 0
            for c in probe_iter:
                buffered.append(c)
                total += c.num_rows
                if total >= self._DEVICE_MIN_PROBE:
                    break
            if total >= self._DEVICE_MIN_PROBE:
                probe_iter = (sc.chunk for sc in
                              op_runtime.superchunk_batches(
                                  itertools.chain(buffered, probe_iter),
                                  max(config.stream_rows(),
                                      self._DEVICE_MIN_PROBE)))
            else:
                mesh_kernel = None
                probe_iter = iter(buffered)
        device_ok = mesh_kernel is None and nb > 0 and \
            config.device_enabled() and bool(config.superchunk_rows())
        if not device_ok:
            hyb = None
        elif pre_h is not None:
            # the caller's engage scan already said yes
            hyb = op_hybrid.HybridJoinBuild(
                self._kernel, bk, nb, config.join_partitions(), ctx.stats,
                hot_hashes=pre_hot, h=pre_h, plan=self)
        else:
            hyb = self._maybe_hybrid(ctx, bk, nb, raw_bk)
        ctx.stats.join_paths[self.build_label()] = \
            "hybrid" if hyb is not None else \
            "pipelined" if device_ok else \
            "shuffle" if mesh_kernel is not None else "per-chunk"
        if hyb is not None:
            ctx.stats.hybrid_joins += 1
            try:
                yield from self._hybrid_probe(ctx, probe_iter, build, hyb,
                                              enc, matched_build)
            finally:
                ctx.stats.spilled_partitions += hyb.spilled
                hyb.close()
        elif device_ok:
            yield from self._pipelined_probe(ctx, probe_iter, build, bk,
                                             enc, matched_build, nb)
        else:
            for chunk in probe_iter:
                n = chunk.num_rows
                if n == 0:
                    continue
                if nb == 0:
                    if self.join_type == "left":
                        out = self._emit(chunk, build,
                                         np.empty(0, np.int64),
                                         np.empty(0, np.int64),
                                         np.arange(n))
                        if out is not None:
                            yield out
                    elif self.join_type == "anti":
                        yield chunk        # nothing can match: all survive
                    continue
                # superchunks off (or the plane's shuffle): the same
                # sort join, per chunk
                pk = self._probe_keys(enc, chunk)
                if mesh_kernel is not None:
                    from tidb_tpu_torch.ops.meshshuffle import \
                        ShuffleOverflowError
                    ctx.stats.join_dispatches += 1
                    try:
                        li, ri = runtime_stats.device_call(
                            self, mesh_kernel, pk, bk, nb, n)
                    except ShuffleOverflowError:
                        # designed fallback: extreme hash skew exhausted
                        # the repartition retry budget
                        with sched.device_slot():
                            li, ri = runtime_stats.device_call(
                                self, self._kernel, bk, pk, nb, n)
                elif config.device_enabled() and \
                        (n >= self._DEVICE_MIN_PROBE or
                         nb >= self._DEVICE_MIN_BUILD):
                    ctx.stats.join_dispatches += 1
                    with sched.device_slot():
                        li, ri = self._kernel(bk, pk, nb, n)
                else:
                    ctx.stats.host_match_batches += 1
                    li, ri = host_match_pairs(bk, pk, nb, n)
                yield from self._post_match(chunk, build, li, ri,
                                            matched_build)
        if self.join_type == "right" and build is not None:
            un = np.flatnonzero(~matched_build)
            if len(un):
                yield self._emit_right_unmatched(build, un)

    def _cross_join(self, ctx):
        """A join with no equi-key (comma join, ON without an equality):
        every probe row against every build row, the other condition
        filtering the product. The materialized build is billed to the
        operator's ledger for the whole probe phase."""
        build = None
        tracked = 0
        for chunk in self.right.chunks(ctx):
            build = chunk if build is None else build.concat(chunk)
            tracked = memtrack.track_to(self, memtrack.chunk_bytes(build),
                                        tracked)
        ctx.stats.join_paths[self.build_label()] = "cross"
        if build is None or build.num_rows == 0:
            memtrack.release(self, host=tracked)
            return
        try:
            yield from self._cross_probe(ctx, build)
        finally:
            memtrack.release(self, host=tracked)

    def _cross_probe(self, ctx, build):
        nb = build.num_rows
        for chunk in self.left.chunks(ctx):
            nl = chunk.num_rows
            if nl == 0:
                continue
            li = np.repeat(np.arange(nl), nb)
            ri = np.tile(np.arange(nb), nl)
            out = self._gather(chunk, build, li, ri)
            if self.other_cond is not None:
                out = out.filter(eval_filter_host(self.other_cond, out))
            yield out

    def _post_match(self, chunk, build, li, ri, matched_build):
        """Shared tail after pair matching for one probe batch: other_cond
        filtering, semi/anti emission, left-unmatched fill; marks matched
        build rows for the right-join pass."""
        n = chunk.num_rows
        # other_cond filters pairs BEFORE unmatched detection, so a probe
        # row whose every match fails the condition re-enters as
        # unmatched (outer-join ON-clause semantics)
        pair = None
        if self.other_cond is not None and len(li):
            pair = self._gather(chunk, build, li, ri)
            keep = eval_filter_host(self.other_cond, pair)
            li, ri = li[keep], ri[keep]
            pair = pair.filter(keep)
        if self.join_type in ("semi", "anti"):
            # emit probe rows by match existence, never the joined width
            m = np.zeros(n, dtype=bool)
            m[li] = True
            yield chunk.filter(m if self.join_type == "semi" else ~m)
            return
        matched_build[ri] = True
        unmatched = np.empty(0, np.int64)
        if self.join_type == "left":
            m = np.zeros(n, dtype=bool)
            m[li] = True
            unmatched = np.flatnonzero(~m)
        out = self._emit(chunk, build, li, ri, unmatched, pair=pair)
        if out is not None:
            yield out

    def _sketch_key(self, raw_bk):
        """The build side's raw key lane that the probe CMSketch is
        queried with: a single key of a type whose raw values match the
        ANALYZE-time sketch encoding (decimal and real keys rescale in
        _eval_keys, and _ci strings fold), else None."""
        if len(self.right_keys) != 1 or not raw_bk:
            return None
        rk, lk = self.right_keys[0], self.left_keys[0]
        ok_types = (EvalType.INT, EvalType.STRING, EvalType.DATETIME,
                    EvalType.DURATION)
        if rk.ft.eval_type in ok_types and lk.ft.eval_type in ok_types \
                and not rk.ft.is_ci and not lk.ft.is_ci:
            return raw_bk[0]
        return None

    def _hybrid_engage(self, bk, nb: int, raw_bk=None):
        """(engage, hot, h): should the partitioned hybrid path carry this
        build? Under skew, under a statement memory quota (only the
        hybrid build can shed device memory), or with a build over a
        superchunk. Decision only, so the fused-fragment eligibility
        check (executor/agg.HashAgg) can consult it and stand aside. The
        hot set is the build side's duplication plus, with the planner's
        `probe_cms`, the keys that sketch estimates hot."""
        parts = config.join_partitions()
        if parts <= 1 or nb < self._DEVICE_MIN_BUILD:
            return False, None, None
        h = op_hybrid.build_hashes(bk, nb)
        hot = op_hybrid.detect_hot_hashes(h, config.skew_threshold(),
                                          self._sketch_key(raw_bk),
                                          self.probe_cms)
        root = memtrack.current()
        quota = root is not None and root.quota > 0
        if not hot.size and not quota and nb <= config.superchunk_rows():
            return False, hot, h
        return True, hot, h

    def _maybe_hybrid(self, ctx, bk, nb: int, raw_bk=None):
        """A HybridJoinBuild when the partitioned path should carry this
        probe: under skew or an over-superchunk build. The unskewed
        in-device-memory case stays on the pipelined probe."""
        engage, hot, h = self._hybrid_engage(bk, nb, raw_bk)
        if not engage:
            return None
        return op_hybrid.HybridJoinBuild(self._kernel, bk, nb,
                                         config.join_partitions(),
                                         ctx.stats, hot_hashes=hot, h=h,
                                         plan=self)

    # lint: exempt[memtrack-alloc] pair-index buffers are billed at dispatch (cap*17 inside dispatch_nbytes); staged sub-chunks consume on mt_node below
    def _hybrid_probe(self, ctx, probe_iter, build, hyb, enc,
                      matched_build):
        """Partitioned probe over a HybridJoinBuild.

        Phase 1 streams probe superchunks through the dispatch-ahead
        pipeline: rows route per partition (the heavy-hitter lane at
        index `parts`), and each (superchunk, partition) task matches
        against the partition's resident lanes. Once the quota spill
        action has shed cold build partitions, rows bound for a spilled
        partition stage on the host instead of re-uploading it. Phase 2
        drains the staging one partition at a time, re-uploading each
        spilled build partition once and evicting it when drained.

        A superchunk's emission fires when its LAST task finalizes.
        Every probe row reaches exactly one _post_match call with its
        matching complete, so outer-join unmatched detection and
        semi/anti emission stay exact per subset."""
        kernel = self._kernel
        stats = ctx.stats
        mt_node = memtrack.op_node(self)
        staged: list = []      # (pid, sub_chunk, pk lanes, host bytes)

        def dispatch_one(p, pk_sub, hp_sub, n_sub):
            bdev = hyb.ensure(p)
            # SNAPSHOT the partition->global row map at dispatch time: a
            # later promotion re-layouts the build while this token is in
            # flight, and the pair indices must resolve against the
            # layout the matcher saw. The pin keeps the partition's
            # device bytes on the ledger and off the spill action's menu.
            rows = hyb.build_rows(p)
            cap = hyb.hot_out_cap(hp_sub) if p == hyb.parts else None
            db = kernel.dispatch_nbytes(n_sub, cap)
            memtrack.consume(self, device=db)
            hyb.pin(p)
            try:
                tok = kernel.dispatch(None, pk_sub, len(rows), n_sub,
                                      out_cap=cap, build_dev=bdev)
            except BaseException:
                hyb.unpin(p)
                memtrack.release(self, device=db)
                raise
            stats.hybrid_tasks += 1
            return p, rows, tok, db

        def finalize_one(t):
            p, rows, tok, db = t
            t0 = time.perf_counter_ns()
            try:
                li_l, ri_l = kernel.finalize(tok)
            finally:
                hyb.unpin(p)
                memtrack.release(self, device=db)
                runtime_stats.note_finalize_wait(
                    self, time.perf_counter_ns() - t0)
            return li_l, rows[ri_l]

        pending_promo: list = [None]
        open_states: dict = {}      # id -> state; bytes held to emission

        def task_iter(sc_iter):
            for sup in sc_iter:
                sc = sup.chunk
                # apply the promotion observed on the PREVIOUS batch: all
                # of its tasks have dispatched by now, so no routed but
                # undispatched task can straddle the re-layout
                if pending_promo[0] is not None:
                    hyb.promote(pending_promo[0])
                    pending_promo[0] = None
                n = sc.num_rows
                pk = self._probe_keys(enc, sc)
                hp, tasks = hyb.route(pk, n)
                pending_promo[0] = hyb.observe(hp)
                staged_mask = np.zeros(n, dtype=bool)
                imm = []
                for p, idx in tasks:
                    if hyb.want_immediate(p):
                        imm.append((p, idx))
                        continue
                    sub = [(d[idx], v[idx]) for d, v in pk]
                    sub_chunk = sc.take(idx)
                    sb = memtrack.chunk_bytes(sub_chunk) + \
                        sum(d.nbytes + v.nbytes for d, v in sub)
                    if mt_node is not None:
                        # released in the drain loop or the finally
                        mt_node.consume(host=sb)
                    staged.append((p, sub_chunk, sub, sb))
                    staged_mask[idx] = True
                    stats.staged_probe_rows += len(idx)
                sb = memtrack.chunk_bytes(sc)
                if mt_node is not None:
                    # held until the superchunk's emission
                    mt_node.consume(host=sb)
                state = {"chunk": sc, "pk": pk, "hp": hp,
                         "mask": staged_mask, "li": [], "ri": [],
                         "left": max(len(imm), 1), "bytes": sb}
                open_states[id(state)] = state
                runtime_stats.note_superchunk(self, n, sup.bucket,
                                              sup.sources)
                if not imm:
                    # every row staged or unmatched: one sentinel task
                    # still flows through so the emission fires
                    yield (state, None, None)
                for p, idx in imm:
                    yield (state, p, idx)

        def dispatch(task):
            state, p, idx = task
            if p is None:
                return None
            sub = [(d[idx], v[idx]) for d, v in state["pk"]]
            return dispatch_one(p, sub, state["hp"][idx], len(idx))

        def finalize(task, tok):
            state, _p, idx = task
            if tok is not None:
                li_l, ri = finalize_one(tok)
                state["li"].append(idx[li_l])
                state["ri"].append(ri)
            state["left"] -= 1
            if state["left"] > 0:
                return None
            open_states.pop(id(state), None)
            if mt_node is not None and state["bytes"]:
                mt_node.release(host=state["bytes"])
            li = np.concatenate(state["li"]) if state["li"] \
                else np.empty(0, dtype=np.int64)
            ri = np.concatenate(state["ri"]) if state["ri"] \
                else np.empty(0, dtype=np.int64)
            mask = state["mask"]
            if mask.any():
                # staged rows' matching is not complete: hand only the
                # immediately matched subset to _post_match
                keep = np.flatnonzero(~mask)
                li = np.searchsorted(keep, li)
                return state["chunk"].take(keep), li, ri
            return state["chunk"], li, ri

        sc_iter = op_runtime.superchunk_batches(probe_iter,
                                                config.superchunk_rows(),
                                                tracker=mt_node)
        try:
            for out in op_runtime.pipeline_map(task_iter(sc_iter), dispatch,
                                               finalize,
                                               config.pipeline_depth()):
                if out is None:
                    continue
                chunk_out, li, ri = out
                yield from self._post_match(chunk_out, build, li, ri,
                                            matched_build)
            # phase 2: drain staged cold-partition rows, grouped by
            # partition so each spilled build uploads exactly once.
            # Promotions only ever MOVE keys to the always-resident hot
            # lane, so a staged batch re-routes within {its partition,
            # hot} and the grouping stays partition-local.
            staged.sort(key=lambda t: t[0])
            while staged:
                p_hint, sub_chunk, pk_sub, sb = staged[0]
                try:
                    hp, tasks = hyb.route(pk_sub, sub_chunk.num_rows)
                    li_parts, ri_parts = [], []
                    for p, idx in tasks:
                        lanes = [(d[idx], v[idx]) for d, v in pk_sub]
                        li_l, ri = finalize_one(
                            dispatch_one(p, lanes, hp[idx], len(idx)))
                        li_parts.append(idx[li_l])
                        ri_parts.append(ri)
                    li = np.concatenate(li_parts) if li_parts \
                        else np.empty(0, dtype=np.int64)
                    ri = np.concatenate(ri_parts) if ri_parts \
                        else np.empty(0, dtype=np.int64)
                finally:
                    staged.pop(0)
                    if mt_node is not None and sb:
                        mt_node.release(host=sb)
                stats.drained_probe_rows += sub_chunk.num_rows
                yield from self._post_match(sub_chunk, build, li, ri,
                                            matched_build)
                if hyb.under_pressure() and \
                        (not staged or staged[0][0] != p_hint):
                    hyb.evict(p_hint)
        finally:
            if mt_node is not None:
                for _p, _c, _k, sb in staged:
                    if sb:
                        mt_node.release(host=sb)
                # superchunks abandoned before their last task finalized
                for state in open_states.values():
                    if state["bytes"]:
                        mt_node.release(host=state["bytes"])
            staged.clear()
            open_states.clear()

    def _pipelined_probe(self, ctx, probe_iter, build, bk, enc,
                         matched_build, nb: int):
        """Coalesced probe matching with dispatch-ahead: while superchunk
        k's matcher runs on the device, k+1's keys are encoded, padded and
        transferred. A probe too small to pay a dispatch matches on the
        host inline."""
        kernel = self._kernel
        stats = ctx.stats
        build_dev = None
        build_db = 0
        mt_node = memtrack.op_node(self)

        def dispatch(sc):
            nonlocal build_dev, build_db
            n = sc.num_rows
            pk = self._probe_keys(enc, sc.chunk)
            if n < self._DEVICE_MIN_PROBE and nb < self._DEVICE_MIN_BUILD:
                stats.host_match_batches += 1
                return ("host", host_match_pairs(bk, pk, nb, n), 0)
            if build_dev is None:
                # build lanes stay device-resident for the whole probe,
                # held on the device ledger until the generator ends
                build_db = kernel.build_nbytes(nb)
                memtrack.consume(self, device=build_db)
                build_dev = kernel.prepare_build(bk, nb)
            db = kernel.dispatch_nbytes(n)
            memtrack.consume(self, device=db)
            try:
                tok = kernel.dispatch(bk, pk, nb, n, build_dev=build_dev)
            except BaseException:
                memtrack.release(self, device=db)
                raise
            stats.join_dispatches += 1
            runtime_stats.note_superchunk(self, n, sc.bucket, sc.sources)
            return ("dev", tok, db)

        def finalize(sc, tok):
            kind, payload, db = tok
            if kind == "host":
                li, ri = payload
            else:
                t0 = time.perf_counter_ns()
                try:
                    li, ri = kernel.finalize(payload)
                finally:
                    memtrack.release(self, device=db)
                    runtime_stats.note_finalize_wait(
                        self, time.perf_counter_ns() - t0)
            return sc, li, ri

        sc_iter = op_runtime.superchunk_batches(probe_iter,
                                                config.superchunk_rows(),
                                                tracker=mt_node)
        try:
            for sc, li, ri in op_runtime.pipeline_map(
                    sc_iter, dispatch, finalize, config.pipeline_depth(),
                    tracker=mt_node,
                    cost=lambda sc: memtrack.chunk_bytes(sc.chunk)):
                yield from self._post_match(sc.chunk, build, li, ri,
                                            matched_build)
        finally:
            if build_db:
                memtrack.release(self, device=build_db)

    def _gather(self, left_chunk, build, li, ri):
        cols = [Column(c.ft, c.data[li], c.valid[li])
                for c in left_chunk.columns]
        cols += [Column(c.ft, c.data[ri], c.valid[ri])
                 for c in build.columns]
        return Chunk(cols)

    # lint: exempt[memtrack-alloc] all-NULL side of an outer join's emit: join-emit padding over the tracked build, the one helper the emit and the right-unmatched pass share
    @staticmethod
    def _null_columns(schema, n: int):
        """All-NULL columns for an outer join's missing side."""
        cols = []
        for sc in schema:
            dtype = np_dtype_for(sc.ft.tp, sc.ft.flen)
            data = np.zeros(n, dtype=dtype) if dtype != np.dtype(object) \
                else np.full(n, object_fill(sc.ft), dtype=object)
            cols.append(Column(sc.ft, data, np.zeros(n, dtype=bool)))
        return cols

    def _emit(self, left_chunk, build, li, ri, left_unmatched, pair=None):
        out = pair
        if out is None:
            out = self._gather(left_chunk, build, li, ri) \
                if len(li) or not len(left_unmatched) else None
        if self.join_type == "left" and len(left_unmatched):
            ui = np.asarray(left_unmatched, dtype=np.int64)
            ucols = [Column(c.ft, c.data[ui], c.valid[ui])
                     for c in left_chunk.columns]
            uchunk = Chunk(ucols + self._null_columns(self.right.schema,
                                                      len(ui)))
            out = uchunk if out is None else out.concat(uchunk)
        return out

    def _emit_right_unmatched(self, build, un):
        cols = self._null_columns(self.left.schema, len(un))
        for c in build.columns:
            cols.append(Column(c.ft, c.data[un], c.valid[un]))
        return Chunk(cols)


class MergeJoin(HashJoin):
    """Streaming sorted-merge equi-join (ref: executor/merge_join.go:34).

    Contract (planner-enforced): both children deliver rows ascending by
    their single join key — pk-handle table scans arrive in handle order,
    keep_order index readers in index order. Only a sliding window of the
    right side (rows whose key may still match a later left chunk) is
    kept, so neither side is materialized whole: memory is O(chunk +
    widest equal-key run). Matching is one vectorized searchsorted per
    left chunk, on the host (the inputs are already sorted)."""

    # lint: exempt[memtrack-alloc] merge window concatenation billed via track_to on the window buffer
    def chunks(self, ctx):
        right_iter = self.right.chunks(ctx)
        window = None          # right rows that may still match
        right_done = False
        tracked_w = 0          # the window, on this operator's ledger

        def right_key(ch):
            return self._eval_keys(self.right_keys, ch)[0]

        try:
            for chunk in self.left.chunks(ctx):
                n = chunk.num_rows
                if n == 0:
                    continue
                lk, lv = self._eval_keys(self.left_keys, chunk)[0]
                has_valid = bool(np.any(lv))
                lmax = lk[lv].max() if has_valid else None
                # grow the window until its tail key passes this chunk's
                # largest key
                while not right_done and has_valid:
                    wd, wv = (right_key(window) if window is not None
                              and window.num_rows else (None, None))
                    if wd is not None and len(wd) and wv[-1] and \
                            wd[-1] > lmax:
                        break
                    nxt = next(right_iter, None)
                    if nxt is None:
                        right_done = True
                        break
                    window = nxt if window is None else window.concat(nxt)
                tracked_w = memtrack.track_to(
                    self, memtrack.chunk_bytes(window)
                    if window is not None else 0, tracked_w)
                if window is None or window.num_rows == 0:
                    empty = np.empty(0, np.int64)
                    unmatched = np.arange(n) if self.join_type == "left" \
                        else empty
                    out = self._emit(chunk, Chunk(self._null_columns(
                        self.right.schema, 0)), empty, empty, unmatched)
                    if out is not None and out.num_rows:
                        yield out
                    continue
                wd, wv = right_key(window)
                val_idx = np.flatnonzero(wv)
                wdv = wd[val_idx]
                lo = np.searchsorted(wdv, lk, side="left")
                hi = np.searchsorted(wdv, lk, side="right")
                counts = np.where(lv, hi - lo, 0)
                total = int(counts.sum())
                li = np.repeat(np.arange(n), counts)
                cs = np.concatenate(([0], np.cumsum(counts)[:-1]))
                w = np.arange(total) - np.repeat(cs, counts)
                ri = val_idx[np.repeat(lo, counts) + w] if total else \
                    np.empty(0, np.int64)
                pair = None
                if self.other_cond is not None and len(li):
                    pair = self._gather(chunk, window, li, ri)
                    keep = eval_filter_host(self.other_cond, pair)
                    li, ri = li[keep], ri[keep]
                    pair = pair.filter(keep)
                unmatched = np.empty(0, np.int64)
                if self.join_type == "left":
                    m = np.zeros(n, dtype=bool)
                    m[li] = True
                    unmatched = np.flatnonzero(~m)
                out = self._emit(chunk, window, li, ri, unmatched, pair=pair)
                if out is not None and out.num_rows:
                    yield out
                # slide: right rows below this chunk's largest key can
                # never match again (left keys do not decrease)
                if has_valid and window.num_rows:
                    keep = ~wv | (wd >= lmax)
                    if not keep.all():
                        window = window.filter(keep)
                        tracked_w = memtrack.track_to(
                            self, memtrack.chunk_bytes(window), tracked_w)
        finally:
            memtrack.release(self, host=tracked_w)


class IndexJoin(HashJoin):
    """Index nested-loop join (ref: executor/index_lookup_join.go:87).

    Streams the outer (left) side; per outer chunk, collects the distinct
    valid join-key values and fetches only the matching inner rows —
    by batched pk point reads where the key is the handle
    (`inner_index` None), else by synthesized point ranges over
    `inner_index` through the coprocessor. The fetched batch then joins
    the chunk through the pair matcher (ops/join.JoinKernel on the
    statement's device; host_match_pairs with `tidb_tpu_device = 0`).
    The inner table is never scanned. In a transaction that wrote the
    inner table the same point reads go through its union store.
    `right` is the inner TableReader: its CopPlan (`right.cop`) and
    schema; it is never run as a scan."""

    def __init__(self, left, right, left_keys, right_keys, inner_index,
                 join_type: str = "inner", other_cond=None):
        super().__init__(left, right, left_keys, right_keys,
                         join_type=join_type, other_cond=other_cond)
        self.inner_index = inner_index

    def _fetch_inner(self, ctx, key_vals: np.ndarray):
        """Inner rows whose key is in key_vals (distinct, non-null)."""
        icop = self.right.cop
        dirty = txn_is_dirty(ctx, icop.table.id)
        if self.inner_index is None:
            handles = [int(v) for v in key_vals]
            if dirty:
                return self._dirty_rows_by_handles(ctx, icop, handles)
            return self._rows_by_handles(ctx, icop, handles)
        # secondary index: scan the key points' entries for handles, then
        # batch-fetch the rows (the per-batch form of IndexLookUp)
        ft = self.right_keys[0].ft
        ranges = [rg.DatumRange(low=[_index_datum(v, ft)],
                                high=[_index_datum(v, ft)])
                  for v in key_vals]
        kv_ranges = rg.index_ranges_to_kv(icop.table.id,
                                          self.inner_index.id, ranges)
        index_cols = [icop.table.col_by_name(c)
                      for c in self.inner_index.columns]
        if dirty:
            # point index ranges through the union store: its entries
            # (and tombstones) shadow the snapshot's; one range scan per
            # distinct key of the outer chunk
            rows = []
            for rng in kv_ranges:
                rows.extend(ctx.txn.iter_range(rng.start, rng.end))
            ich = index_kvrows_to_chunk(icop.table, self.inner_index,
                                        index_cols, rows, len(index_cols))
            hc = ich.columns[len(index_cols)]
            return self._dirty_rows_by_handles(
                ctx, icop, [int(h) for h in hc.data[:ich.num_rows]])
        index_cop = CopPlan(table=icop.table, cols=index_cols,
                            handle_col=len(index_cols),
                            index=self.inner_index, ranges=kv_ranges)
        req = CopRequest(tp=ReqType.DAG, ranges=kv_ranges, plan=index_cop,
                         start_ts=ctx.read_ts)
        handles: list[int] = []
        for resp in ctx.storage.client().send(req):
            hc = resp.chunk.columns[len(index_cols)]
            handles.extend(int(h) for h in hc.data[:resp.chunk.num_rows])
        return self._rows_by_handles(ctx, icop, handles)

    @staticmethod
    def _cop_over(ctx, icop, kvrows):
        chunk = kvrows_to_chunk(icop.table, icop.cols, kvrows,
                                icop.handle_col)
        return exec_cop_plan(icop, chunk, device=ctx.device).chunk

    def _rows_by_handles(self, ctx, icop, handles):
        snap = ctx.storage.snapshot(ctx.read_ts)
        keys = [tablecodec.record_key(icop.table.id, h) for h in handles]
        got = snap.batch_get(keys)
        return self._cop_over(ctx, icop,
                              [(k, got[k]) for k in keys if k in got])

    def _dirty_rows_by_handles(self, ctx, icop, handles):
        """Point reads with the write buffer overlaid on ONE batched
        snapshot read: own inserts appear, own deletes vanish."""
        keys = [tablecodec.record_key(icop.table.id, h)
                for h in dict.fromkeys(int(h) for h in handles)]
        membuf = ctx.txn.us.membuf
        dirty_vals = {}
        clean = []
        for k in keys:
            v = membuf.get(k)
            if v is None:
                clean.append(k)
            else:
                dirty_vals[k] = v
        got = ctx.txn.snapshot.batch_get(clean) if clean else {}
        kvrows = []
        for k in keys:
            v = dirty_vals.get(k)
            if v is None:
                v = got.get(k)
            elif v is kv._TOMBSTONE:     # own delete shadows the snapshot
                continue
            if v is not None:
                kvrows.append((k, v))
        return self._cop_over(ctx, icop, kvrows)

    def chunks(self, ctx):
        self._kernel = JoinKernel(len(self.left_keys), device=ctx.device)
        tracked = 0
        try:
            for chunk in self.left.chunks(ctx):
                n = chunk.num_rows
                if n == 0:
                    continue
                kd, kvalid = self.left_keys[0].eval(chunk)
                kd, kvalid = np.asarray(kd), np.asarray(kvalid, dtype=bool)
                vals = np.unique(kd[kvalid]) if kvalid.any() else kd[:0]
                build = self._fetch_inner(ctx, vals) if len(vals) else \
                    Chunk(self._null_columns(self.right.schema, 0))
                # the per-outer-batch inner build, tracked to its successor
                tracked = memtrack.track_to(
                    self, memtrack.chunk_bytes(build), tracked)
                nb = build.num_rows
                if nb == 0:
                    if self.join_type == "left":
                        empty = np.empty(0, np.int64)
                        out = self._emit(chunk, build, empty, empty,
                                         np.arange(n))
                        if out is not None and out.num_rows:
                            yield out
                    continue
                enc = JoinKeyEncoder(len(self.right_keys))  # per batch
                bk = enc.fit_build(self._eval_keys(self.right_keys, build))
                pk = enc.transform_probe(self._eval_keys(self.left_keys,
                                                         chunk))
                if config.device_enabled():
                    ctx.stats.join_dispatches += 1
                    with sched.device_slot(), memtrack.device_scope(
                            self, self._kernel.build_nbytes(nb) +
                            self._kernel.dispatch_nbytes(n)):
                        li, ri = self._kernel(bk, pk, nb, n)
                else:
                    ctx.stats.host_match_batches += 1
                    li, ri = host_match_pairs(bk, pk, nb, n)
                pair = None
                if self.other_cond is not None and len(li):
                    pair = self._gather(chunk, build, li, ri)
                    keep = eval_filter_host(self.other_cond, pair)
                    li, ri = li[keep], ri[keep]
                    pair = pair.filter(keep)
                unmatched = np.empty(0, np.int64)
                if self.join_type == "left":
                    m = np.zeros(n, dtype=bool)
                    m[li] = True
                    unmatched = np.flatnonzero(~m)
                out = self._emit(chunk, build, li, ri, unmatched, pair=pair)
                if out is not None and out.num_rows:
                    yield out
        finally:
            memtrack.release(self, host=tracked)
