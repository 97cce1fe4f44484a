"""The hash join operator: the port of the JAX package's HashJoinExec.

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

Left out: the mesh shuffle kernel (the multi-device plane), the cross
join, MergeJoinExec and the runtime-stats hooks.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch import config, memtrack, sched
from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.ops import hybrid as op_hybrid
from tidb_tpu_torch.ops import runtime as op_runtime
from tidb_tpu_torch.ops.join import (JoinKernel, JoinKeyEncoder,
                                     host_match_pairs)
from tidb_tpu_torch.ops.runtime import eval_filter_host
from tidb_tpu_torch.sqltypes import EvalType, np_dtype_for, object_fill

__all__ = ["HashJoin"]


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

    def build_label(self) -> str:
        """The build side's table name, where it is a scan."""
        return getattr(self.right, "table", "?")

    def chunks(self, ctx):
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
        device_ok = nb > 0 and config.device_enabled() and \
            bool(config.superchunk_rows())
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
            "pipelined" if device_ok else "per-chunk"
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
                # superchunks off: the same sort join, per chunk
                pk = self._probe_keys(enc, chunk)
                if config.device_enabled() and \
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
            try:
                li_l, ri_l = kernel.finalize(tok)
            finally:
                hyb.unpin(p)
                memtrack.release(self, device=db)
            return li_l, rows[ri_l]

        pending_promo: list = [None]
        open_states: dict = {}      # id -> state; bytes held to emission

        def task_iter(sc_iter):
            for sc in sc_iter:
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
            pk = self._probe_keys(enc, sc)
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
            return ("dev", tok, db)

        def finalize(sc, tok):
            kind, payload, db = tok
            if kind == "host":
                li, ri = payload
            else:
                try:
                    li, ri = kernel.finalize(payload)
                finally:
                    memtrack.release(self, device=db)
            return sc, li, ri

        sc_iter = op_runtime.superchunk_batches(probe_iter,
                                                config.superchunk_rows(),
                                                tracker=mt_node)
        try:
            for sc, li, ri in op_runtime.pipeline_map(
                    sc_iter, dispatch, finalize, config.pipeline_depth(),
                    tracker=mt_node, cost=memtrack.chunk_bytes):
                yield from self._post_match(sc, build, li, ri,
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
