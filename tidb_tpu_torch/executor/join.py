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
the right-unmatched pass.

Left out: the mesh shuffle kernel (the multi-device plane), the cross
join, MergeJoinExec, and the memtrack, runtime-stats and quota-spill
hooks (with no quota the reference never stages probe rows, so the
hybrid probe's staging and drain phase is not carried).
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch import config
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
                 join_type: str = "inner", other_cond=None):
        self.left = left
        self.right = right
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = join_type
        self.other_cond = other_cond
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
        """-> (enc, bk) for a materialized build chunk."""
        enc = JoinKeyEncoder(len(self.right_keys))
        bk = enc.fit_build(self._eval_keys(self.right_keys, build),
                           encoded=self._encoded_keys(self.right_keys,
                                                      build),
                           ci=[e.ft.is_ci for e in self.right_keys])
        return enc, bk

    def build_label(self) -> str:
        """The build side's table name, where it is a scan."""
        return getattr(self.right, "table", "?")

    def chunks(self, ctx):
        build = Chunk.concat_all(list(self.right.chunks(ctx)))
        nb = build.num_rows if build is not None else 0
        yield from self._probe_join(ctx, build, nb)

    def _probe_join(self, ctx, build, nb: int, prepared=None):
        """`prepared` = (enc, bk, hot, h) from a caller that
        already encoded the build keys and ran the hybrid-engage scan
        (the fused fragment's stand-aside path), so that O(nb) work does
        not run twice."""
        if prepared is not None and nb:
            enc, bk, pre_hot, pre_h = prepared
        else:
            enc, bk = self._fit_build(build) if nb \
                else (JoinKeyEncoder(len(self.right_keys)), None)
            pre_hot = pre_h = None
        self._kernel = JoinKernel(len(self.left_keys), device=ctx.device)
        matched_build = np.zeros(nb, dtype=bool)
        probe_iter = self.left.chunks(ctx)
        device_ok = nb > 0 and bool(config.superchunk_rows())
        if not device_ok:
            hyb = None
        elif pre_h is not None:
            # the caller's engage scan already said yes
            hyb = op_hybrid.HybridJoinBuild(
                self._kernel, bk, nb, config.join_partitions(), ctx.stats,
                hot_hashes=pre_hot, h=pre_h)
        else:
            hyb = self._maybe_hybrid(ctx, bk, nb)
        ctx.stats.join_paths[self.build_label()] = \
            "hybrid" if hyb is not None else \
            "pipelined" if device_ok else "per-chunk"
        if hyb is not None:
            ctx.stats.hybrid_joins += 1
            try:
                yield from self._hybrid_probe(ctx, probe_iter, build, hyb,
                                              enc, matched_build)
            finally:
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
                if n >= self._DEVICE_MIN_PROBE or \
                        nb >= self._DEVICE_MIN_BUILD:
                    ctx.stats.join_dispatches += 1
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

    def _hybrid_engage(self, bk, nb: int):
        """(engage, hot, h): should the partitioned hybrid path carry this
        build? Decision only, so the fused-fragment eligibility check
        (executor/agg.HashAgg) can consult it and stand aside. The hot set
        is the build side's duplication leg alone: no caller gives the
        port a probe-side CMSketch yet."""
        parts = config.join_partitions()
        if parts <= 1 or nb < self._DEVICE_MIN_BUILD:
            return False, None, None
        h = op_hybrid.build_hashes(bk, nb)
        hot = op_hybrid.detect_hot_hashes(h, config.skew_threshold())
        # no memory quota in the port yet: the reference's quota leg of
        # this test is never true without one
        if not hot.size and nb <= config.superchunk_rows():
            return False, hot, h
        return True, hot, h

    def _maybe_hybrid(self, ctx, bk, nb: int):
        """A HybridJoinBuild when the partitioned path should carry this
        probe: under skew or an over-superchunk build. The unskewed
        in-device-memory case stays on the pipelined probe."""
        engage, hot, h = self._hybrid_engage(bk, nb)
        if not engage:
            return None
        return op_hybrid.HybridJoinBuild(self._kernel, bk, nb,
                                         config.join_partitions(),
                                         ctx.stats, hot_hashes=hot, h=h)

    def _hybrid_probe(self, ctx, probe_iter, build, hyb, enc,
                      matched_build):
        """Partitioned probe over a HybridJoinBuild: probe superchunks
        stream through the dispatch-ahead pipeline, each split into one
        task per partition it touches (the heavy-hitter lane at index
        `parts`); a superchunk's emission fires when its LAST task
        finalizes. Every probe row reaches exactly one _post_match call,
        so outer-join unmatched detection and semi/anti emission stay
        exact."""
        kernel = self._kernel
        stats = ctx.stats
        pending_promo: list = [None]

        def task_iter(sc_iter):
            for sc in sc_iter:
                # apply the promotion observed on the PREVIOUS batch: all
                # of its tasks have dispatched by now, so no routed but
                # undispatched task can straddle the re-layout
                if pending_promo[0] is not None:
                    hyb.promote(pending_promo[0])
                    pending_promo[0] = None
                pk = self._probe_keys(enc, sc)
                hp, tasks = hyb.route(pk, sc.num_rows)
                pending_promo[0] = hyb.observe(hp)
                state = {"chunk": sc, "pk": pk, "hp": hp, "li": [],
                         "ri": [], "left": max(len(tasks), 1)}
                if not tasks:
                    # every row unmatched: one sentinel task still flows
                    # through so the emission fires
                    yield (state, None, None)
                for p, idx in tasks:
                    yield (state, p, idx)

        def dispatch(task):
            state, p, idx = task
            if p is None:
                return None
            bdev = hyb.ensure(p)
            # SNAPSHOT the partition->global row map at dispatch time: a
            # later promotion re-layouts the build while this token is in
            # flight, and the pair indices must resolve against the
            # layout the matcher saw
            rows = hyb.build_rows(p)
            cap = hyb.hot_out_cap(state["hp"][idx]) if p == hyb.parts \
                else None
            sub = [(d[idx], v[idx]) for d, v in state["pk"]]
            hyb.pin(p)
            try:
                tok = kernel.dispatch(None, sub, len(rows), len(idx),
                                      out_cap=cap, build_dev=bdev)
            except BaseException:
                hyb.unpin(p)
                raise
            stats.hybrid_tasks += 1
            return p, rows, tok

        def finalize(task, tok):
            state, _p, idx = task
            if tok is not None:
                p, rows, pend = tok
                try:
                    li_l, ri_l = kernel.finalize(pend)
                finally:
                    hyb.unpin(p)
                state["li"].append(idx[li_l])
                state["ri"].append(rows[ri_l])
            state["left"] -= 1
            if state["left"] > 0:
                return None
            li = np.concatenate(state["li"]) if state["li"] \
                else np.empty(0, dtype=np.int64)
            ri = np.concatenate(state["ri"]) if state["ri"] \
                else np.empty(0, dtype=np.int64)
            return state["chunk"], li, ri

        sc_iter = op_runtime.superchunk_batches(probe_iter,
                                                config.superchunk_rows())
        for out in op_runtime.pipeline_map(task_iter(sc_iter), dispatch,
                                           finalize,
                                           config.pipeline_depth()):
            if out is not None:
                chunk_out, li, ri = out
                yield from self._post_match(chunk_out, build, li, ri,
                                            matched_build)

    def _pipelined_probe(self, ctx, probe_iter, build, bk, enc,
                         matched_build, nb: int):
        """Coalesced probe matching with dispatch-ahead: while superchunk
        k's matcher runs on the device, k+1's keys are encoded, padded and
        transferred. A probe too small to pay a dispatch matches on the
        host inline."""
        kernel = self._kernel
        stats = ctx.stats
        build_dev = None

        def dispatch(sc):
            nonlocal build_dev
            n = sc.num_rows
            pk = self._probe_keys(enc, sc)
            if n < self._DEVICE_MIN_PROBE and nb < self._DEVICE_MIN_BUILD:
                stats.host_match_batches += 1
                return ("host", host_match_pairs(bk, pk, nb, n))
            if build_dev is None:
                # build lanes stay device-resident for the whole probe
                build_dev = kernel.prepare_build(bk, nb)
            stats.join_dispatches += 1
            return ("dev", kernel.dispatch(bk, pk, nb, n,
                                           build_dev=build_dev))

        def finalize(sc, tok):
            kind, payload = tok
            li, ri = payload if kind == "host" else kernel.finalize(payload)
            return sc, li, ri

        sc_iter = op_runtime.superchunk_batches(probe_iter,
                                                config.superchunk_rows())
        for sc, li, ri in op_runtime.pipeline_map(
                sc_iter, dispatch, finalize, config.pipeline_depth()):
            yield from self._post_match(sc, build, li, ri, matched_build)

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
