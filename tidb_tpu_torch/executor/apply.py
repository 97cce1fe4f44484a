"""The subquery apply: the port of the JAX package's ApplyExec and
_ArrayExpr (executor/__init__.py; ref: executor/join.go:447
NestedLoopApplyExec).

Per outer row, the correlated cells of the inner plan are bound to the
row's values and the inner plan runs; the EXISTS / IN / comparison
(with ANY / ALL) predicate filters the outer rows, or (mode "scalar")
the inner's single value becomes a new column. An inner plan with no
correlated cells runs once per statement and its predicate vectorizes
over each outer chunk. IN and NOT IN keep SQL's three-valued logic.

The inner plan is built anew for each run (`build_executor`), over the
same plan objects: a kernel an inner HashAgg makes lives on its plan
node (executor/agg.py `_set_kernel`), so the per-row runs reuse it.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.executor import ExecError, build_executor
from tidb_tpu_torch.expression import Expression
from tidb_tpu_torch.expression.core import Op, func
from tidb_tpu_torch.sqltypes import EvalType, np_dtype_for

__all__ = ["Apply"]


class Apply:
    """Filters (or, mode "scalar", widens) the outer child's chunks by
    the subquery predicate of PhysApply `plan`."""

    def __init__(self, child, plan):
        self.child = child
        self.plan = plan
        self.schema = list(plan.schema.cols)

    def chunks(self, ctx):
        plan = self.plan
        if plan.mode == "scalar":
            yield from self._scalar_chunks(ctx)
            return
        cache = None            # uncorrelated: (vals, valid, has_rows)
        for chunk in self.child.chunks(ctx):
            n = chunk.num_rows
            if n == 0:
                continue
            left = None
            if plan.left is not None:
                ld, lv = plan.left.eval(chunk)
                left = (np.asarray(ld), np.asarray(lv))
            if not plan.corr:
                if cache is None:
                    cache = self._run_inner(
                        ctx, first_only=plan.mode == "exists")
                keep = self._vector_predicate(left, n, *cache)
            else:
                keep = np.zeros(n, dtype=bool)
                for i in range(n):
                    self._bind_corr(chunk, i)
                    vals, valid, has = self._run_inner(
                        ctx, first_only=plan.mode == "exists")
                    row_left = None if left is None else \
                        (left[0][i:i + 1], left[1][i:i + 1])
                    keep[i] = bool(self._vector_predicate(
                        row_left, 1, vals, valid, has)[0])
            yield chunk.filter(keep)

    def _scalar_chunks(self, ctx):
        """mode "scalar": append the inner's single value as a new column
        (the planner's lifted scalar subquery)."""
        plan = self.plan
        ft = plan.schema.cols[-1].ft
        dtype = np_dtype_for(ft.tp, ft.flen)
        cache = None
        for chunk in self.child.chunks(ctx):
            n = chunk.num_rows
            if n == 0:
                continue
            if not plan.corr:
                if cache is None:
                    cache = self._scalar_value(ctx)
                val, ok = cache
                data = np.full(n, val if ok else
                               ("" if dtype == np.dtype(object) else 0),
                               dtype=dtype)
                valid = np.full(n, ok, dtype=bool)
            else:
                data = np.zeros(n, dtype=dtype) \
                    if dtype != np.dtype(object) else \
                    np.full(n, "", dtype=object)
                valid = np.zeros(n, dtype=bool)
                for i in range(n):
                    self._bind_corr(chunk, i)
                    val, ok = self._scalar_value(ctx)
                    if ok:
                        data[i] = val
                        valid[i] = True
            yield Chunk(chunk.columns + [Column(ft, data, valid)])

    def _scalar_value(self, ctx):
        """Run the inner plan expecting at most one row -> (value, ok);
        an empty result is SQL NULL."""
        vals, valid, has = self._run_inner(ctx, first_only=False)
        if not has or len(vals) == 0:
            return None, False
        if len(vals) > 1:
            raise ExecError("Subquery returns more than 1 row")
        return vals[0], bool(valid[0])

    def _bind_corr(self, chunk, i: int):
        """Bind outer row i into the inner plan's correlated cells."""
        for oi, cell in self.plan.corr:
            c = chunk.columns[oi]
            cell.cell[0] = c.data[i]
            cell.cell[1] = bool(c.valid[i])

    def _run_inner(self, ctx, first_only: bool):
        """-> (first-column values, valid, has_rows)."""
        ctx.check_interrupt()
        op = build_executor(self.plan.inner)
        vals = []
        valid = []
        has = False
        for ch in op.chunks(ctx):
            if ch.num_rows == 0:
                continue
            has = True
            if first_only:
                return None, None, True
            c = ch.columns[0]
            vals.append(np.asarray(c.data))
            valid.append(np.asarray(c.valid))
        if not vals:
            return (np.empty(0), np.empty(0, dtype=bool), has)
        return np.concatenate(vals), np.concatenate(valid), has

    def _vector_predicate(self, left, n: int, vals, valid, has):
        plan = self.plan
        if plan.mode == "exists":
            r = np.full(n, has, dtype=bool)
            return ~r if plan.negated else r
        if plan.mode == "cmp":
            if plan.quant:
                return self._quant_mask(left, n, vals, valid)
            if not has or len(vals) == 0:
                return np.zeros(n, dtype=bool)   # NULL -> filtered
            if len(vals) > 1:
                raise ExecError("Subquery returns more than 1 row")
            return self._cmp_mask(left, n, vals, valid)
        # IN / NOT IN with SQL three-valued logic
        ld, lv = left
        inner = vals[valid] if len(vals) else vals
        has_null = bool((~valid).any()) if len(valid) else False
        match = self._set_match(ld, inner)
        if plan.negated:
            # NOT IN: TRUE only for a valid left, no match and no NULL in
            # the subquery's result (else NULL), except the empty set,
            # where x NOT IN () is TRUE even for a NULL x
            if has_null:
                return np.zeros(n, dtype=bool)
            if len(inner) == 0:
                return np.ones(n, dtype=bool)
            return lv & ~match
        return lv & match

    def _norm_in_sides(self, ld, inner):
        """Both IN sides in one comparable representation (as HashJoin
        normalizes its keys): decimals at a common scale, mixed numeric
        as double."""
        lft = self.plan.left.ft
        ift = self.plan.inner.schema.cols[0].ft
        let, iet = lft.eval_type, ift.eval_type
        if np.dtype(object) in (getattr(ld, "dtype", None),
                                getattr(inner, "dtype", None)):
            return ld, inner
        lfrac = lft.frac if let == EvalType.DECIMAL else 0
        ifrac = ift.frac if iet == EvalType.DECIMAL else 0
        if let == iet and lfrac == ifrac:
            return ld, inner

        def to_f(d, frac):
            return np.asarray(d).astype(np.float64) / (10.0 ** frac)
        return to_f(ld, lfrac), to_f(inner, ifrac)

    def _quant_mask(self, left, n: int, vals, valid):
        """expr <cmp> ANY/ALL (subquery) with SQL three-valued logic: only
        the set's extrema decide an ordering comparison.

        ANY: TRUE if some valid element satisfies; else NULL if the set
             has NULLs or the left is NULL; else FALSE (empty -> FALSE).
        ALL: FALSE if some valid element violates; else NULL if the set
             has NULLs or the left is NULL; else TRUE (empty -> TRUE)."""
        plan = self.plan
        ld, lv = left
        vv = vals[valid] if len(vals) else vals
        has_null_inner = bool((~valid).any()) if len(valid) else False
        is_all = plan.quant == "all"
        if len(vv) == 0:
            if has_null_inner:          # all-NULL set: always NULL
                return np.zeros(n, dtype=bool)
            base = np.full(n, is_all, dtype=bool)   # truly empty set
            return ~base if plan.negated else base
        op = plan.cmp_op

        def cmp_vs(v, o):
            return self._one_cmp(ld, lv, n, v, o)

        lo, hi = vv.min(), vv.max()
        if op in (Op.EQ, Op.NE):
            # = ANY is IN; = ALL: every element equal (min == v == max);
            # <> ALL is NOT IN; <> ANY: some element differs
            def all_eq():
                return cmp_vs(lo, Op.EQ) & cmp_vs(hi, Op.EQ)

            def in_set():
                return lv & self._set_match(ld, vv)
            if op == Op.EQ:
                true_m = all_eq() if is_all else in_set()
            else:
                true_m = (lv & ~in_set()) if is_all else (lv & ~all_eq())
        else:
            # ordering: ANY against the friendliest element, ALL against
            # the harshest
            pick_min = (op in (Op.GT, Op.GE)) != is_all
            true_m = cmp_vs(lo if pick_min else hi, op)
        if is_all:
            # a violation is a definite FALSE even with NULLs around
            false_m = lv & ~true_m
            if has_null_inner:
                true_m = np.zeros(n, dtype=bool)
            return false_m if plan.negated else true_m
        if has_null_inner:
            false_m = np.zeros(n, dtype=bool)
        else:
            false_m = lv & ~true_m
        return false_m if plan.negated else true_m

    def _set_match(self, ld, inner):
        """Membership of each left value in the inner set, after the
        shared normalization (IN and the EQ quantifiers)."""
        ld2, inner2 = self._norm_in_sides(ld, inner)
        if len(inner2) and inner2.dtype != np.dtype(object) and \
                ld2.dtype != np.dtype(object):
            return np.isin(ld2, inner2)
        pool = set(inner2.tolist())
        return np.array([v in pool for v in ld2], dtype=bool)

    def _one_cmp(self, ld, lv, n: int, v, op):
        """Vector compare of the left side against one inner value,
        through the expression layer for type-correct semantics."""
        plan = self.plan
        ift = plan.inner.schema.cols[0].ft
        dt = np.dtype(object) if isinstance(v, (str, bytes)) else None
        rhs_d = np.full(n, v, dtype=dt)
        lexpr = _ArrayExpr(plan.left.ft, ld, lv)
        rexpr = _ArrayExpr(ift, rhs_d, np.ones(n, dtype=bool))
        d, vmask = func(op, lexpr, rexpr).eval_xp(np, [], n)
        return np.asarray(d).astype(bool) & np.asarray(vmask) & lv

    def _cmp_mask(self, left, n: int, vals, valid):
        plan = self.plan
        if not bool(valid[0]):
            return np.zeros(n, dtype=bool)       # NULL scalar
        ld, lv = left
        ift = plan.inner.schema.cols[0].ft
        v = vals[0]
        rhs_d = np.full(n, v, dtype=vals.dtype) if \
            vals.dtype != np.dtype(object) else np.full(n, v, dtype=object)
        lexpr = _ArrayExpr(plan.left.ft, ld, lv)
        rexpr = _ArrayExpr(ift, rhs_d, np.ones(n, dtype=bool))
        d, vmask = func(plan.cmp_op, lexpr, rexpr).eval_xp(np, [], n)
        out = np.asarray(d).astype(bool) & np.asarray(vmask)
        return ~out & np.asarray(vmask) if plan.negated else out


class _ArrayExpr(Expression):
    """A precomputed (data, valid) pair as an Expression leaf."""

    def __init__(self, ft, data, valid):
        self.ft = ft
        self._d = data
        self._v = valid

    def eval_xp(self, xp, cols, n):
        return self._d, self._v

    def columns_used(self):
        return set()

    def is_device_safe(self):
        return False
