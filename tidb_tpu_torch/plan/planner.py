"""Rule-based planner: AST -> physical plan with storage pushdown.

The port's copy of the JAX package's plan/planner.py, with two cuts: no
mesh pass (on one device the reference's route_mesh returns the plan
unchanged; the multi-device plane is not ported), and the cluster_*
memtables, which fan out over the fleet's membership plane, raise "not
ported yet". The information_schema observability memtables read
memtrack, the meter, the trace ring, the profiler and perfschema's
mode memo; the performance_schema memtables read perfschema.py.

Reference: TiDB's plan/ — logical build (logical_plan_builder.go),
rule-based optimization {columnPruner, ppdSolver, aggregationOptimizer,
pushDownTopNOptimizer} (plan/optimizer.go:42-50), and the copTask/rootTask
split (plan/task.go:116-499). Rules here run during construction:

* predicate pushdown: WHERE/ON conjuncts sink into table readers (split
  into device-safe vs host-only parts), equi-conds become hash-join keys
* column pruning: readers scan only referenced columns
* aggregation pushdown: single-reader group-by ships as a storage-side
  partial agg (CopPlan.aggs) merged by a root PhysFinalAgg
* TopN pushdown: ORDER BY + LIMIT over a bare reader pushes the limit
"""

from __future__ import annotations

from tidb_tpu_torch import sqltypes as st
from tidb_tpu_torch.errcode import not_ported
from tidb_tpu_torch.expression import (AggDesc, AggFunc, ColumnRef, Constant,
                                 Expression, Op, ScalarFunc, and_all, func)
from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.plan import physical as ph
from tidb_tpu_torch.plan.resolver import (ColumnAmbiguousError, PlanSchema,
                                    Resolver, ResolveError, SchemaCol)
from tidb_tpu_torch.schema.infoschema import InfoSchema, SchemaError

__all__ = ["Planner", "PlanError"]


class PlanError(Exception):
    pass


def split_conjuncts(e: ast.ExprNode | None) -> list[ast.ExprNode]:
    if e is None:
        return []
    if isinstance(e, ast.BinaryOp) and e.op == "AND":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def flatten_and(e: Expression | None) -> list[Expression]:
    if e is None:
        return []
    if isinstance(e, ScalarFunc) and e.op == Op.AND:
        return flatten_and(e.args[0]) + flatten_and(e.args[1])
    return [e]


def split_device_host(cond: Expression | None):
    """Partition a resolved conjunction into (device_safe, host_only)."""
    if cond is None:
        return None, None
    dev, host = [], []

    def walk(c: Expression):
        if isinstance(c, ScalarFunc) and c.op == Op.AND:
            walk(c.args[0])
            walk(c.args[1])
        elif c.is_device_safe():
            dev.append(c)
        else:
            host.append(c)

    walk(cond)
    return and_all(dev), and_all(host)


class _JoinGeometry:
    """Shared bookkeeping for one inner-join tree: leaf offsets in the
    concatenated schema, per-condition leaf sets, per-leaf size
    estimates (0 is a real estimate — an empty side should lead)."""

    BIG = 1 << 40      # leaves with no estimate order last

    def __init__(self, leaves, conds):
        self.leaves = leaves
        self.conds = conds
        self.offs = []
        at = 0
        for lf in leaves:
            self.offs.append(at)
            at += len(lf.schema)
        self.size = []
        for lf in leaves:
            est = getattr(lf, "est_rows", None)
            self.size.append(self.BIG if est is None else est)
        self.cond_leaves = [
            frozenset(self.leaf_of(i) for i in c.columns_used())
            for c in conds]

    def leaf_of(self, idx: int) -> int:
        for li in range(len(self.leaves)):
            if self.offs[li] <= idx < \
                    self.offs[li] + len(self.leaves[li].schema):
                return li
        raise PlanError("column outside join leaves")


class Planner:
    def __init__(self, infoschema: InfoSchema, current_db: str,
                 stats_handle=None, storage=None):
        self.stats = stats_handle
        self.ischema = infoschema
        self.db = current_db
        self.storage = storage   # membership registry for cluster_* fan-out
        self._handle_refs: set = set()   # multi-table DELETE targets
        # (level, code, message) notes the session surfaces as SHOW
        # WARNINGS — e.g. a cluster_* fan-out that degraded to partial
        # rows because a member was unreachable
        self.warnings: list[tuple[str, int, str]] = []

    def _tbl_stats(self, info):
        """TableStats for the table — pseudo when never analyzed."""
        if self.stats is None:
            from tidb_tpu_torch.statistics import TableStats
            return TableStats(table_id=info.id)
        return self.stats.get(info.id)

    # -- entry ---------------------------------------------------------------

    def plan(self, stmt: ast.StmtNode) -> ph.PhysPlan:
        if isinstance(stmt, (ast.SelectStmt, ast.UnionStmt)):
            from tidb_tpu_torch.plan.resolver import (mark_volatile,
                                                reset_volatile, was_volatile)
            # The volatile flag is process-global; a nested plan() (sub-
            # query, derived table) must compute ITS cacheability from a
            # clean flag, then leave "outer-so-far OR child" behind so an
            # enclosing statement keeps any NOW()-style fold it already
            # marked and inherits the child's volatility.
            outer_volatile = was_volatile()
            reset_volatile()
            built = self._plan_query(stmt)
            # no mesh pass: on one device the reference's route_mesh
            # returns the plan unchanged (plan/mesh_route.py), and the
            # multi-device plane is not ported
            p = self._opt_physical(self._reorder_joins(
                self._opt_access(built)))
            p.cacheable = not was_volatile()
            if outer_volatile:
                mark_volatile()
            return p
        if isinstance(stmt, ast.InsertStmt):
            p = self.plan_insert(stmt)
            if p.source is not None:
                p.source = self._opt_access(p.source)
            return p
        if isinstance(stmt, ast.UpdateStmt):
            p = self.plan_update(stmt)
            p.reader = self._opt_access(p.reader)
            return p
        if isinstance(stmt, ast.DeleteStmt):
            p = self.plan_delete(stmt)
            p.reader = self._opt_access(p.reader)
            return p
        raise PlanError(f"no plan for {type(stmt).__name__}")

    # -- FROM ----------------------------------------------------------------

    def _table_info(self, ts: ast.TableSource):
        db = ts.db or self.db
        if not db:
            raise PlanError("No database selected")
        try:
            return db, self.ischema.table(db, ts.name)
        except SchemaError as e:
            raise PlanError(str(e)) from None

    def build_reader(self, ts: ast.TableSource) -> ph.PhysPlan:
        db = (ts.db or self.db).lower()
        if db == "information_schema":
            return self._build_memtable(ts)
        if db == "performance_schema":
            return self._build_perfschema(ts)
        _db, info = self._table_info(ts)
        cols = info.public_columns()
        schema_cols = [
            SchemaCol(c.name.lower(), ts.ref_name.lower(), c.ft, c.id)
            for c in cols]
        handle_col = None
        if ts.ref_name.lower() in getattr(self, "_handle_refs", ()):
            # multi-table DELETE target: the row handle rides the join
            schema_cols.append(SchemaCol("_handle", ts.ref_name.lower(),
                                         st.new_int_field()))
            handle_col = len(cols)
        cop = ph.CopPlan(table=info, cols=list(cols),
                         handle_col=handle_col,
                         index_hints=list(ts.index_hints))
        return ph.PhysTableReader(schema=PlanSchema(schema_cols), cop=cop)

    # -- INFORMATION_SCHEMA virtual tables (ref: infoschema/tables.go) -------

    _MEMTABLES = ("schemata", "tables", "columns", "statistics",
                  "character_sets", "collations", "memory_usage",
                  "statement_traces", "resource_usage",
                  "kernel_profile", "statement_profile")
    # the reference's memtables over the fleet's membership plane
    _UNPORTED_MEMTABLES = ("cluster_members", "cluster_processlist",
                           "cluster_resource_usage",
                           "cluster_statement_traces",
                           "cluster_kernel_profile")

    def _build_memtable(self, ts: ast.TableSource) -> ph.PhysValues:
        """Serve catalog metadata as constant rows computed from the
        current schema snapshot (the TableScanExec-over-memtable role of
        executor.go:803-912 + infoschema/tables.go)."""
        from tidb_tpu_torch.schema.model import SchemaState
        from tidb_tpu_torch.sqltypes import (new_int_field, new_string_field)
        name = ts.name.lower()
        alias = ts.ref_name.lower()
        if name in self._UNPORTED_MEMTABLES:
            raise PlanError(not_ported(f"information_schema.{name}"))
        sf, intf = new_string_field(64), new_int_field()

        def mk(cols_spec, rows):
            schema = PlanSchema([SchemaCol(n, alias, ft)
                                 for n, ft in cols_spec])
            const_rows = []
            for r in rows:
                exprs = []
                for v, (_n, ft) in zip(r, cols_spec):
                    exprs.append(Constant(v, ft))
                const_rows.append(exprs)
            return ph.PhysValues(schema=schema, rows=const_rows)

        isch = self.ischema
        if name == "schemata":
            return mk([("catalog_name", sf), ("schema_name", sf)],
                      [("def", d) for d in
                       ["information_schema"] + isch.db_names()])
        if name == "tables":
            rows = []
            for d in isch.db_names():
                for t in isch.table_names(d):
                    info = isch.table(d, t)
                    rows.append(("def", d, t, "BASE TABLE", info.id))
            return mk([("table_catalog", sf), ("table_schema", sf),
                       ("table_name", sf), ("table_type", sf),
                       ("tidb_table_id", intf)], rows)
        if name == "columns":
            rows = []
            for d in isch.db_names():
                for t in isch.table_names(d):
                    info = isch.table(d, t)
                    for pos, c in enumerate(info.public_columns(), 1):
                        key = "PRI" if (info.pk_is_handle and
                                        c.name == info.pk_col_name) else ""
                        rows.append((d, t, c.name.lower(), pos,
                                     _type_word(c.ft),
                                     "NO" if c.ft.not_null else "YES",
                                     key))
            return mk([("table_schema", sf), ("table_name", sf),
                       ("column_name", sf), ("ordinal_position", intf),
                       ("data_type", sf), ("is_nullable", sf),
                       ("column_key", sf)], rows)
        if name == "statistics":
            rows = []
            for d in isch.db_names():
                for t in isch.table_names(d):
                    info = isch.table(d, t)
                    if info.pk_is_handle and info.pk_col_name:
                        rows.append((d, t, 0, "PRIMARY", 1,
                                     info.pk_col_name.lower()))
                    for idx in info.indexes:
                        if idx.state != SchemaState.PUBLIC:
                            continue
                        for seq, cn in enumerate(idx.columns, 1):
                            rows.append((d, t, 0 if idx.unique else 1,
                                         idx.name.lower(), seq,
                                         cn.lower()))
            return mk([("table_schema", sf), ("table_name", sf),
                       ("non_unique", intf), ("index_name", sf),
                       ("seq_in_index", intf), ("column_name", sf)], rows)
        if name == "character_sets":
            # the four charsets the engine actually stores (ref:
            # infoschema/tables.go charset rows / util/charset)
            rows = [("utf8mb4", "utf8mb4_bin", "UTF-8 Unicode", 4),
                    ("utf8", "utf8_bin", "UTF-8 Unicode", 3),
                    ("latin1", "latin1_bin", "cp1252 West European", 1),
                    ("binary", "binary", "Binary pseudo charset", 1)]
            return mk([("character_set_name", sf),
                       ("default_collate_name", sf),
                       ("description", sf), ("maxlen", intf)], rows)
        if name == "memory_usage":
            # hierarchical memory trackers (memtrack.py): one row per
            # live session (current + peak, host/device ledgers) plus
            # the server-root totals every session rolls up into
            from tidb_tpu_torch import memtrack
            srv = memtrack.SERVER.snapshot()
            rows = [("server", 0, srv["host"], srv["device"],
                     srv["host_peak"], srv["device_peak"])]
            for snap in memtrack.sessions_snapshot():
                sid = snap["label"].rsplit("-", 1)[-1]
                rows.append(("session",
                             int(sid) if sid.isdigit() else 0,
                             snap["host"], snap["device"],
                             snap["host_peak"], snap["device_peak"]))
            pv = mk([("scope", sf), ("session_id", intf),
                     ("current_host_bytes", intf),
                     ("current_device_bytes", intf),
                     ("peak_host_bytes", intf),
                     ("peak_device_bytes", intf)], rows)
            # tracker state moves per statement with no schema-version
            # bump: a cached plan would serve a frozen snapshot forever
            pv.cacheable = False
            return pv
        if name == "resource_usage":
            # the continuous resource meter (meter.py): cumulative AND
            # current-interval work per tenant — device busy-time,
            # host-fallback time, sched slot / admission waits, bytes
            # dispatched, rows served — one row per user and per
            # session (live or retained-closed), plus the SERVER total
            # row the per-session sum reconciles against
            from tidb_tpu_torch import meter
            rows = []

            def row(scope, snap):
                iv = snap["interval"]
                rows.append((scope, snap["session_id"],
                             snap["user"] or None, snap["statements"],
                             snap["device_ns"], iv["device_ns"],
                             snap["host_fallback_ns"],
                             snap["slot_wait_ns"],
                             snap["admission_wait_ns"],
                             snap["rows_sent"], snap["bytes_encoded"],
                             snap["bytes_decoded_equiv"]))

            row("server", meter.server_snapshot())
            for snap in meter.users_snapshot():
                row("user", snap)
            for snap in meter.sessions_snapshot():
                row("session", snap)
            pv = mk([("scope", sf), ("session_id", intf), ("user", sf),
                     ("statements", intf), ("device_time_ns", intf),
                     ("device_time_interval_ns", intf),
                     ("host_fallback_ns", intf),
                     ("slot_wait_ns", intf),
                     ("admission_wait_ns", intf),
                     ("rows_sent", intf), ("bytes_encoded", intf),
                     ("bytes_decoded_equiv", intf)], rows)
            # meter state moves per statement with no schema-version
            # bump: a cached plan would serve a frozen snapshot forever
            pv.cacheable = False
            return pv
        if name == "statement_traces":
            # retained statement span trees (trace.py ring): one row
            # per trace, joinable to perfschema digests via `digest`
            # (events_statements_summary_by_digest.last_trace_id points
            # back here); the full tree serves on GET /trace/<id>
            from tidb_tpu_torch import trace as _trace
            rows = []
            for r in _trace.ring_snapshot():
                rows.append((r["trace_id"], r["digest"],
                             r["sql"][:256], int(r["start_unix"] * 1e6),
                             r["duration_ns"], r["span_count"],
                             r["reason"], r["error"]))
            pv = mk([("trace_id", intf), ("digest", sf),
                     ("sql_text", new_string_field(256)),
                     ("start_time_us", intf), ("duration_ns", intf),
                     ("span_count", intf), ("reason", sf),
                     ("error", sf)], rows)
            # the ring moves per statement with no schema-version bump
            pv.cacheable = False
            return pv
        if name == "kernel_profile":
            # the kernel profiling plane (profiler.py): one row per
            # (kernel family, plan fingerprint, mesh) — compile cost and
            # cache attribution, dispatch/byte totals, and where the
            # kernel sits against the platform's memory roofline
            from tidb_tpu_torch import profiler
            from tidb_tpu_torch.sqltypes import new_double_field
            df = new_double_field()
            rows = []
            for p in profiler.snapshot():
                rows.append((p["family"], p["fingerprint"], p["mesh"],
                             p["generation"], p["compiles"],
                             p["compile_ns"], p["compile_cache"],
                             p["pcache_hits"], p["pcache_misses"],
                             p["reuses"], p["dispatches"], p["busy_ns"],
                             p["bytes_in"], p["bytes_out"],
                             p["bytes_encoded"],
                             p["bytes_decoded_equiv"],
                             p["escalations"], p["fallbacks"],
                             p["achieved_gbps"],
                             p["roofline_fraction"]))
            pv = mk([("family", sf), ("fingerprint", sf), ("mesh", sf),
                     ("generation", intf), ("compiles", intf),
                     ("compile_ns", intf), ("compile_cache", sf),
                     ("pcache_hits", intf), ("pcache_misses", intf),
                     ("reuses", intf), ("dispatches", intf),
                     ("busy_ns", intf), ("bytes_in", intf),
                     ("bytes_out", intf), ("bytes_encoded", intf),
                     ("bytes_decoded_equiv", intf),
                     ("escalations", intf), ("fallbacks", intf),
                     ("achieved_gbps", df),
                     ("roofline_fraction", df)], rows)
            # profile rows move per dispatch with no schema-version
            # bump: a cached plan would serve a frozen snapshot forever
            pv.cacheable = False
            return pv
        if name == "statement_profile":
            # the per-digest mode-history memo (perfschema.py): which
            # execution mode each operator of each digest actually ran,
            # with observed group cardinality and per-mode device time —
            # the read side for feedback-driven mode selection
            from tidb_tpu_torch import perfschema
            rows = []
            for r in perfschema.memo_snapshot():
                rows.append((r["digest"], r["op"], r["mode"], r["runs"],
                             r["device_ns"], r["rows"], r["last_mode"],
                             r["last_groups"], r["max_groups"],
                             int(r["last_seen"] * 1e6)))
            pv = mk([("digest", sf), ("op", sf), ("mode", sf),
                     ("runs", intf), ("device_ns", intf),
                     ("rows", intf), ("last_mode", sf),
                     ("last_groups", intf), ("max_groups", intf),
                     ("last_seen_us", intf)], rows)
            pv.cacheable = False
            return pv
        if name == "collations":
            rows = [("utf8mb4_bin", "utf8mb4", 46, "", "Yes", 1),
                    ("utf8mb4_general_ci", "utf8mb4", 45, "Yes", "Yes", 1),
                    ("utf8_bin", "utf8", 83, "", "Yes", 1),
                    ("utf8_general_ci", "utf8", 33, "Yes", "Yes", 1),
                    ("latin1_bin", "latin1", 47, "", "Yes", 1),
                    ("binary", "binary", 63, "Yes", "Yes", 1)]
            return mk([("collation_name", sf), ("character_set_name", sf),
                       ("id", intf), ("is_default", sf),
                       ("is_compiled", sf), ("sortlen", intf)], rows)
        raise PlanError(
            f"Unknown table 'information_schema.{ts.name}' "
            f"(available: {', '.join(self._MEMTABLES)})")

    # -- PERFORMANCE_SCHEMA virtual tables (ref: perfschema/const.go:120-298
    # events_statements_current / events_statements_history) -----------------

    _PERF_TABLES = ("events_statements_current",
                    "events_statements_history",
                    "events_statements_summary_by_digest")

    def _build_perfschema(self, ts: ast.TableSource) -> ph.PhysValues:
        from tidb_tpu_torch import perfschema
        from tidb_tpu_torch.sqltypes import new_int_field, new_string_field
        name = ts.name.lower()
        alias = ts.ref_name.lower()
        if name not in self._PERF_TABLES:
            raise PlanError(
                f"Unknown table 'performance_schema.{ts.name}' "
                f"(available: {', '.join(self._PERF_TABLES)})")
        if name == "events_statements_summary_by_digest":
            return self._build_digest_summary(alias)
        events = perfschema.current_events() \
            if name == "events_statements_current" \
            else perfschema.history_events()
        sf, intf = new_string_field(1024), new_int_field()
        cols_spec = [("thread_id", intf), ("event_id", intf),
                     ("sql_text", sf), ("state", sf),
                     ("timer_start_us", intf), ("timer_wait_ns", intf),
                     ("parse_ns", intf), ("plan_ns", intf),
                     ("exec_ns", intf), ("commit_ns", intf),
                     ("rows_sent", intf), ("error", sf)]
        schema = PlanSchema([SchemaCol(n, alias, ft)
                             for n, ft in cols_spec])
        rows = []
        for ev in events:
            rows.append([Constant(v, ft) for v, (_n, ft) in zip(
                (ev["thread_id"], ev["event_id"], ev["sql_text"],
                 ev["state"], ev["timer_start_us"], ev["timer_wait_ns"],
                 ev["parse_ns"], ev["plan_ns"], ev["exec_ns"],
                 ev["commit_ns"], ev["rows"], ev["error"]), cols_spec)])
        pv = ph.PhysValues(schema=schema, rows=rows)
        # events change per statement with no schema-version bump: a
        # cached plan would serve a frozen snapshot forever
        pv.cacheable = False
        return pv

    def _build_digest_summary(self, alias: str) -> ph.PhysValues:
        """events_statements_summary_by_digest: the per-digest aggregate
        rows (ref: util/stmtsummary/statement_summary.go surfaced as a
        performance_schema memtable)."""
        from tidb_tpu_torch import perfschema
        from tidb_tpu_torch.sqltypes import new_int_field, new_string_field
        sf, intf = new_string_field(1024), new_int_field()
        cols_spec = [("digest", sf), ("digest_text", sf),
                     ("exec_count", intf), ("sum_latency_ns", intf),
                     ("max_latency_ns", intf), ("min_latency_ns", intf),
                     ("avg_latency_ns", intf), ("sum_parse_ns", intf),
                     ("sum_plan_ns", intf), ("sum_exec_ns", intf),
                     ("sum_commit_ns", intf), ("sum_rows", intf),
                     ("sum_errors", intf), ("max_mem_bytes", intf),
                     ("last_trace_id", intf), ("first_seen", intf),
                     ("last_seen", intf), ("top_operators", sf)]
        schema = PlanSchema([SchemaCol(n, alias, ft)
                             for n, ft in cols_spec])
        rows = []
        for r in perfschema.digest_summary():
            vals = (r["digest"], r["digest_text"], r["exec_count"],
                    r["sum_latency_ns"], r["max_latency_ns"],
                    r["min_latency_ns"], r["avg_latency_ns"],
                    r["sum_parse_ns"], r["sum_plan_ns"],
                    r["sum_exec_ns"], r["sum_commit_ns"], r["sum_rows"],
                    r["sum_errors"], r["max_mem_bytes"],
                    r["last_trace_id"], int(r["first_seen"]),
                    int(r["last_seen"]), r["top_operators"])
            rows.append([Constant(v, ft)
                         for v, (_n, ft) in zip(vals, cols_spec)])
        pv = ph.PhysValues(schema=schema, rows=rows)
        pv.cacheable = False     # aggregates move per statement
        return pv

    def build_from(self, node) -> ph.PhysPlan:
        if isinstance(node, ast.TableSource):
            return self.build_reader(node)
        if isinstance(node, ast.SubqueryTable):
            sub = self._plan_query(node.select)
            alias = node.alias.lower()
            schema = PlanSchema([
                SchemaCol(c.name, alias, c.ft) for c in sub.schema.cols])
            sub.schema = schema
            return sub
        if isinstance(node, ast.Join):
            left = self.build_from(node.left)
            right = self.build_from(node.right)
            tp = {ast.JoinType.INNER: "inner", ast.JoinType.CROSS: "inner",
                  ast.JoinType.LEFT: "left",
                  ast.JoinType.RIGHT: "right"}[node.tp]
            join = ph.PhysHashJoin(
                schema=left.schema.merge(right.schema),
                children=[left, right], join_type=tp)
            conds = []
            if node.on is not None:
                r = Resolver(join.schema)
                conds = [r.resolve(c) for c in split_conjuncts(node.on)]
            using = list(node.using)
            if node.natural:
                # NATURAL JOIN: equijoin on every shared column name,
                # in left-schema order (ref: MySQL natural join rules)
                rnames = {c.name for c in right.schema.cols}
                using = [c.name for c in left.schema.cols
                         if c.name in rnames]
            for u in using:
                li = left.schema.find(u)
                ri = right.schema.find(u)
                conds.append(func(
                    Op.EQ, ColumnRef(li, left.schema.cols[li].ft),
                    ColumnRef(ri + len(left.schema), right.schema.cols[ri].ft)))
            for c in conds:
                self._assign_cond(join, c, where_phase=False)
            if using:
                # USING/NATURAL coalesce the join columns: they appear
                # ONCE (from the row-preserving side), first, then the
                # remaining left then right columns — and unqualified
                # references to them are not ambiguous
                nl = len(left.schema)
                u_low = [u.lower() for u in using]
                take = []
                for u in u_low:
                    take.append(right.schema.find(u) + nl
                                if tp == "right" else left.schema.find(u))
                for i, c in enumerate(left.schema.cols):
                    if c.name.lower() not in u_low:
                        take.append(i)
                for i, c in enumerate(right.schema.cols):
                    if c.name.lower() not in u_low:
                        take.append(nl + i)
                cols = [join.schema.cols[i] for i in take]
                return ph.PhysProjection(
                    schema=PlanSchema(list(cols)), children=[join],
                    exprs=[ColumnRef(i, join.schema.cols[i].ft)
                           for i in take])
            return join
        raise PlanError(f"unsupported FROM {type(node).__name__}")

    # -- predicate assignment ------------------------------------------------

    def _assign_cond(self, plan: ph.PhysPlan, cond: Expression,
                     where_phase: bool) -> ph.PhysPlan:
        """Sink one resolved conjunct as deep as legal; returns the
        (possibly wrapped) plan."""
        if isinstance(plan, ph.PhysHashJoin):
            nl = len(plan.children[0].schema)
            used = cond.columns_used()
            left_ok = all(i < nl for i in used)
            right_ok = all(i >= nl for i in used)
            lt = plan.join_type
            if left_ok and (lt != "right" or not where_phase or
                            self._rejects_null(cond)):
                plan.children[0] = self._assign_cond(
                    plan.children[0], cond, where_phase)
                return plan
            if right_ok and (lt != "left" or not where_phase or
                             self._rejects_null(cond)):
                remap = {i: i - nl for i in used}
                plan.children[1] = self._assign_cond(
                    plan.children[1], cond.map_columns(remap), where_phase)
                return plan
            # equi-join key? EQ(left col expr, right col expr)
            if isinstance(cond, ScalarFunc) and cond.op == Op.EQ and \
                    lt in ("inner", "left", "right"):
                a, b = cond.args
                ua, ub = a.columns_used(), b.columns_used()
                if ua and ub:
                    if all(i < nl for i in ua) and all(i >= nl for i in ub):
                        plan.left_keys.append(a)
                        plan.right_keys.append(
                            b.map_columns({i: i - nl for i in ub}))
                        return plan
                    if all(i < nl for i in ub) and all(i >= nl for i in ua):
                        plan.left_keys.append(b)
                        plan.right_keys.append(
                            a.map_columns({i: i - nl for i in ua}))
                        return plan
            if lt == "inner":
                plan.other_cond = cond if plan.other_cond is None else \
                    func(Op.AND, plan.other_cond, cond)
                return plan
            # outer join + unpushable WHERE cond: filter above the join
            return ph.PhysSelection(schema=plan.schema, children=[plan],
                                    cond=cond)
        if isinstance(plan, ph.PhysTableReader) and not plan.cop.is_agg:
            dev, host = split_device_host(cond)
            if dev is not None:
                plan.cop.filter = dev if plan.cop.filter is None else \
                    func(Op.AND, plan.cop.filter, dev)
            if host is not None:
                plan.cop.host_filter = host if plan.cop.host_filter is None \
                    else func(Op.AND, plan.cop.host_filter, host)
            return plan
        if isinstance(plan, ph.PhysSelection):
            plan.cond = func(Op.AND, plan.cond, cond)
            return plan
        if isinstance(plan, ph.PhysApply):
            if plan.mode == "scalar" and any(
                    i >= len(plan.children[0].schema)
                    for i in cond.columns_used()):
                # the predicate reads the appended scalar column: it
                # cannot sink below the apply that produces it
                return ph.PhysSelection(schema=plan.schema,
                                        children=[plan], cond=cond)
            # sink plain predicates below the apply (same outer schema,
            # scalar appends at the end so base indices are stable):
            # the correlated inner then runs only for surviving rows
            plan.children[0] = self._assign_cond(plan.children[0], cond,
                                                 where_phase)
            return plan
        return ph.PhysSelection(schema=plan.schema, children=[plan],
                                cond=cond)

    # -- access path selection ----------------------------------------------

    def _opt_access(self, plan: ph.PhysPlan) -> ph.PhysPlan:
        """Post-pass (ref: plan/physical_plan_builder.go:203-516 access-path
        choice, rule-based until stats land): walk the tree; for every
        table reader, extract pk-handle ranges (always, also under agg
        pushdown) and consider unique-point gets / secondary-index paths
        for non-agg readers. All original conjuncts stay as residual
        filters, so range extraction can never change results."""
        for i, c in enumerate(plan.children):
            plan.children[i] = self._opt_access(c)
        if isinstance(plan, ph.PhysTableReader):
            return self._choose_access_path(plan)
        return plan

    # Cost factors (ref: the copTask/rootTask cost charges, plan/task.go:213
    # netWorkFactor and the double-read penalty of IndexLookUp).
    _COVER_FACTOR = 1.2    # covering index: scan + net per row
    _LOOKUP_FACTOR = 4.0   # index lookup: scan + net + random row fetch

    def _choose_access_path(self, reader: ph.PhysTableReader) -> ph.PhysPlan:
        from tidb_tpu_torch import ranger as rg
        cop = reader.cop
        info = cop.table
        conj = flatten_and(cop.filter) + flatten_and(cop.host_filter)
        st = self._tbl_stats(info)
        use_cbo = not st.pseudo
        if use_cbo:
            from tidb_tpu_torch.statistics import selectivity
            reader.est_rows = max(1, st.count) * (selectivity(
                st, conj, reader.schema.cols, info) if conj else 1.0)
        if not conj or cop.ranges is not None:
            return reader
        off_by_name: dict[str, int] = {}
        for i, sc in enumerate(reader.schema.cols):
            off_by_name.setdefault(sc.name, i)

        # 1. pk-is-handle ranges (narrow the record scan in place)
        if info.pk_is_handle and info.pk_col_name:
            pk_off = off_by_name.get(info.pk_col_name.lower())
            if pk_off is not None:
                path = rg.detach_handle_conditions(conj, pk_off)
                if path.useful and path.ranges is not None:
                    kvr = rg.handle_ranges_to_kv(info.id, path.ranges)
                    if kvr is not None:
                        if not cop.is_agg and len(path.ranges) == 1 and \
                                path.eq_count == 1 and \
                                isinstance(path.ranges[0].low[0], int) and \
                                path.ranges[0].low == path.ranges[0].high:
                            return self._point_get(reader,
                                                   path.ranges[0].low[0],
                                                   None, None)
                        cop.ranges = kvr
                        # when the ranges encode EVERY conjunct, the scan's
                        # actual row count is exactly the range count ->
                        # feed it back to the pk histogram
                        if len(path.consumed) == len(conj) and \
                                not cop.is_agg and use_cbo:
                            pk_col = info.col_by_name(info.pk_col_name)
                            cop.feedback = (pk_col.id, path.ranges)
                        return reader

        # 2. secondary-index paths (non-agg readers only: agg pushdown to
        # the device kernel beats an index lookup unless stats say otherwise)
        if cop.is_agg or cop.limit is not None:
            return reader
        # index columns are covering iff every output column is indexed
        idx_cover_base = set()
        if info.pk_is_handle and info.pk_col_name:
            idx_cover_base.add(info.pk_col_name.lower())
        # USE/IGNORE/FORCE INDEX hints (ref: planbuilder.go
        # getPossibleAccessPaths): IGNORE removes candidates, USE/FORCE
        # restrict to the named set, FORCE additionally disfavors the
        # full table scan
        ignored = {n.lower() for k, ns in cop.index_hints
                   if k == "IGNORE" for n in ns}
        restrict = {n.lower() for k, ns in cop.index_hints
                    if k in ("USE", "FORCE") for n in ns}
        forced = any(k == "FORCE" and ns for k, ns in cop.index_hints)
        candidates = []
        for idx in info.indexes:
            from tidb_tpu_torch.schema.model import SchemaState
            if idx.state != SchemaState.PUBLIC:
                continue
            if idx.name.lower() in ignored:
                continue
            if restrict and idx.name.lower() not in restrict:
                continue
            offsets, fts = [], []
            ok = True
            for cname in idx.columns:
                o = off_by_name.get(cname.lower())
                if o is None:
                    ok = False
                    break
                offsets.append(o)
                fts.append(reader.schema.cols[o].ft)
            if not ok:
                continue
            path = rg.detach_index_conditions(conj, offsets, fts)
            if path.useful and path.ranges:
                indexed = idx_cover_base | {cn.lower() for cn in idx.columns}
                covering = all(c.name.lower() in indexed for c in cop.cols)
                # _ci index columns store casefolded keys, not original
                # values: such indexes can route but never cover
                if covering and any(
                        info.col_by_name(cn).ft.is_ci
                        for cn in idx.columns):
                    covering = False
                candidates.append((idx, path, covering))
        if not candidates:
            return reader
        if use_cbo:
            # cost = rows read x per-row factor; full scan reads count rows
            scan_cost = float(max(1, st.count))
            best = None
            for idx, path, cov in candidates:
                rows = st.index_ranges_row_count(idx, path.ranges)
                factor = self._COVER_FACTOR if cov else self._LOOKUP_FACTOR
                cost = rows * factor
                if best is None or cost < best[3]:
                    best = (idx, path, cov, cost)
            if best[3] >= scan_cost and not forced:
                return reader            # table scan wins
            idx, path, covering, _cost = best
        else:
            idx, path, covering = max(candidates, key=lambda c: c[1].score)
        # unique full point -> PointGet
        if idx.unique and path.eq_count == len(idx.columns) and \
                len(path.ranges) == 1 and not path.has_interval:
            r = path.ranges[0]
            if r.low == r.high and all(v is not None for v in r.low):
                return self._point_get(reader, None, idx, list(r.low))
        kv_ranges = rg.index_ranges_to_kv(info.id, idx.id, path.ranges)
        # covering index: every output column is an index column -> decode
        # straight from index entries, skip the row fetch entirely
        if covering:
            cov = ph.CopPlan(
                table=info, cols=cop.cols, handle_col=cop.handle_col,
                ranges=kv_ranges, index=idx, filter=cop.filter,
                host_filter=cop.host_filter)
            out = ph.PhysIndexReader(schema=reader.schema, cop=cov)
            out.est_rows = reader.est_rows
            return out
        index_cols = [info.col_by_name(c) for c in idx.columns]
        index_cop = ph.CopPlan(
            table=info, cols=index_cols, handle_col=len(index_cols),
            ranges=kv_ranges, index=idx)
        out = ph.PhysIndexLookUp(schema=reader.schema, index_cop=index_cop,
                                 table_cop=cop)
        out.est_rows = reader.est_rows
        return out

    # -- physical algorithm selection ----------------------------------------
    # (ref: plan/gen_physical_plans.go:114-417 join enumeration +
    # plan/task.go:116-499 costing — collapsed to targeted rewrites costed
    # with the same stats the access-path pass uses)

    # beyond this many estimated groups, the sort-based StreamAgg beats
    # the hash kernel's capacity-escalation / collision-fallback protocol
    _STREAM_AGG_NDV = 1 << 16

    # -- join reordering (ref: plan/join_reorder.go greedy solver over
    # estimated cardinalities; runs after access-path optimization so
    # leaf est_rows reflect pushed filters) ----------------------------------

    def _reorder_joins(self, plan: ph.PhysPlan) -> ph.PhysPlan:
        """Greedy reorder of MAXIMAL inner-join trees: seed with the
        smallest leaf that participates in a join condition, repeatedly
        attach the smallest connected leaf (cross joins last). The
        rebuilt tree is left-deep with the smaller input of every join
        as the hash build side, and a column projection restores the
        original output order so nothing downstream notices."""
        if not (isinstance(plan, ph.PhysHashJoin) and
                plan.join_type == "inner"):
            for i, c in enumerate(plan.children):
                plan.children[i] = self._reorder_joins(c)
            if isinstance(plan, ph.PhysApply) and plan.inner is not None:
                plan.inner = self._reorder_joins(plan.inner)
            return plan
        leaves, conds = self._collect_inner_tree(plan)
        new_leaves = [self._reorder_joins(lf) for lf in leaves]
        geo = _JoinGeometry(new_leaves, conds)
        order = self._greedy_order(geo) if len(new_leaves) > 2 else None
        if (order is None or order == list(range(len(new_leaves)))) and \
                all(a is b for a, b in zip(new_leaves, leaves)):
            return plan
        return self._rebuild_join_tree(
            plan, geo, order or list(range(len(new_leaves))))

    def _collect_inner_tree(self, p: ph.PhysPlan):
        """-> (leaves, conds) with every condition expressed over the
        concatenated leaf schema in ORIGINAL leaf order. Compound
        other_conds split into conjuncts so each applies (and can become
        a join key) at the earliest join covering its leaves."""
        if isinstance(p, ph.PhysHashJoin) and p.join_type == "inner":
            lleaves, lconds = self._collect_inner_tree(p.children[0])
            rleaves, rconds = self._collect_inner_tree(p.children[1])
            lw = sum(len(x.schema) for x in lleaves)
            conds = list(lconds)
            for c in rconds:
                conds.append(c.map_columns(
                    {i: i + lw for i in c.columns_used()}))
            for lk, rk in zip(p.left_keys, p.right_keys):
                rk2 = rk.map_columns(
                    {i: i + lw for i in rk.columns_used()})
                conds.append(func(Op.EQ, lk, rk2))
            conds.extend(flatten_and(p.other_cond))
            return lleaves + rleaves, conds
        return [p], []

    def _greedy_order(self, geo: "_JoinGeometry") -> list[int] | None:
        n = len(geo.leaves)
        # seed must participate in a join condition — seeding with a
        # disconnected (cross-joined) leaf would multiply every later
        # join by its cardinality
        in_conds = set().union(*geo.cond_leaves) if geo.cond_leaves \
            else set()
        if not in_conds:
            return None             # pure cross product: keep as written
        placed = [min(in_conds, key=lambda i: geo.size[i])]
        remaining = set(range(n)) - set(placed)
        while remaining:
            connected = [i for i in remaining
                         if any(i in cl and cl - {i} <= set(placed)
                                for cl in geo.cond_leaves)]
            pool = connected or sorted(remaining)
            nxt = min(pool, key=lambda i: geo.size[i])
            placed.append(nxt)
            remaining.discard(nxt)
        return placed

    def _rebuild_join_tree(self, orig: ph.PhysHashJoin,
                           geo: "_JoinGeometry",
                           order: list[int]) -> ph.PhysPlan:
        leaves, offs = geo.leaves, geo.offs
        n = len(leaves)
        width = sum(len(lf.schema) for lf in leaves)
        pending = list(zip(geo.conds, geo.cond_leaves))
        # cur_pos: original global index -> index in acc's CURRENT schema
        # (child orientation varies per join, so positions are tracked
        # dynamically rather than precomputed)
        first = order[0]
        acc = leaves[first]
        acc_set = {first}
        acc_est = geo.size[first]
        cur_pos = {offs[first] + k: k
                   for k in range(len(leaves[first].schema))}
        for pos in range(1, n):
            li = order[pos]
            leaf = leaves[li]
            leaf_w = len(leaf.schema)
            leaf_est = geo.size[li]
            # the smaller input becomes the hash BUILD side (right);
            # the bigger streams as the probe (left)
            leaf_right = acc_est >= leaf_est
            acc_w = len(acc.schema)
            if leaf_right:
                children = [acc, leaf]
                schema = acc.schema.merge(leaf.schema)
                leaf_base, nw = acc_w, acc_w
            else:
                children = [leaf, acc]
                schema = leaf.schema.merge(acc.schema)
                cur_pos = {g: p + leaf_w for g, p in cur_pos.items()}
                leaf_base, nw = 0, leaf_w
            for k in range(leaf_w):
                cur_pos[offs[li] + k] = leaf_base + k
            join = ph.PhysHashJoin(schema=schema, children=children,
                                   join_type="inner")
            here = acc_set | {li}
            rest = []
            for c, cl in pending:
                if not (cl <= here and (li in cl or pos == n - 1)):
                    rest.append((c, cl))
                    continue
                c2 = c.map_columns({i: cur_pos[i]
                                    for i in c.columns_used()})
                if isinstance(c2, ScalarFunc) and c2.op == Op.EQ:
                    a, b = c2.args
                    ua, ub = a.columns_used(), b.columns_used()
                    if ua and ub and all(i < nw for i in ua) and \
                            all(i >= nw for i in ub):
                        join.left_keys.append(a)
                        join.right_keys.append(b.map_columns(
                            {i: i - nw for i in ub}))
                        continue
                    if ua and ub and all(i < nw for i in ub) and \
                            all(i >= nw for i in ua):
                        join.left_keys.append(b)
                        join.right_keys.append(a.map_columns(
                            {i: i - nw for i in ua}))
                        continue
                join.other_cond = c2 if join.other_cond is None else \
                    func(Op.AND, join.other_cond, c2)
            pending = rest
            acc = join
            acc_set = here
            # FK-join heuristic: the fact side dominates the intermediate
            acc_est = max(acc_est, leaf_est)
            join.est_rows = acc_est if acc_est < _JoinGeometry.BIG \
                else None
        # restore the original column order for everything above
        exprs = [ColumnRef(cur_pos[i], orig.schema.cols[i].ft,
                           name=orig.schema.cols[i].name)
                 for i in range(width)]
        out = ph.PhysProjection(schema=orig.schema, children=[acc],
                                exprs=exprs)
        out.est_rows = getattr(orig, "est_rows", None)
        return out

    def _opt_physical(self, plan: ph.PhysPlan) -> ph.PhysPlan:
        """Post-pass choosing among physically-equivalent operators:
        HashJoin vs MergeJoin vs IndexJoin, HashAgg vs StreamAgg."""
        for i, c in enumerate(plan.children):
            plan.children[i] = self._opt_physical(c)
        if isinstance(plan, ph.PhysApply) and plan.inner is not None:
            plan.inner = self._opt_physical(plan.inner)
        if isinstance(plan, ph.PhysHashJoin):
            return self._choose_join_algorithm(plan)
        if isinstance(plan, ph.PhysHashAgg):
            return self._choose_agg_algorithm(plan)
        if isinstance(plan, ph.PhysFinalAgg):
            return self._choose_final_agg(plan)
        return plan

    def _choose_join_algorithm(self, join: ph.PhysHashJoin) -> ph.PhysPlan:
        """Cost the physically-equivalent algorithms and keep the cheapest:

          index join: outer_rows x lookup factor (reads ONLY matching
                      inner rows, point fetches pay the double-read tax)
          merge join: outer_scan + inner_scan (both streams, no build)
          hash join:  outer_scan + inner_scan + inner build

        Rows come from the access pass's stats estimates; with pseudo
        stats only the stats-free merge-vs-hash preference applies."""
        self._attach_probe_cms(join)
        if len(join.left_keys) != 1 or join.join_type not in (
                "inner", "left"):
            return join
        left, right = join.children
        outer_est = getattr(left, "est_rows", None)
        inner_count = None
        if isinstance(right, ph.PhysTableReader):
            st = self._tbl_stats(right.cop.table)
            if not st.pseudo:
                inner_count = float(st.count)

        merge_ok = (self._pk_ordered_reader(left, join.left_keys[0]) and
                    self._pk_ordered_reader(right, join.right_keys[0]))
        inner_idx = self._index_join_path(right, join.right_keys[0])
        index_ok = (inner_idx is not False and outer_est is not None and
                    inner_count is not None)

        if index_ok:
            index_cost = outer_est * self._LOOKUP_FACTOR
            scan_cost = (outer_est or 0) + inner_count
            if index_cost < scan_cost:
                return ph.PhysIndexJoin(
                    schema=join.schema, children=[left, right],
                    left_keys=join.left_keys, right_keys=join.right_keys,
                    inner_index=inner_idx, join_type=join.join_type,
                    other_cond=join.other_cond)
        if merge_ok:
            # same scan volume as hash, minus the build materialization
            left.keep_order = True
            right.keep_order = True
            return ph.PhysMergeJoin(
                schema=join.schema, children=join.children,
                left_keys=join.left_keys, right_keys=join.right_keys,
                join_type=join.join_type, other_cond=join.other_cond)
        return join

    def _attach_probe_cms(self, join: ph.PhysHashJoin) -> None:
        """Hand the executor the probe-side key column's ANALYZE-time
        CMSketch (when the single probe key traces to a base column):
        the hybrid hash join seeds its heavy-hitter lane from it, so a
        known-skewed key routes to the broadcast lane from the very
        first probe batch instead of after streaming detection."""
        if len(join.left_keys) != 1 or \
                not isinstance(join.left_keys[0], ColumnRef):
            return
        cs = self._trace_col_stats(join.children[0],
                                   join.left_keys[0].idx)
        if cs is not None and cs.cms is not None:
            join.probe_cms = cs.cms

    @staticmethod
    def _pk_ordered_reader(plan, key: Expression) -> bool:
        """Is `plan` a record scan whose rows arrive ordered by `key`
        (= the pk-is-handle column)?"""
        if not isinstance(plan, ph.PhysTableReader) or plan.cop.is_agg or \
                plan.cop.limit is not None or plan.cop.index is not None:
            return False
        if not isinstance(key, ColumnRef):
            return False
        info = plan.cop.table
        if not info.pk_is_handle or not info.pk_col_name:
            return False
        sc = plan.schema.cols[key.idx]
        return sc.name == info.pk_col_name.lower()

    @staticmethod
    def _index_join_path(plan, right_key: Expression):
        """Index (or None = pk handle) usable to point-fetch inner rows by
        the join key; False when the inner side is not lookup-able."""
        from tidb_tpu_torch.schema.model import SchemaState
        if not isinstance(plan, ph.PhysTableReader) or plan.cop.is_agg or \
                plan.cop.limit is not None or plan.cop.index is not None or \
                plan.cop.ranges is not None:
            return False
        if not isinstance(right_key, ColumnRef):
            return False
        info = plan.cop.table
        name = plan.schema.cols[right_key.idx].name
        if info.pk_is_handle and info.pk_col_name and \
                name == info.pk_col_name.lower():
            return None                      # pk-handle point lookups
        for idx in info.indexes:
            if idx.state == SchemaState.PUBLIC and \
                    idx.columns[0].lower() == name:
                return idx
        return False

    def _choose_agg_algorithm(self, agg: ph.PhysHashAgg) -> ph.PhysPlan:
        if not agg.group_exprs or any(a.distinct for a in agg.aggs):
            return agg
        ndv = self._group_ndv_estimate(agg.children[0], agg.group_exprs)
        if ndv is not None and ndv > self._STREAM_AGG_NDV:
            return ph.PhysStreamAgg(
                schema=agg.schema, children=agg.children,
                group_exprs=agg.group_exprs, aggs=agg.aggs,
                sorted_input=False)
        return agg

    def _choose_final_agg(self, fin: ph.PhysFinalAgg) -> ph.PhysPlan:
        """A pushed-down partial agg with very many groups overflows the
        storage-side hash kernel per chunk AND ships huge partial tables;
        beyond the NDV threshold, scan raw and segment-reduce at the root
        instead (StreamAgg has no capacity limit)."""
        reader = fin.children[0]
        if not isinstance(reader, ph.PhysTableReader) or \
                not reader.cop.is_agg:
            return fin
        cop = reader.cop
        if not cop.group_exprs or any(a.distinct for a in cop.aggs):
            return fin
        ndv = self._group_ndv_estimate(reader, cop.group_exprs)
        if ndv is None or ndv <= self._STREAM_AGG_NDV:
            return fin
        from dataclasses import replace as _replace
        raw = ph.PhysTableReader(
            schema=reader.schema,
            cop=_replace(cop, group_exprs=None, aggs=None))
        raw.est_rows = reader.est_rows
        return ph.PhysStreamAgg(schema=fin.schema, children=[raw],
                                group_exprs=list(cop.group_exprs),
                                aggs=list(cop.aggs), sorted_input=False)

    def _group_ndv_estimate(self, child: ph.PhysPlan, group_exprs):
        """Max per-column NDV of bare group columns, traced through the
        child tree to base-table statistics; None when untraceable or
        stats are pseudo (the decision then defaults to hash agg, whose
        runtime escalation still protects correctness)."""
        best = None
        for g in group_exprs:
            if not isinstance(g, ColumnRef):
                continue
            ndv = self._trace_col_ndv(child, g.idx)
            if ndv is not None:
                best = ndv if best is None else max(best, ndv)
        return best

    def _trace_col_ndv(self, plan: ph.PhysPlan, idx: int):
        cs = self._trace_col_stats(plan, idx)
        return cs.hist.ndv if cs is not None else None

    def _trace_col_stats(self, plan: ph.PhysPlan, idx: int):
        """ColumnStats of a bare column, traced through the child tree
        to base-table statistics; None when untraceable or pseudo."""
        if isinstance(plan, (ph.PhysSelection, ph.PhysLimit, ph.PhysSort,
                             ph.PhysTopN)):
            return self._trace_col_stats(plan.children[0], idx)
        if isinstance(plan, (ph.PhysHashJoin, ph.PhysMergeJoin,
                             ph.PhysIndexJoin)):
            nl = len(plan.children[0].schema)
            if idx < nl:
                return self._trace_col_stats(plan.children[0], idx)
            return self._trace_col_stats(plan.children[1], idx - nl)
        if isinstance(plan, ph.PhysProjection):
            e = plan.exprs[idx]
            if isinstance(e, ColumnRef):
                return self._trace_col_stats(plan.children[0], e.idx)
            return None
        if isinstance(plan, (ph.PhysTableReader, ph.PhysIndexReader)):
            sc = plan.schema.cols[idx]
            if not sc.col_id:
                return None
            stats = self._tbl_stats(plan.cop.table)
            if stats.pseudo:
                return None
            return stats.columns.get(sc.col_id)
        return None

    def _point_get(self, reader: ph.PhysTableReader, handle, idx, values
                   ) -> ph.PhysPointGet:
        cop = reader.cop
        filt = and_all([e for e in (cop.filter, cop.host_filter)
                        if e is not None])
        return ph.PhysPointGet(schema=reader.schema, table=cop.table,
                               cols=cop.cols, handle_col=cop.handle_col,
                               handle=handle, index=idx, index_values=values,
                               filter=filt)

    @staticmethod
    def _rejects_null(cond: Expression) -> bool:
        """True if the cond is false for NULL inputs (so pushing below an
        outer join's null-supplying side is sound). Conservative: plain
        comparisons reject NULL; IS NULL / IFNULL-style do not."""
        if isinstance(cond, ScalarFunc) and cond.op in (
                Op.EQ, Op.NE, Op.LT, Op.LE, Op.GT, Op.GE, Op.LIKE, Op.IN):
            return True
        return False

    # -- SELECT --------------------------------------------------------------

    def plan_select(self, stmt: ast.SelectStmt) -> ph.PhysPlan:
        if stmt.from_clause is None:
            return self._plan_select_no_from(stmt)
        plan = self.build_from(stmt.from_clause)
        # WHERE
        for c_ast in split_conjuncts(stmt.where):
            applied = self._try_subquery_conjunct(plan, c_ast)
            if applied is not None:
                plan = applied
                continue
            if _contains_scalar_subquery(c_ast):
                # subquery in a general expression position, e.g.
                # v > (SELECT ...) + 1: lift it to an applied column
                plan, c_ast = self._lift_scalars_in_expr(plan, c_ast)
                plan = ph.PhysSelection(
                    schema=plan.schema, children=[plan],
                    cond=Resolver(plan.schema).resolve(c_ast))
                continue
            plan = self._assign_cond(plan,
                                     Resolver(plan.schema).resolve(c_ast),
                                     where_phase=True)

        # scalar subqueries in select/having/order project as applied
        # columns before anything reads those expressions
        plan, stmt = self._lift_scalar_subqueries(plan, stmt)

        has_agg = bool(stmt.group_by) or _contains_agg(stmt)
        if has_agg:
            plan, out_schema, proj_exprs, proj_names, order_keys = \
                self._plan_agg_select(stmt, plan)
        else:
            proj_exprs, proj_names = self._resolve_fields(stmt, plan.schema)
            out_schema = PlanSchema([
                SchemaCol(n, "", e.ft) for n, e in
                zip(proj_names, proj_exprs)])
            order_keys = None
            if stmt.having is not None:
                # HAVING without aggregates acts as a filter; MySQL
                # resolves bare names against select aliases first
                # (ref: executor tests, aggregate HAVING family)
                def _subst(n):
                    if isinstance(n, ast.ColName) and not n.table and \
                            not self._column_shadows(plan.schema, n.name):
                        # FROM-clause-first: a real column shadows the
                        # alias (same rule as the agg HAVING path)
                        for f in stmt.fields:
                            if not isinstance(f.expr, ast.Star) and \
                                    f.alias and \
                                    f.alias.lower() == n.name.lower():
                                return f.expr
                    return n
                h_ast = self._rewrite_ast(stmt.having, _subst)
                plan = ph.PhysSelection(
                    schema=plan.schema, children=[plan],
                    cond=Resolver(plan.schema).resolve(h_ast))

        if stmt.distinct:
            # SQL order: projection -> DISTINCT -> ORDER BY -> LIMIT
            plan = ph.PhysProjection(schema=out_schema, children=[plan],
                                     exprs=proj_exprs)
            gexprs = [ColumnRef(i, c.ft) for i, c in
                      enumerate(out_schema.cols)]
            plan = ph.PhysHashAgg(schema=out_schema, children=[plan],
                                  group_exprs=gexprs, aggs=[])
            if stmt.order_by:
                by = []
                for bi in stmt.order_by:
                    target = self._maybe_alias_target(bi.expr, stmt)
                    if not isinstance(target, ast.ColName):
                        raise PlanError("ORDER BY with DISTINCT must name "
                                        "select-list columns")
                    oi = out_schema.find(target.name, target.table)
                    by.append((ColumnRef(oi, out_schema.cols[oi].ft),
                               bi.desc))
                plan = ph.PhysSort(schema=out_schema, children=[plan], by=by)
            if stmt.limit is not None:
                plan = ph.PhysLimit(schema=out_schema, children=[plan],
                                    count=stmt.limit, offset=stmt.offset)
            return plan

        # ORDER BY
        by = []
        if stmt.order_by:
            by = self._resolve_order(stmt, plan.schema, out_schema,
                                     proj_exprs, order_keys)
        # TopN pushdown / sort / limit assembly
        if by:
            if stmt.limit is not None:
                plan = ph.PhysTopN(schema=plan.schema, children=[plan],
                                   by=by, count=stmt.limit,
                                   offset=stmt.offset)
            else:
                plan = ph.PhysSort(schema=plan.schema, children=[plan],
                                   by=by)
        elif stmt.limit is not None:
            if isinstance(plan, ph.PhysTableReader) and not plan.cop.is_agg \
                    and stmt.offset == 0:
                plan.cop.limit = stmt.limit
            plan = ph.PhysLimit(schema=plan.schema, children=[plan],
                                count=stmt.limit, offset=stmt.offset)
        return ph.PhysProjection(schema=out_schema, children=[plan],
                                 exprs=proj_exprs)

    # -- UNION ---------------------------------------------------------------

    def _plan_query(self, stmt) -> ph.PhysPlan:
        """SELECT or UNION — every seam that accepts a query body."""
        return self.plan_union(stmt) if isinstance(stmt, ast.UnionStmt) \
            else self.plan_select(stmt)

    def plan_union(self, stmt: ast.UnionStmt) -> ph.PhysPlan:
        """UNION as a real operator tree (ref: builder.go UnionExec):
        branches stream through PhysUnion; MySQL's mixed ALL/DISTINCT
        rule applies — a DISTINCT union dedups everything to its left —
        via one HashAgg grouped on every output column."""
        sels = [self._plan_query(s) for s in stmt.selects]
        width = len(sels[0].schema)
        for s in sels[1:]:
            if len(s.schema) != width:
                raise PlanError(
                    "The used SELECT statements have a different number "
                    "of columns")
        out_cols = []
        for i in range(width):
            fts = [s.schema.cols[i].ft for s in sels]
            out_cols.append(SchemaCol(sels[0].schema.cols[i].name, "",
                                      _union_ft(fts)))
        out_schema = PlanSchema(out_cols)

        def union_of(children):
            return ph.PhysUnion(schema=out_schema, children=list(children))

        distinct_idx = [i for i, a in enumerate(stmt.alls) if not a]
        if distinct_idx:
            k = distinct_idx[-1] + 2     # branches covered by the dedup
            head = union_of(sels[:k])
            gexprs = [ColumnRef(i, c.ft) for i, c in enumerate(out_cols)]
            dedup = ph.PhysHashAgg(schema=out_schema, children=[head],
                                   group_exprs=gexprs, aggs=[])
            plan = union_of([dedup] + sels[k:]) if k < len(sels) else dedup
        else:
            plan = union_of(sels)

        if stmt.order_by:
            by = []
            for bi in stmt.order_by:
                target = bi.expr
                if isinstance(target, ast.Literal) and \
                        isinstance(target.value, int) and \
                        1 <= target.value <= width:
                    oi = target.value - 1
                elif isinstance(target, ast.ColName) and not target.table:
                    oi = out_schema.find(target.name.lower())
                else:
                    raise PlanError("UNION ORDER BY must name output "
                                    "columns")
                by.append((ColumnRef(oi, out_cols[oi].ft), bi.desc))
            if stmt.limit is not None:
                return ph.PhysTopN(schema=out_schema, children=[plan],
                                   by=by, count=stmt.limit,
                                   offset=stmt.offset)
            plan = ph.PhysSort(schema=out_schema, children=[plan], by=by)
        elif stmt.limit is not None:
            plan = ph.PhysLimit(schema=out_schema, children=[plan],
                                count=stmt.limit, offset=stmt.offset)
        return plan

    def _plan_select_no_from(self, stmt: ast.SelectStmt) -> ph.PhysPlan:
        plan = None
        if _contains_agg(stmt):
            # SELECT SUM(1.2e2) * 0.1 — aggregate over the one-row dual
            # (MySQL: no-FROM behaves as a single-row table); reuse the
            # regular agg path so expressions over aggregates work
            from tidb_tpu_torch.sqltypes import new_int_field
            ift = new_int_field()
            plan = ph.PhysValues(
                schema=PlanSchema([SchemaCol("__dual", "", ift)]),
                rows=[[Constant(1, ift)]])
            plan, stmt = self._lift_scalar_subqueries(plan, stmt)
            plan, out_schema, proj_exprs, _names, _ok = \
                self._plan_agg_select(stmt, plan)
            plan = ph.PhysProjection(schema=out_schema, children=[plan],
                                     exprs=proj_exprs)
            # the dual input yields at most one group, so ORDER BY and
            # DISTINCT are no-ops here — but LIMIT/OFFSET still apply
            # (SELECT COUNT(*) LIMIT 0 is empty)
            if stmt.limit is not None:
                plan = ph.PhysLimit(schema=out_schema, children=[plan],
                                    count=stmt.limit, offset=stmt.offset)
            return plan
        if any(_contains_scalar_subquery(f.expr) for f in stmt.fields
               if not isinstance(f.expr, ast.Star)):
            # subqueries over a one-row dual input: the lift appends
            # their values as apply columns as usual (a zero-column
            # chunk would report zero rows)
            from tidb_tpu_torch.sqltypes import new_int_field
            ift = new_int_field()
            plan = ph.PhysValues(
                schema=PlanSchema([SchemaCol("__dual", "", ift)]),
                rows=[[Constant(1, ift)]])
            plan, stmt = self._lift_scalar_subqueries(plan, stmt)
        r = Resolver(plan.schema if plan is not None else PlanSchema([]))
        exprs, names = [], []
        for f in stmt.fields:
            if isinstance(f.expr, ast.Star):
                raise PlanError("SELECT * requires FROM")
            e = r.resolve(f.expr)
            exprs.append(e)
            names.append(f.alias or _field_name(f.expr))
        schema = PlanSchema([SchemaCol(n, "", e.ft)
                             for n, e in zip(names, exprs)])
        if plan is not None:
            return ph.PhysProjection(schema=schema, children=[plan],
                                     exprs=exprs)
        return ph.PhysValues(schema=schema, rows=[exprs])

    # -- subquery conjuncts (ref: plan/expression_rewriter.go subquery
    # handling + decorrelateSolver; here: apply-style, uncorrelated inner
    # plans run once in the executor) -----------------------------------------

    _CMP_OPS = {"=": Op.EQ, "<": Op.LT, "<=": Op.LE, ">": Op.GT,
                ">=": Op.GE, "<>": Op.NE, "!=": Op.NE}

    def _try_subquery_conjunct(self, plan: ph.PhysPlan, c_ast
                               ) -> ph.PhysApply | None:
        """Recognize EXISTS / IN (SELECT) / <cmp> (SELECT) conjuncts and
        rewrite them to a PhysApply over `plan`. Returns None when the
        conjunct contains no subquery (normal resolution proceeds)."""
        negate = False
        node = c_ast
        while isinstance(node, ast.UnaryOp) and node.op == "NOT":
            negate = not negate
            node = node.operand

        if isinstance(node, ast.ExistsSubquery):
            anti = negate != node.negated
            dec = self._try_decorrelate(plan, node.select, anti,
                                        in_expr=None)
            if dec is not None:
                return dec
            inner, corr = self._plan_subquery(plan.schema, node.select)
            return ph.PhysApply(schema=plan.schema, children=[plan],
                                inner=inner, mode="exists",
                                negated=anti, corr=corr)

        if isinstance(node, ast.InExpr) and \
                isinstance(node.items, ast.SubqueryExpr):
            neg = negate != node.negated
            if not neg:
                # positive IN only: NOT IN has three-valued NULL
                # semantics an anti join would get wrong
                dec = self._try_decorrelate(plan, node.items.select,
                                            anti=False, in_expr=node.expr)
                if dec is not None:
                    return dec
            inner, corr = self._plan_subquery(plan.schema,
                                              node.items.select)
            if len(inner.schema.cols) != 1:
                raise PlanError("subquery must return 1 column for IN")
            left = Resolver(plan.schema).resolve(node.expr)
            return ph.PhysApply(schema=plan.schema, children=[plan],
                                inner=inner, mode="in",
                                negated=neg,
                                left=left, corr=corr)

        if isinstance(node, ast.QuantSubquery):
            # expr <cmp> ANY/ALL (SELECT ...): apply with quantifier
            # (ref: plan/expression_rewriter.go handleCompareSubquery)
            inner, corr = self._plan_subquery(plan.schema, node.select)
            if len(inner.schema.cols) != 1:
                raise PlanError("subquery must return 1 column")
            left = Resolver(plan.schema).resolve(node.expr)
            return ph.PhysApply(schema=plan.schema, children=[plan],
                                inner=inner, mode="cmp", negated=negate,
                                left=left, cmp_op=self._CMP_OPS[node.op],
                                quant=node.quant, corr=corr)

        if isinstance(node, ast.BinaryOp) and node.op in self._CMP_OPS:
            lhs_sub = isinstance(node.left, ast.SubqueryExpr)
            rhs_sub = isinstance(node.right, ast.SubqueryExpr)
            if lhs_sub == rhs_sub:          # neither (or both: unsupported)
                if lhs_sub:
                    raise PlanError("subquery on both comparison sides")
                return None
            sub = node.left if lhs_sub else node.right
            other = node.right if lhs_sub else node.left
            op = self._CMP_OPS[node.op]
            if lhs_sub:                     # flip: keep subquery on the right
                op = {Op.LT: Op.GT, Op.LE: Op.GE, Op.GT: Op.LT,
                      Op.GE: Op.LE}.get(op, op)
            inner, corr = self._plan_subquery(plan.schema, sub.select)
            if len(inner.schema.cols) != 1:
                raise PlanError("scalar subquery must return 1 column")
            left = Resolver(plan.schema).resolve(other)
            return ph.PhysApply(schema=plan.schema, children=[plan],
                                inner=inner, mode="cmp", negated=negate,
                                left=left, cmp_op=op, corr=corr)
        return None

    def _lift_scalars_in_expr(self, plan: ph.PhysPlan, e):
        """Replace every scalar (SELECT ...) inside `e` with a reference
        to a column appended by a PhysApply mode="scalar" wrapped around
        `plan` (ref: plan/expression_rewriter.go handleScalarSubquery).
        Returns the (possibly wrapped) plan and the rewritten AST."""
        import dataclasses
        holder = [plan]

        def lift(node):
            outer = holder[0]
            inner, corr = self._plan_subquery(outer.schema, node.select)
            if len(inner.schema.cols) != 1:
                raise PlanError("scalar subquery must return 1 column")
            name = f"__sq{len(outer.schema.cols)}"
            sc = SchemaCol(name, "", inner.schema.cols[0].ft)
            holder[0] = ph.PhysApply(
                schema=PlanSchema(outer.schema.cols + [sc]),
                children=[outer], inner=inner, mode="scalar", corr=corr)
            return ast.ColName(name=name)

        def walk(node):
            if isinstance(node, ast.SubqueryExpr):
                return lift(node)
            if isinstance(node, ast.InExpr) and \
                    isinstance(node.items, ast.SubqueryExpr):
                # IN's row set in expression position: desugar to a
                # three-valued scalar aggregate over a derived table,
                # then lift that (ref: expression_rewriter.go
                # handleInSubquery non-conjunct case)
                if self._contains_agg(node.expr):
                    # embedding SUM(b) in the generated subquery would
                    # read outer agg state that does not exist there
                    raise PlanError(
                        "aggregate as IN-subquery operand in expression "
                        "position is not supported")
                colref = lift(_in_as_scalar(walk(node.expr),
                                            node.items.select))
                return ast.UnaryOp("NOT", colref) if node.negated \
                    else colref
            if isinstance(node, ast.ExistsSubquery):
                # EXISTS in expression position -> COUNT(*) > 0 over a
                # LIMIT 1 inner: the executor stops at the first row
                inner_sel = node.select
                if getattr(inner_sel, "limit", None) is None:
                    inner_sel = dataclasses.replace(inner_sel, limit=1)
                cnt = ast.SubqueryExpr(select=ast.SelectStmt(
                    fields=[ast.SelectField(
                        expr=ast.AggregateCall(name="COUNT", star=True))],
                    from_clause=ast.SubqueryTable(
                        select=inner_sel, alias="__ex")))
                out = ast.BinaryOp(">", lift(cnt), ast.Literal(0))
                return ast.UnaryOp("NOT", out) if node.negated else out
            return self._rewrite_ast_shallow(node, walk)

        ne = walk(e)        # mutates holder: must run before the read
        return holder[0], ne

    def _rewrite_ast_shallow(self, e, walk):
        """One dataclass-rebuild level: recurse via `walk` (which owns
        the node-type decisions), no fn applied to `e` itself."""
        import dataclasses
        if dataclasses.is_dataclass(e) and isinstance(e, ast.ExprNode) \
                and not isinstance(e, (ast.SubqueryExpr,
                                       ast.ExistsSubquery,
                                       ast.QuantSubquery)):
            updates = {}
            for fld in dataclasses.fields(e):
                v = getattr(e, fld.name)
                if isinstance(v, ast.ExprNode):
                    nv = walk(v)
                    if nv is not v:
                        updates[fld.name] = nv
                elif isinstance(v, list):
                    nl = [self._walk_item(x, walk) for x in v]
                    if any(a is not b for a, b in zip(nl, v)):
                        updates[fld.name] = nl
            if updates:
                return dataclasses.replace(e, **updates)
        return e

    @staticmethod
    def _walk_item(x, walk):
        if isinstance(x, ast.ExprNode):
            return walk(x)
        if isinstance(x, tuple) and any(
                isinstance(y, ast.ExprNode) for y in x):
            nt = tuple(walk(y) if isinstance(y, ast.ExprNode) else y
                       for y in x)
            return x if all(a is b for a, b in zip(nt, x)) else nt
        return x

    def _lift_scalar_subqueries(self, plan: ph.PhysPlan,
                                stmt: ast.SelectStmt):
        import dataclasses
        exprs = [f.expr for f in stmt.fields]
        if stmt.having is not None:
            exprs.append(stmt.having)
        exprs.extend(b.expr for b in stmt.order_by or [])
        if not any(_contains_scalar_subquery(x) for x in exprs):
            return plan, stmt
        changed = {}
        fields = []
        for f in stmt.fields:
            plan, ne = self._lift_scalars_in_expr(plan, f.expr)
            if ne is not f.expr:
                # keep the pre-lift display name: clients must not see
                # the internal __sqN / desugared-node names
                f = dataclasses.replace(
                    f, expr=ne, alias=f.alias or _field_name(f.expr))
            fields.append(f)
        changed["fields"] = fields
        if stmt.having is not None:
            plan, nh = self._lift_scalars_in_expr(plan, stmt.having)
            changed["having"] = nh
        if stmt.order_by:
            order = []
            for b in stmt.order_by:
                plan, ne = self._lift_scalars_in_expr(plan, b.expr)
                order.append(dataclasses.replace(b, expr=ne)
                             if ne is not b.expr else b)
            changed["order_by"] = order
        return plan, dataclasses.replace(stmt, **changed)

    def _try_decorrelate(self, plan: ph.PhysPlan, sub_select,
                         anti: bool, in_expr) -> ph.PhysPlan | None:
        """Rewrite a correlated EXISTS / positive IN subquery into a
        (anti-)semi hash join (ref: decorrelateSolver, plan/optimizer.go:
        42-50): correlated equalities in the subquery WHERE become join
        keys, the remainder stays as the inner filter. Returns None when
        the shape doesn't qualify — the caller falls back to PhysApply.
        """
        if not isinstance(sub_select, ast.SelectStmt) or \
                sub_select.from_clause is None or sub_select.group_by or \
                sub_select.having is not None or \
                sub_select.limit is not None or _contains_agg(sub_select):
            # scalar aggregates change EXISTS/IN cardinality (one row
            # ALWAYS exists; IN compares against a per-group value): the
            # join rewrite cannot express them
            return None
        conjs = split_conjuncts(sub_select.where)
        if not any(isinstance(c, ast.BinaryOp) and c.op == "="
                   for c in conjs):
            return None   # no equality: nothing can become a join key
        # classify WHERE conjuncts: outer_expr = inner_expr pairs peel
        # off as join keys
        try:
            inner_from = Planner(self.ischema, self.db,
                                 stats_handle=self.stats).build_from(
                sub_select.from_clause)
        except (PlanError, ResolveError):
            return None
        corr_pairs: list[tuple] = []    # (outer ast, inner ast)
        residual: list = []

        def resolves(schema, e_ast) -> bool:
            try:
                Resolver(schema).resolve(e_ast)
                return True
            except (ResolveError, PlanError):
                return False

        for c in conjs:
            if isinstance(c, ast.BinaryOp) and c.op == "=":
                li = resolves(inner_from.schema, c.left)
                ri = resolves(inner_from.schema, c.right)
                lo = resolves(plan.schema, c.left)
                ro = resolves(plan.schema, c.right)
                if not li and lo and ri:
                    corr_pairs.append((c.left, c.right))
                    continue
                if not ri and ro and li:
                    corr_pairs.append((c.right, c.left))
                    continue
            residual.append(c)
        if not corr_pairs:
            return None

        # rebuilt subquery: the IN value column (the subquery's own select
        # item) plus the inner join-key columns become the select list;
        # the correlated equalities are gone
        fields = []
        if in_expr is not None:
            if len(sub_select.fields) != 1 or \
                    isinstance(sub_select.fields[0].expr, ast.Star):
                return None
            fields.append(sub_select.fields[0])
        for i, (_o, inner_ast) in enumerate(corr_pairs):
            fields.append(ast.SelectField(expr=inner_ast, alias=f"_k{i}"))
        where = None
        for c in residual:
            where = c if where is None else \
                ast.BinaryOp(op="AND", left=where, right=c)
        mod = ast.SelectStmt(fields=fields,
                             from_clause=sub_select.from_clause,
                             where=where)
        try:
            # no outer scope: any REMAINING correlation fails resolution
            # here and we fall back to the apply path
            inner_plan = Planner(self.ischema, self.db,
                                 stats_handle=self.stats).plan(mod)
        except (PlanError, ResolveError):
            return None
        r = Resolver(plan.schema)
        try:
            left_keys = ([r.resolve(in_expr)] if in_expr is not None
                         else [])
            left_keys += [r.resolve(o) for o, _i in corr_pairs]
        except (ResolveError, PlanError):
            return None
        right_keys = [ColumnRef(i, c.ft)
                      for i, c in enumerate(inner_plan.schema.cols)]
        if len(left_keys) != len(right_keys):
            return None
        return ph.PhysHashJoin(schema=plan.schema,
                               children=[plan, inner_plan],
                               left_keys=left_keys, right_keys=right_keys,
                               join_type="anti" if anti else "semi")

    def _plan_subquery(self, outer_schema: PlanSchema, sub_select):
        """Plan an inner SELECT with the outer schema visible for
        correlated column resolution."""
        from tidb_tpu_torch.plan.resolver import push_outer
        with push_outer(outer_schema) as scope:
            inner = Planner(self.ischema, self.db,
                            stats_handle=self.stats).plan(sub_select)
        corr = sorted(scope.cells.items())
        return inner, corr

    # -- fields / projection -------------------------------------------------

    def _expand_fields(self, stmt: ast.SelectStmt, schema: PlanSchema):
        """Expand * / t.* into per-column fields."""
        out = []
        for f in stmt.fields:
            if isinstance(f.expr, ast.Star):
                tbl = f.expr.table.lower()
                for i, c in enumerate(schema.cols):
                    if not c.table and c.name.startswith("__sq"):
                        continue   # lifted scalar-subquery helper column
                    if not tbl or c.table == tbl:
                        out.append((ast.ColName(name=c.name, table=c.table),
                                    c.name))
                if not out:
                    raise PlanError(f"unknown table '{tbl}' in {tbl}.*")
            else:
                out.append((f.expr, f.alias or _field_name(f.expr)))
        return out

    def _resolve_fields(self, stmt, schema: PlanSchema):
        r = Resolver(schema)
        exprs, names = [], []
        for e_ast, name in self._expand_fields(stmt, schema):
            exprs.append(r.resolve(e_ast))
            names.append(name)
        return exprs, names

    # -- aggregation ---------------------------------------------------------

    def _plan_agg_select(self, stmt: ast.SelectStmt, plan: ph.PhysPlan):
        in_schema = plan.schema
        base_r = Resolver(in_schema)
        # 1. group exprs over input schema
        group_asts = [bi.expr for bi in stmt.group_by]
        group_exprs = []
        group_targets = [self._maybe_alias_target(ga, stmt, in_schema)
                         for ga in group_asts]   # GROUP BY alias/position
        group_exprs = [base_r.resolve(ga2) for ga2 in group_targets]
        group_ast_reprs = [repr(ga2) for ga2 in group_targets]

        aggs: list[AggDesc] = []
        num_g = len(group_exprs)

        def agg_schema():
            cols = []
            for i, (ge, gr) in enumerate(zip(group_exprs, group_asts)):
                nm = gr.name.lower() if isinstance(gr, ast.ColName) else \
                    f"_g{i}"
                tb = gr.table.lower() if isinstance(gr, ast.ColName) else ""
                cols.append(SchemaCol(nm, tb, ge.ft))
            for j, a in enumerate(aggs):
                cols.append(SchemaCol(f"_a{j}", "", a.result_ft))
            return PlanSchema(cols)

        resolver = _AggResolver(in_schema, aggs, num_g, group_ast_reprs,
                                group_exprs)
        # 2. select fields over (group cols + aggs)
        proj_exprs, proj_names = [], []
        for e_ast, name in self._expand_fields(stmt, in_schema):
            proj_exprs.append(resolver.resolve_over_agg(e_ast))
            proj_names.append(name)
        # 3. having
        having_expr = None
        if stmt.having is not None:
            having_expr = resolver.resolve_over_agg(
                self._substitute_aliases(stmt.having, stmt,
                                         resolver.in_schema))
        # 4. order by may reference aggs too — resolve now, carry through
        order_keys = []
        if stmt.order_by:
            for bi in stmt.order_by:
                target = self._maybe_alias_target(bi.expr, stmt)
                try:
                    order_keys.append(
                        (resolver.resolve_over_agg(target), bi.desc))
                except ResolveError:
                    order_keys.append(None)  # resolved later vs aliases

        # decide pushdown: single bare reader + no distinct aggs
        reader_ok = isinstance(plan, ph.PhysTableReader) and \
            not plan.cop.is_agg and plan.cop.limit is None
        no_distinct = all(not a.distinct for a in aggs)
        if reader_ok and no_distinct:
            plan.cop.group_exprs = group_exprs
            plan.cop.aggs = aggs
            agg_plan = ph.PhysFinalAgg(schema=agg_schema(), children=[plan],
                                       aggs=aggs, num_group_cols=num_g)
        else:
            agg_plan = ph.PhysHashAgg(schema=agg_schema(), children=[plan],
                                      group_exprs=group_exprs, aggs=aggs)
        out = agg_plan
        if having_expr is not None:
            out = ph.PhysSelection(schema=agg_plan.schema, children=[out],
                                   cond=having_expr)
        out_schema = PlanSchema([SchemaCol(n, "", e.ft)
                                 for n, e in zip(proj_names, proj_exprs)])
        return out, out_schema, proj_exprs, proj_names, order_keys

    def _substitute_aliases(self, e, stmt: ast.SelectStmt,
                            schema: PlanSchema | None = None,
                            in_agg: bool = False):
        """Replace select-list aliases ANYWHERE inside an expression
        (HAVING may combine aliases with other predicates, e.g.
        HAVING s > 40 AND g < 5 — MySQL resolves those against the
        select list). A real FROM-clause column of the same name wins
        over the alias (MySQL's HAVING resolution order); an alias
        whose expression holds an aggregate may not land inside
        another aggregate (ER_INVALID_GROUP_FUNC_USE)."""
        import dataclasses
        if isinstance(e, ast.ColName) and not e.table:
            if self._column_shadows(schema, e.name):
                return e
            for f in stmt.fields:
                if f.alias and f.alias.lower() == e.name.lower():
                    if in_agg and self._contains_agg(f.expr):
                        raise ResolveError(
                            "Invalid use of group function")
                    return f.expr
            return e
        if dataclasses.is_dataclass(e) and isinstance(e, ast.ExprNode) \
                and not isinstance(e, (ast.SubqueryExpr,
                                       ast.ExistsSubquery)):
            inner_agg = in_agg or isinstance(e, ast.AggregateCall)
            updates = {}
            for fld in dataclasses.fields(e):
                v = getattr(e, fld.name)
                if isinstance(v, ast.ExprNode):
                    nv = self._substitute_aliases(v, stmt, schema,
                                                  inner_agg)
                    if nv is not v:
                        updates[fld.name] = nv
                elif isinstance(v, list):
                    nl = [self._substitute_aliases(x, stmt, schema,
                                                   inner_agg)
                          if isinstance(x, ast.ExprNode) else x
                          for x in v]
                    if any(a is not b for a, b in zip(nl, v)):
                        updates[fld.name] = nl
            if updates:
                return dataclasses.replace(e, **updates)
        return e

    def _contains_agg(self, e) -> bool:
        import dataclasses
        if isinstance(e, ast.AggregateCall):
            return True
        if dataclasses.is_dataclass(e) and isinstance(e, ast.ExprNode):
            for fld in dataclasses.fields(e):
                v = getattr(e, fld.name)
                if isinstance(v, ast.ExprNode) and self._contains_agg(v):
                    return True
                if isinstance(v, list) and any(
                        isinstance(x, ast.ExprNode) and
                        self._contains_agg(x) for x in v):
                    return True
        return False

    def _maybe_alias_target(self, e: ast.ExprNode, stmt: ast.SelectStmt,
                            schema: PlanSchema | None = None):
        """GROUP BY / ORDER BY may name a select alias or 1-based
        position. Pass `schema` for GROUP BY: MySQL resolves GROUP
        BY/HAVING names FROM-clause-first (a real column shadows the
        alias), but ORDER BY select-list-first."""
        if isinstance(e, ast.Literal) and isinstance(e.value, int) and \
                1 <= e.value <= len(stmt.fields):
            f = stmt.fields[e.value - 1]
            if not isinstance(f.expr, ast.Star):
                return f.expr
        if isinstance(e, ast.ColName) and not e.table:
            if self._column_shadows(schema, e.name):
                return e
            for f in stmt.fields:
                if f.alias and f.alias.lower() == e.name.lower():
                    return f.expr
        return e

    def _rewrite_ast(self, e, fn):
        """Bottom-up AST rebuild: children first, then fn(node) may
        return a replacement. Subquery boundaries are not crossed."""
        import dataclasses
        if dataclasses.is_dataclass(e) and isinstance(e, ast.ExprNode) \
                and not isinstance(e, (ast.SubqueryExpr,
                                       ast.ExistsSubquery)):
            updates = {}
            for fld in dataclasses.fields(e):
                v = getattr(e, fld.name)
                if isinstance(v, ast.ExprNode):
                    nv = self._rewrite_ast(v, fn)
                    if nv is not v:
                        updates[fld.name] = nv
                elif isinstance(v, list):
                    nl = [self._rewrite_ast_item(x, fn) for x in v]
                    if any(a is not b for a, b in zip(nl, v)):
                        updates[fld.name] = nl
            if updates:
                e = dataclasses.replace(e, **updates)
        return fn(e)

    def _rewrite_ast_item(self, x, fn):
        """List element: an expr, or a tuple holding exprs (CASE's
        when_clauses are (cond, result) pairs)."""
        if isinstance(x, ast.ExprNode):
            return self._rewrite_ast(x, fn)
        if isinstance(x, tuple) and any(
                isinstance(y, ast.ExprNode) for y in x):
            nt = tuple(self._rewrite_ast(y, fn)
                       if isinstance(y, ast.ExprNode) else y for y in x)
            return x if all(a is b for a, b in zip(nt, x)) else nt
        return x

    def _rewrite_values_fn(self, e, info):
        """ON DUPLICATE KEY UPDATE ... VALUES(col) -> the candidate
        row's value (ref: executor/write.go onDuplicateUpdate;
        expression/builtin_other.go valuesFunctionClass)."""
        tname = info.name.lower()
        def fn(node):
            if isinstance(node, ast.FuncCall) and \
                    node.name.upper() == "VALUES":
                if len(node.args) != 1 or \
                        not isinstance(node.args[0], ast.ColName):
                    raise PlanError("VALUES() takes a single column name")
                c = node.args[0]
                if (c.table and c.table.lower() != tname) or \
                        info.col_by_name(c.name) is None:
                    raise PlanError(f"Unknown column '{c.name}'")
                return ast.ColName(name="__values__" + c.name.lower())
            return node
        return self._rewrite_ast(e, fn)

    def _fold_default(self, e, info, target: str | None = None):
        """DEFAULT(col) / bare DEFAULT in a SET assignment -> the
        column's default value as a literal. A NOT NULL column without
        a default has no value to give (MySQL error 1364)."""
        def fn(node):
            cname = None
            if isinstance(node, ast.FuncCall) and \
                    node.name.upper() == "DEFAULT":
                if len(node.args) != 1 or \
                        not isinstance(node.args[0], ast.ColName):
                    raise PlanError("DEFAULT() takes a single column name")
                cname = node.args[0].name
            elif isinstance(node, ast.DefaultExpr):
                if target is None:
                    raise PlanError("DEFAULT not valid here")
                cname = target
            if cname is None:
                return node
            ci = info.col_by_name(cname)
            if ci is None:
                raise PlanError(f"Unknown column '{cname}'")
            if not ci.has_default and ci.ft.not_null:
                raise PlanError(
                    f"Field '{ci.name}' doesn't have a default value")
            return ast.Literal(ci.default if ci.has_default else None)
        return self._rewrite_ast(e, fn)

    @staticmethod
    def _column_shadows(schema: PlanSchema | None, name: str) -> bool:
        """MySQL GROUP BY/HAVING resolution order: a FROM-clause column
        of the same name wins over a select-list alias (ORDER BY is the
        opposite — callers there pass schema=None). Ambiguity among the
        FROM columns stays a hard error."""
        if schema is None:
            return False
        try:
            schema.find(name, "")
            return True
        except ColumnAmbiguousError:
            raise
        except ResolveError:
            return False

    def _resolve_order(self, stmt, in_schema: PlanSchema,
                       out_schema: PlanSchema, proj_exprs, order_keys):
        """Order keys run BELOW the projection, over in_schema."""
        by = []
        for i, bi in enumerate(stmt.order_by):
            if order_keys is not None and order_keys[i] is not None:
                by.append((order_keys[i][0], order_keys[i][1]))
                continue
            target = self._maybe_alias_target(bi.expr, stmt)
            if isinstance(target, ast.Literal) and \
                    isinstance(target.value, int) and \
                    1 <= target.value <= len(proj_exprs):
                # ORDER BY <position> over a SELECT * projection (the
                # alias map can't expand a Star field)
                by.append((proj_exprs[target.value - 1], bi.desc))
                continue
            # alias/output name -> reuse the projection expression
            try:
                oi = out_schema.find(
                    target.name if isinstance(target, ast.ColName) else "",
                    target.table if isinstance(target, ast.ColName) else "")
                by.append((proj_exprs[oi], bi.desc))
                continue
            except (ResolveError, AttributeError):
                pass
            by.append((Resolver(in_schema).resolve(target), bi.desc))
        return by

    # -- DML -----------------------------------------------------------------

    def plan_insert(self, stmt: ast.InsertStmt) -> ph.PhysInsert:
        _db, info = self._table_info(stmt.table)
        cols = stmt.columns or [c.name for c in info.public_columns()]
        for c in cols:
            if info.col_by_name(c) is None:
                raise PlanError(f"Unknown column '{c}'")
        if stmt.select is not None:
            source = self._plan_query(stmt.select)
            if len(source.schema) != len(cols):
                raise PlanError("Column count doesn't match value count")
        else:
            r = Resolver(PlanSchema([]))
            rows = []
            for vr in stmt.values:
                if len(vr) == 0 and not stmt.columns:
                    # INSERT t VALUES (): every column takes its default.
                    # Only legal without an explicit column list (MySQL
                    # 1136 otherwise — the count check below raises)
                    vr = [ast.DefaultExpr() for _ in cols]
                if len(vr) != len(cols):
                    raise PlanError("Column count doesn't match value count")
                rows.append([None if isinstance(v, ast.DefaultExpr)
                             else r.resolve(self._fold_default(v, info))
                             for v in vr])
            source = ph.PhysValues(rows=rows)
        dup = []
        if stmt.on_duplicate:
            # assignments may reference existing row columns; VALUES(c)
            # refers to the would-be inserted value and resolves against
            # a second column set appended after the existing row (the
            # executor evaluates over an [old | candidate] chunk) under
            # reserved __values__-prefixed names so bare refs stay
            # unambiguous
            pub = info.public_columns()
            schema = PlanSchema(
                [SchemaCol(c.name.lower(), info.name.lower(), c.ft, c.id)
                 for c in pub] +
                [SchemaCol("__values__" + c.name.lower(), "", c.ft, c.id)
                 for c in pub])
            r2 = Resolver(schema)
            for a in stmt.on_duplicate:
                if info.col_by_name(a.col.name) is None:
                    raise PlanError(f"Unknown column '{a.col.name}'")
                e2 = self._rewrite_values_fn(
                    self._fold_default(a.expr, info, a.col.name), info)
                dup.append((a.col.name.lower(), r2.resolve(e2)))
        return ph.PhysInsert(table=info, columns=[c.lower() for c in cols],
                             source=source, on_duplicate=dup,
                             is_replace=stmt.is_replace, ignore=stmt.ignore)

    def _plan_writable_reader(self, ts: ast.TableSource,
                              where: ast.ExprNode | None):
        """Reader emitting all public columns + trailing _handle col."""
        _db, info = self._table_info(ts)
        cols = info.public_columns()
        schema = PlanSchema(
            [SchemaCol(c.name.lower(), ts.ref_name.lower(), c.ft, c.id)
             for c in cols] +
            [SchemaCol("_handle", ts.ref_name.lower(), st.new_int_field())])
        cop = ph.CopPlan(table=info, cols=list(cols),
                         handle_col=len(cols))
        plan = ph.PhysTableReader(schema=schema, cop=cop)
        if where is not None:
            r = Resolver(schema)
            for c_ast in split_conjuncts(where):
                # EXISTS / IN / <cmp> (SELECT) filter applies preserve
                # the reader schema exactly (cols + _handle), so DML
                # WHERE supports them like SELECT does; scalar LIFTS
                # would append columns and stay unsupported here
                if _reads_table(c_ast, _db, info.name, self.db or ""):
                    # Halloween guard, like MySQL error 1093: the
                    # subquery must not read the table being written
                    raise PlanError(
                        f"You can't specify target table "
                        f"'{info.name}' for update in FROM clause")
                applied = self._try_subquery_conjunct(plan, c_ast)
                if applied is not None:
                    plan = applied
                    continue
                plan = self._assign_cond(plan, r.resolve(c_ast), True)
        return info, plan

    def _order_limit_reader(self, reader, order_by, limit):
        """UPDATE/DELETE ... [ORDER BY ...] [LIMIT n]: restrict the
        writable reader to the ordered first-n rows (MySQL semantics —
        ignoring these silently would write/delete EVERY match)."""
        if not order_by and limit is None:
            return reader
        if order_by:
            r = Resolver(reader.schema)
            by = [(r.resolve(item.expr), item.desc) for item in order_by]
            reader = ph.PhysSort(schema=reader.schema, children=[reader],
                                 by=by)
        if limit is not None:
            reader = ph.PhysLimit(schema=reader.schema, children=[reader],
                                  count=limit)
        return reader

    def plan_update(self, stmt: ast.UpdateStmt) -> ph.PhysPlan:
        if not isinstance(stmt.table, ast.TableSource):
            return self.plan_multi_update(stmt)
        info, reader = self._plan_writable_reader(stmt.table, stmt.where)
        reader = self._order_limit_reader(reader, stmt.order_by,
                                          stmt.limit)
        assigns = []
        r = Resolver(reader.schema)
        for a in stmt.assignments:
            if info.col_by_name(a.col.name) is None:
                raise PlanError(f"Unknown column '{a.col.name}'")
            assigns.append((a.col.name.lower(), r.resolve(
                self._fold_default(a.expr, info, a.col.name))))
        return ph.PhysUpdate(table=info, reader=reader, assignments=assigns)

    def plan_multi_update(self, stmt: ast.UpdateStmt) -> ph.PhysPlan:
        """UPDATE t1, t2 SET ... / UPDATE <join> SET ... (ref:
        executor/write.go:479 multi-table UpdateExec): targets are the
        tables whose columns are assigned; their readers carry row
        handles through the join; assignments may read any table."""
        if stmt.order_by or stmt.limit is not None:
            raise PlanError(
                "multi-table UPDATE does not allow ORDER BY/LIMIT")
        sources: dict[str, ast.TableSource] = {}

        def walk(node):
            if isinstance(node, ast.TableSource):
                sources[node.ref_name.lower()] = node
            elif isinstance(node, ast.Join):
                walk(node.left)
                walk(node.right)
            elif node is not None:
                raise PlanError(
                    "multi-table UPDATE supports plain table joins")
        walk(stmt.table)

        def target_of(col: ast.ColName) -> str:
            if col.table:
                key = col.table.lower()
                if key in sources and (not col.db or (
                        sources[key].db or self.db).lower()
                        == col.db.lower()):
                    return key
                for k, ts in sources.items():   # db-qualified, aliased
                    if ts.name.lower() == col.table.lower() and \
                            (not col.db or (ts.db or self.db).lower()
                             == col.db.lower()):
                        return k
                raise PlanError(f"Unknown table '{col.table}' in UPDATE")
            cands = [k for k, ts in sources.items()
                     if self._table_info(ts)[1].col_by_name(col.name)]
            if len(cands) > 1:
                raise PlanError(f"Column '{col.name}' is ambiguous")
            if not cands:
                raise PlanError(f"Unknown column '{col.name}'")
            return cands[0]

        per_ref: dict[str, list] = {}
        for a in stmt.assignments:
            per_ref.setdefault(target_of(a.col), []).append(a)

        self._handle_refs = set(per_ref)
        try:
            plan = self.build_from(stmt.table)
            if stmt.where is not None:
                r = Resolver(plan.schema)
                for c_ast in split_conjuncts(stmt.where):
                    plan = self._assign_cond(plan, r.resolve(c_ast), True)
        finally:
            self._handle_refs = set()

        r = Resolver(plan.schema)
        targets = []
        for key, assigns_ast in per_ref.items():
            _db, info = self._table_info(sources[key])
            handle_idx = col_start = None
            for i, sc in enumerate(plan.schema.cols):
                if sc.table != key:
                    continue
                if col_start is None:
                    col_start = i
                if sc.name == "_handle":
                    handle_idx = i
            if handle_idx is None:
                raise PlanError(f"no handle for target '{key}'")
            assigns = []
            for a in assigns_ast:
                if info.col_by_name(a.col.name) is None:
                    raise PlanError(f"Unknown column '{a.col.name}'")
                assigns.append((a.col.name.lower(), r.resolve(
                    self._fold_default(a.expr, info, a.col.name))))
            targets.append((info, col_start, handle_idx, assigns))
        return ph.PhysMultiUpdate(targets=targets, reader=plan)

    def plan_delete(self, stmt: ast.DeleteStmt):
        if stmt.targets:
            return self.plan_multi_delete(stmt)
        info, reader = self._plan_writable_reader(stmt.table, stmt.where)
        reader = self._order_limit_reader(reader, stmt.order_by,
                                          stmt.limit)
        return ph.PhysDelete(table=info, reader=reader)

    def plan_multi_delete(self, stmt: ast.DeleteStmt) -> ph.PhysMultiDelete:
        """DELETE t1, t2 FROM <join> ... (ref: executor/write.go
        deleteMultiTables + ast/dml.go IsMultiTable): target tables'
        readers carry their row handle through the join; each matched
        row deletes from every target (deduped per handle)."""
        # collect the referenced table sources by ref name
        sources: dict[str, ast.TableSource] = {}

        def walk(node):
            if isinstance(node, ast.TableSource):
                sources[node.ref_name.lower()] = node
            elif isinstance(node, ast.Join):
                walk(node.left)
                walk(node.right)
            elif node is not None:
                raise PlanError(
                    "multi-table DELETE supports plain table joins")
        walk(stmt.refs)

        want: list[tuple[str, ast.TableSource]] = []
        for tgt in stmt.targets:
            key = tgt.ref_name.lower()
            if key not in sources:
                raise PlanError(f"Unknown table '{tgt.name}' in "
                                "MULTI DELETE")
            want.append((key, sources[key]))

        self._handle_refs = {k for k, _ in want}
        try:
            plan = self.build_from(stmt.refs)
            if stmt.where is not None:
                r = Resolver(plan.schema)
                for c_ast in split_conjuncts(stmt.where):
                    plan = self._assign_cond(plan, r.resolve(c_ast), True)
        finally:
            self._handle_refs = set()

        targets = []
        for key, ts in want:
            _db, info = self._table_info(ts)
            handle_idx = col_start = None
            for i, sc in enumerate(plan.schema.cols):
                if sc.table != key:
                    continue
                if col_start is None:
                    col_start = i
                if sc.name == "_handle":
                    handle_idx = i
            if handle_idx is None:
                raise PlanError(f"no handle for target '{ts.name}'")
            targets.append((info, col_start, handle_idx))
        return ph.PhysMultiDelete(targets=targets, reader=plan)


def _type_word(ft) -> str:
    from tidb_tpu_torch.sqltypes import TypeCode
    return {TypeCode.LONGLONG: "bigint", TypeCode.LONG: "int",
            TypeCode.DOUBLE: "double", TypeCode.NEWDECIMAL: "decimal",
            TypeCode.VARCHAR: "varchar", TypeCode.STRING: "char",
            TypeCode.DATE: "date", TypeCode.DATETIME: "datetime",
            TypeCode.TIMESTAMP: "timestamp", TypeCode.ENUM: "enum",
            TypeCode.SET: "set",
            TypeCode.JSON: "json"}.get(ft.tp, "unknown")


def _union_ft(fts):
    """Unified output type of one UNION column position: numeric widening
    (int < decimal < real); any other mix coerces to string (MySQL)."""
    from tidb_tpu_torch.sqltypes import (EvalType, new_decimal_field,
                                   new_double_field, new_string_field)
    ets = [ft.eval_type for ft in fts]
    if all(e == ets[0] for e in ets):
        if ets[0] == EvalType.DECIMAL:
            frac = max(ft.frac for ft in fts)
            flen = max(ft.flen for ft in fts)
            return new_decimal_field(flen, frac)
        return fts[0]
    numeric = {EvalType.INT, EvalType.REAL, EvalType.DECIMAL}
    if all(e in numeric for e in ets):
        if EvalType.REAL in ets:
            return new_double_field()
        frac = max(ft.frac for ft in fts
                   if ft.eval_type == EvalType.DECIMAL)
        return new_decimal_field(30, frac)
    return new_string_field(255)


def _in_as_scalar(left, sel) -> ast.SubqueryExpr:
    """`left IN (sel)` as a scalar aggregate with IN's three-valued
    semantics: 0 for the empty set, 1 on a match, NULL when undecided
    (left NULL or a NULL among the non-matching set), else 0. SUM
    skips NULL comparisons, which is exactly the counting needed."""
    import dataclasses
    first = sel.selects[0] if isinstance(sel, ast.UnionStmt) else sel
    if len(first.fields) != 1:
        raise PlanError("subquery must return 1 column for IN")
    if isinstance(first.fields[0].expr, ast.Star):
        raise PlanError("IN (SELECT *) in expression position needs "
                        "the column named explicitly")
    nf = dataclasses.replace(first.fields[0], alias="__v")
    nfirst = dataclasses.replace(first, fields=[nf])
    sel = dataclasses.replace(sel, selects=[nfirst] + sel.selects[1:]) \
        if isinstance(sel, ast.UnionStmt) else nfirst
    y = ast.ColName(name="__v", table="__in")
    lit = ast.Literal
    eq_sum = ast.AggregateCall(name="SUM",
                               args=[ast.BinaryOp("=", y, left)])
    null_sum = ast.AggregateCall(name="SUM",
                                 args=[ast.IsNullExpr(expr=y)])
    case = ast.CaseExpr(operand=None, when_clauses=[
        (ast.BinaryOp("=", ast.AggregateCall(name="COUNT", star=True),
                      lit(0)), lit(0)),
        (ast.BinaryOp(">", eq_sum, lit(0)), lit(1)),
        (ast.BinaryOp("OR", ast.IsNullExpr(expr=left),
                      ast.BinaryOp(">", null_sum, lit(0))), lit(None)),
    ], else_clause=lit(0))
    return ast.SubqueryExpr(select=ast.SelectStmt(
        fields=[ast.SelectField(expr=case)],
        from_clause=ast.SubqueryTable(select=sel, alias="__in")))


def _iter_nodes(e, stop: tuple = ()):
    """Yield `e` and every ast.Node under it (fields, lists, tuples of
    nodes). Nodes of a `stop` type are yielded but not descended into."""
    yield e
    if isinstance(e, stop):
        return
    for f in vars(e).values():
        if isinstance(f, ast.Node):
            yield from _iter_nodes(f, stop)
        elif isinstance(f, (list, tuple)):
            for x in f:
                if isinstance(x, ast.Node):
                    yield from _iter_nodes(x, stop)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, ast.Node):
                            yield from _iter_nodes(y, stop)


def _reads_table(e, db: str, name: str, cur_db: str) -> bool:
    """Does any subquery under `e` scan table `db.name`? (DML WHERE
    may not read its own target table — MySQL error 1093.) An
    unqualified TableSource resolves against the session db."""
    db, name = db.lower(), name.lower()
    return any(isinstance(n, ast.TableSource) and
               n.name.lower() == name and
               (n.db or cur_db).lower() == db
               for n in _iter_nodes(e))


def _contains_scalar_subquery(e) -> bool:
    """True when a subquery appears in expression position inside `e`
    and the lift can rewrite it (scalar, IN-subquery via its items
    node, EXISTS); does not cross into nested subquery bodies."""
    stop = (ast.SubqueryExpr, ast.ExistsSubquery, ast.QuantSubquery,
            ast.SelectStmt, ast.UnionStmt)
    return any(isinstance(n, (ast.SubqueryExpr, ast.ExistsSubquery))
               for n in _iter_nodes(e, stop))


def _contains_agg(stmt: ast.SelectStmt) -> bool:
    found = False

    def walk(n):
        nonlocal found
        if found or n is None or not isinstance(n, ast.Node):
            return
        if isinstance(n, ast.AggregateCall):
            found = True
            return
        if isinstance(n, (ast.SubqueryExpr, ast.ExistsSubquery)):
            return  # inner aggregates belong to the subquery
        for f in vars(n).values():
            if isinstance(f, ast.Node):
                walk(f)
            elif isinstance(f, (list, tuple)):
                for x in f:
                    if isinstance(x, ast.Node):
                        walk(x)
                    elif isinstance(x, tuple):
                        for y in x:
                            walk(y) if isinstance(y, ast.Node) else None
    for f in stmt.fields:
        walk(f.expr)
    walk(stmt.having)
    for bi in stmt.order_by:
        walk(bi.expr)
    return found


def _field_name(e: ast.ExprNode) -> str:
    if isinstance(e, ast.ColName):
        return e.name.lower()
    if isinstance(e, ast.AggregateCall):
        return f"{e.name.lower()}({'*' if e.star else '...'})"
    if isinstance(e, ast.Literal):
        return str(e.value)
    if isinstance(e, ast.SubqueryExpr):
        return "(subquery)"
    if isinstance(e, ast.ExistsSubquery):
        return "exists(subquery)"
    if isinstance(e, ast.InExpr) and \
            isinstance(e.items, ast.SubqueryExpr):
        return f"{_field_name(e.expr)} in (subquery)"
    return type(e).__name__.lower()


class _AggResolver:
    """Resolves select/having/order exprs over an aggregation's output:
    whole-or-sub expressions matching a GROUP BY item become group column
    refs; AggregateCalls land in the agg list; bare columns not in GROUP BY
    get implicit FIRST_ROW (MySQL loose group-by, like the reference's
    aggregation builder)."""

    def __init__(self, in_schema: PlanSchema, aggs: list[AggDesc],
                 num_group: int, group_reprs: list[str],
                 group_exprs: list[Expression]):
        self.in_schema = in_schema
        self.aggs = aggs
        self.num_group = num_group
        self.group_reprs = group_reprs
        self.group_exprs = group_exprs

    def resolve_over_agg(self, e: ast.ExprNode) -> Expression:
        # whole-expr group match
        er = repr(e)
        for i, gr in enumerate(self.group_reprs):
            if er == gr:
                return ColumnRef(i, self.group_exprs[i].ft)
        if isinstance(e, ast.AggregateCall):
            r = Resolver(self.in_schema, agg_collector=self.aggs,
                         agg_base=self.num_group)
            return r._r_AggregateCall(e)
        if isinstance(e, ast.ColName):
            # bare column not in group -> implicit first_row
            r = Resolver(self.in_schema)
            inner = r.resolve(e)
            desc = AggDesc(AggFunc.FIRST_ROW, inner)
            for i, d in enumerate(self.aggs):
                if repr(d) == repr(desc):
                    return ColumnRef(self.num_group + i, d.result_ft)
            self.aggs.append(desc)
            return ColumnRef(self.num_group + len(self.aggs) - 1,
                             desc.result_ft)
        if isinstance(e, ast.Literal):
            return Resolver(self.in_schema).resolve(e)
        # composite: rebuild node with resolved children
        sub = _SubResolver(self)
        return sub.resolve(e)


class _SubResolver(Resolver):
    """Resolver whose leaf ColName/AggregateCall handling delegates to the
    surrounding _AggResolver (group/agg output refs)."""

    def __init__(self, parent: _AggResolver):
        super().__init__(parent.in_schema)
        self.parent = parent

    def resolve(self, e: ast.ExprNode) -> Expression:
        er = repr(e)
        for i, gr in enumerate(self.parent.group_reprs):
            if er == gr:
                return ColumnRef(i, self.parent.group_exprs[i].ft)
        if isinstance(e, (ast.ColName, ast.AggregateCall)):
            return self.parent.resolve_over_agg(e)
        return super().resolve(e)
