"""Session: the SQL entry point.

The port of the part of the JAX package's session/__init__.py that the
analytic SQL path drives (reference: TiDB's session.go, Session.Execute:
parse -> compile -> run, :691-774; domain/domain.go, the Domain that
caches the infoschema per schema version). `Session(storage).execute(sql)`
parses the text (parser/), plans it (plan/planner.py) over the schema
that the DDL layer (ddl/) wrote through meta/, and runs the plan through
executor.build_executor on the device of the storage (`storage.device`:
CUDA unless the storage was made on another device). `query(sql)`
returns the first ResultSet.

Statements: the DDL (CREATE/DROP DATABASE and TABLE, TRUNCATE, RENAME,
CREATE/DROP INDEX, ALTER TABLE: an open transaction commits first), USE,
SET (session and GLOBAL sysvars, user variables, `autocommit`),
BEGIN/COMMIT/ROLLBACK, INSERT, UPDATE and DELETE (single- and
multi-table), SELECT (with FOR UPDATE), EXPLAIN (without ANALYZE) and
ANALYZE TABLE. Every other statement kind raises SQLError naming it as
not ported yet: SHOW, PREPARE/EXECUTE, TRACE, LOAD DATA, the account
statements and grants, ADMIN, KILL.

Transactions (ref: session.go:287 doCommitWithRetry, :393 retry): a
statement reads at the open transaction's start_ts through its union
store, else at a fresh ts. A DML statement runs in the open transaction
(or an implicit one, committed at once under autocommit, kept open
under `autocommit = 0`) and is atomic: a failed statement restores the
write buffer as it found it. COMMIT retries a retryable conflict up to
COMMIT_RETRY_LIMIT times by replaying the transaction's statements on a
fresh one, unless it took FOR UPDATE locks; the schema check at commit
refuses a transaction whose written tables a later schema version
changed.

Each non-internal statement is one memtrack statement root (carrying
tidb_tpu_mem_quota_query, under the session's root) and one meter entry
(`meter.statement_meter`), with the session's sysvars installed as the
config overlay; after it, `last_stats` holds the operators' counters
(executor.ExecStats), `last_collector` the runtime-stats collector
(always built, without device timing: EXPLAIN ANALYZE, which reads the
timed kind, is not ported),
`last_mem` the statement's ledger, `last_mem_left` the bytes it still
held when the statement ended (0 after a clean statement; the ledger is
then credited back to the session) and `last_phases` the
parse/plan/execute/format wall times in ns.

Left out with the modules that own them: privilege checks, bootstrap
and the owner election (with no `mysql` database the reference runs no
grant check either: its bootstrap-less library mode), the plan cache,
the schema and stats background workers, server admission, perfschema
digests and the slow log.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass

import numpy as np

from tidb_tpu_torch import config, kv, memtrack, meter, trace
from tidb_tpu_torch import runtime_stats as rs
from tidb_tpu_torch.ddl import DDLError, DDLExecutor
from tidb_tpu_torch.errcode import not_ported
from tidb_tpu_torch.executor import (ExecContext, ExecError, ExecStats,
                                     build_executor)
from tidb_tpu_torch.meta import Meta
from tidb_tpu_torch.ops import segsum
from tidb_tpu_torch.parser import ast, parse
from tidb_tpu_torch.plan import Planner
from tidb_tpu_torch.plan.planner import PlanError
from tidb_tpu_torch.plan.resolver import PlanSchema, ResolveError, Resolver
from tidb_tpu_torch.schema.infoschema import InfoSchema, SchemaError
from tidb_tpu_torch.sqltypes import (EvalType, TypeCode, format_datetime,
                                     format_duration, scaled_to_decimal)

__all__ = ["Session", "ResultSet", "Domain", "SQLError"]

COMMIT_RETRY_LIMIT = 10  # ref: tidb.go:109 commitRetryLimit

_session_seq = 0
_session_seq_lock = threading.Lock()

_DDL_STMTS = (ast.CreateDatabaseStmt, ast.CreateTableStmt,
              ast.CreateIndexStmt, ast.DropTableStmt, ast.DropDatabaseStmt,
              ast.DropIndexStmt, ast.AlterTableStmt, ast.TruncateTableStmt,
              ast.RenameTableStmt)


class SQLError(Exception):
    pass


@dataclass
class ResultSet:
    columns: list[str]
    rows: list[tuple]
    field_types: list | None = None   # FieldType per column

    def __repr__(self):
        return f"ResultSet({self.columns}, {len(self.rows)} rows)"


class Domain:
    """Caches the InfoSchema per schema version and holds the stats
    handle (ref: domain.Reload, domain/domain.go:267). One per storage
    while a session of it lives: the registry holds the domains weakly,
    so a storage no session uses is freed with its domain."""

    _instances: "weakref.WeakValueDictionary[int, Domain]" = \
        weakref.WeakValueDictionary()
    _lock = threading.Lock()

    def __init__(self, storage):
        self.storage = storage
        self._schema: InfoSchema | None = None
        self._mu = threading.Lock()
        self._stats = None

    @classmethod
    def get(cls, storage) -> "Domain":
        with cls._lock:
            d = cls._instances.get(id(storage))
            if d is None:
                d = cls(storage)
                cls._instances[id(storage)] = d
            return d

    def stats_handle(self):
        """Lazy per-store stats cache (ref: statistics/handle.go:32)."""
        if self._stats is None:
            from tidb_tpu_torch.statistics import StatsHandle
            self._stats = StatsHandle(self.storage)
        return self._stats

    def info_schema(self) -> InfoSchema:
        txn = self.storage.begin()
        try:
            meta = Meta(txn)
            ver = meta.schema_version()
            with self._mu:
                if self._schema is not None and self._schema.version == ver:
                    return self._schema
                self._schema = InfoSchema.load(meta)
                return self._schema
        finally:
            txn.rollback()


class Session:
    """Ref: session.go Session iface (:62-86)."""

    def __init__(self, storage, db: str = "", user: str = "root",
                 host: str = "%", internal: bool = False):
        global _session_seq
        self.storage = storage
        self.domain = Domain.get(storage)
        self.current_db = db
        self.user = user
        self.host = host
        self.internal = internal
        self.txn: kv.Transaction | None = None
        self._history: list = []     # the open txn's DML, for a retry
        self.autocommit = True
        self.vars: dict[str, object] = {}
        self.sys_vars: dict[str, object] = {"autocommit": 1,
                                            "sql_mode": "STRICT_TRANS_TABLES"}
        self.last_stats: ExecStats | None = None
        self.last_collector = None
        self.last_mem = None
        self.last_mem_left = 0
        self.last_phases: dict[str, int] = {}
        self.killed = False
        with _session_seq_lock:
            _session_seq += 1
            self.session_id = _session_seq
        self.mem_tracker = None
        self.res_meter = None
        if not internal:
            self.mem_tracker = memtrack.session_root(self.session_id)
            self.res_meter = meter.session_meter(self.session_id,
                                                 self.user or "")
            # sessions are not reliably close()d: the finalizers detach
            # the tracker from the server root and mark the meter
            # evictable
            self._mem_finalizer = weakref.finalize(
                self, self.mem_tracker.detach)
            self._meter_finalizer = weakref.finalize(
                self, meter.session_closed, self.session_id)

    # -- public API ----------------------------------------------------------

    def execute(self, sql: str):
        """Execute semicolon-separated statements; returns a list of
        ResultSet (queries) / int (affected rows) / None (commands)."""
        t0 = time.perf_counter_ns()
        stmts = parse(sql)
        parse_ns = (time.perf_counter_ns() - t0) // max(len(stmts), 1)
        return [self._timed_stmt(stmt, parse_ns) for stmt in stmts]

    def query(self, sql: str) -> ResultSet:
        for r in self.execute(sql):
            if isinstance(r, ResultSet):
                return r
        raise SQLError("statement returned no result set")

    def plan(self, sql: str):
        """Plan a single SELECT and return the physical plan (no
        execution) — the programmatic EXPLAIN."""
        stmts = parse(sql)
        if len(stmts) != 1:
            raise SQLError("plan() takes a single statement")
        try:
            return self._planner().plan(stmts[0])
        except (PlanError, ResolveError) as e:
            raise SQLError(str(e)) from None

    def close(self):
        if not self.internal:
            self._mem_finalizer()
            self._meter_finalizer()
        if self.txn is not None:
            self.txn.rollback()
            self.txn = None

    # -- statement lifecycle -------------------------------------------------

    def _timed_stmt(self, stmt, parse_ns: int):
        """One statement as the reference's adapter runs it: the
        session's sysvars as the config overlay, a memtrack statement
        root with the quota, a statement meter, and a trace root whose
        phase spans give `last_phases`."""
        self.killed = False
        self.last_stats = None
        self.last_collector = None
        self.last_phases = {"parse": parse_ns}
        if self.internal:
            token = trace.detach()
            try:
                with memtrack.suspended(), meter.suspended():
                    return self._run_stmt(stmt)
            finally:
                trace.restore(token)
        overlay = {k: v for k, v in self.sys_vars.items()
                   if config.is_known(k)}
        kind = type(stmt).__name__.removesuffix("Stmt").lower()
        root = trace.begin("statement", type=kind)
        quota_cancel: list[str] = []

        def _on_quota_cancel(msg: str) -> None:
            quota_cancel.append(msg)
            self.killed = True

        mt = memtrack.statement_root(self.mem_tracker,
                                     on_cancel=_on_quota_cancel,
                                     label=f"stmt-{self.session_id}")
        self.last_mem = mt
        sm = meter.statement_meter(self.res_meter)
        res = None
        try:
            with config.session_overlay(overlay), meter.metering(sm):
                mt.quota = config.mem_quota_query()   # session-shadowed
                try:
                    with memtrack.tracking(mt):
                        res = self._run_stmt(stmt)
                except memtrack.QuotaExceededError as e:
                    self._rollback()
                    raise SQLError(str(e)) from None
                except Exception as e:
                    if quota_cancel and "interrupted" in str(e).lower():
                        # the cancel fired on a fan-out worker: surface
                        # the quota error, not the generic interrupt
                        self._rollback()
                        raise SQLError(quota_cancel[0]) from None
                    raise
        finally:
            trace.end(root)
            for name in ("plan", "execute"):
                self.last_phases[name] = trace.phase_ns(root, name)
            nrows = len(res.rows) if isinstance(res, ResultSet) else \
                (res if isinstance(res, int) else 0)
            sm.add(rows_sent=nrows, statements=1)
            # release-on-close: credit everything still held back to the
            # session root; the peaks stay readable on last_mem
            self.last_mem_left = mt.total()
            if self.last_stats is not None:
                self.last_stats.mem_left = mt.total()
                self.last_stats.mem_peak = mt.total_peak
                self.last_stats.mem_device_at_peak = mt.device_at_peak
                self.last_stats.fault_degraded = mt.fault_degraded
            mt.detach()
            self.killed = False
        return res

    # -- txn lifecycle -------------------------------------------------------

    def _attach_schema_checker(self, txn) -> None:
        start_ver = self.domain.info_schema().version
        txn.schema_checker = lambda: self._check_schema_valid(
            start_ver, txn.related_tables)

    def _begin_txn(self):
        if self.txn is None:
            self.txn = self.storage.begin()
            self._history = []
            self._attach_schema_checker(self.txn)
        return self.txn

    def _read_ts(self) -> int:
        if self.txn is not None:
            return self.txn.start_ts
        return self.storage.current_ts()

    def _commit(self):
        """Commit with optimistic retry: on a retryable conflict, replay
        the transaction's statement history at a fresh ts."""
        txn = self.txn
        self.txn = None
        if txn is None:
            return
        history = self._history
        self._history = []
        # one span covers the first attempt and the replays
        with trace.span("commit") as cspan:
            try:
                txn.commit()
                return
            except kv.UndeterminedError:
                raise
            except kv.RetryableError as first_err:
                if txn.for_update:
                    # FOR UPDATE promised the read rows stayed put:
                    # replaying silently would break that promise
                    raise
                last = first_err
                for _ in range(COMMIT_RETRY_LIMIT):
                    cspan.tags["retries"] = \
                        cspan.tags.get("retries", 0) + 1
                    retry_txn = self.storage.begin()
                    self._attach_schema_checker(retry_txn)
                    try:
                        self.txn = retry_txn
                        for stmt in history:
                            self._exec_dml_in_txn(stmt)
                        self.txn = None
                        retry_txn.commit()
                        return
                    except kv.RetryableError as e:
                        self.txn = None
                        last = e
                    except Exception:
                        self.txn = None
                        retry_txn.rollback()
                        raise
                raise last

    def _rollback(self):
        if self.txn is not None:
            self.txn.rollback()
            self.txn = None
        self._history = []

    # -- dispatch ------------------------------------------------------------

    def _run_stmt(self, stmt: ast.StmtNode):
        if isinstance(stmt, ast.SelectStmt):
            stmt, _ = self._fold_session_exprs(stmt)
            return self._exec_query(stmt)
        if isinstance(stmt, (ast.InsertStmt, ast.UpdateStmt,
                             ast.DeleteStmt)):
            stmt, _ = self._fold_session_exprs(stmt)
            return self._exec_dml(stmt)
        if isinstance(stmt, _DDL_STMTS):
            if self.txn is not None:
                self._commit()  # implicit commit before DDL (MySQL)
            return self._exec_ddl(stmt)
        if isinstance(stmt, ast.BeginStmt):
            if self.txn is not None:
                self._commit()
            self._begin_txn()
            return None
        if isinstance(stmt, ast.CommitStmt):
            self._commit()
            return None
        if isinstance(stmt, ast.RollbackStmt):
            self._rollback()
            return None
        if isinstance(stmt, ast.UseStmt):
            ischema = self.domain.info_schema()
            if stmt.db.lower() != "information_schema" and \
                    not ischema.has_db(stmt.db):
                raise SQLError(f"Unknown database '{stmt.db}'")
            self.current_db = stmt.db
            return None
        if isinstance(stmt, ast.SetStmt):
            return self._exec_set(stmt)
        if isinstance(stmt, ast.ExplainStmt):
            if stmt.analyze:
                raise SQLError(not_ported("EXPLAIN ANALYZE"))
            return self._exec_explain(stmt)
        if isinstance(stmt, ast.AnalyzeStmt):
            return self._exec_analyze(stmt)
        raise SQLError(not_ported(
            f"the {type(stmt).__name__.removesuffix('Stmt')} statement"))

    def _planner(self) -> Planner:
        return Planner(self.domain.info_schema(), self.current_db,
                       stats_handle=self.domain.stats_handle(),
                       storage=self.storage)

    def _plan(self, stmt):
        with trace.span("plan", cached=False):
            try:
                return self._planner().plan(stmt)
            except (PlanError, ResolveError, SchemaError) as e:
                raise SQLError(str(e)) from None

    def _context(self, read_ts: int, txn=None) -> ExecContext:
        return ExecContext(self.storage.device, storage=self.storage,
                           read_ts=read_ts, txn=txn,
                           interrupted=lambda: self.killed)

    def _exec_query(self, stmt) -> ResultSet:
        if getattr(stmt, "for_update", False) and self.txn is None and \
                not self.autocommit:
            # autocommit=0: the SELECT starts the transaction, so its
            # locks hold until COMMIT (MySQL)
            self._begin_txn()
        plan = self._plan(stmt)
        ctx = self._context(self._read_ts(), self.txn)
        coll = rs.StatsCollector()
        launches = segsum.launches
        try:
            with rs.collecting(coll):
                exe = build_executor(plan)
                with trace.span("execute", executor=type(exe).__name__):
                    chunks = []
                    for ch in exe.chunks(ctx):
                        if self.killed:   # KILL QUERY: cooperative check
                            raise SQLError(
                                "Query execution was interrupted")
                        chunks.append(ch)
        except ExecError as e:
            raise SQLError(str(e)) from None
        finally:
            ctx.stats.segsum_launches += segsum.launches - launches
            self.last_stats = ctx.stats
            self.last_collector = coll
        if getattr(stmt, "for_update", False) and self.txn is not None:
            try:
                self._lock_rows_for_update(stmt)
            except ExecError as e:
                raise SQLError(str(e)) from None
        self._check_nested_for_update(stmt)
        t0 = time.perf_counter_ns()
        rows = []
        for ch in chunks:
            rows.extend(_format_chunk(ch))
        self.last_phases["format"] = time.perf_counter_ns() - t0
        return ResultSet(columns=[c.name for c in plan.schema.cols],
                         rows=rows,
                         field_types=[c.ft for c in plan.schema.cols])

    # -- DML -----------------------------------------------------------------

    def _exec_dml(self, stmt) -> int:
        in_txn = self.txn is not None
        self._begin_txn()
        # statement-level atomicity: snapshot the write buffer, so a
        # failed statement rolls back ITS writes without ending the txn
        membuf = self.txn.us.membuf
        saved = membuf._d.copy()
        saved_size = membuf.size
        saved_presumed = set(self.txn.us.presumed_not_exists)
        try:
            n = self._exec_dml_in_txn(stmt)
        except Exception:
            if self.txn is not None:
                self.txn.us.membuf._d = saved
                self.txn.us.membuf.size = saved_size
                self.txn.us.presumed_not_exists = saved_presumed
            if not in_txn and self.autocommit:
                self._rollback()
            raise      # autocommit=0 keeps the implicit txn open
        self._history.append(stmt)
        self._note_dml_delta(stmt, n)
        if not in_txn and self.autocommit:
            self._commit()
        return n

    def _exec_dml_in_txn(self, stmt) -> int:
        from tidb_tpu_torch.plan import physical as ph
        plan = self._plan(stmt)
        if isinstance(plan, (ph.PhysInsert, ph.PhysUpdate, ph.PhysDelete)):
            # schema validation scope: the tables this txn WRITES
            self.txn.related_tables.add(plan.table.id)
        elif isinstance(plan, (ph.PhysMultiUpdate, ph.PhysMultiDelete)):
            for target in plan.targets:
                self.txn.related_tables.add(target[0].id)
        ctx = self._context(self.txn.start_ts, self.txn)
        coll = rs.StatsCollector()
        launches = segsum.launches
        try:
            with rs.collecting(coll):
                exe = build_executor(plan)
                with trace.span("execute", executor=type(exe).__name__):
                    n = exe.execute(ctx)
            lid = getattr(ctx, "last_insert_id", None)
            if lid is not None:
                self.last_insert_id = lid
            return n
        except ExecError as e:
            raise SQLError(str(e)) from None
        finally:
            ctx.stats.segsum_launches += segsum.launches - launches
            self.last_stats = ctx.stats
            self.last_collector = coll

    def _check_nested_for_update(self, stmt) -> None:
        """FOR UPDATE buried in a derived table or subquery would take
        no locks: refuse it."""
        import dataclasses

        def walk(x, top):
            if isinstance(x, ast.SelectStmt) and not top and \
                    x.for_update:
                raise SQLError("FOR UPDATE is only supported on "
                               "single-table queries")
            if dataclasses.is_dataclass(x) and isinstance(x, ast.Node):
                for f in dataclasses.fields(x):
                    walk(getattr(x, f.name), False)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v, False)

        walk(stmt, isinstance(stmt, ast.SelectStmt))

    def _lock_rows_for_update(self, stmt) -> None:
        """SELECT ... FOR UPDATE inside a txn: lock every row the WHERE
        matches (ref: executor/executor.go:389 SelectLockExec; keys
        buffered in the txn, conflict-checked at commit), even under
        LIMIT, through a second scan of the filter."""
        from tidb_tpu_torch import tablecodec
        src = stmt.from_clause
        if src is None:
            return                # SELECT 1 FOR UPDATE: nothing to lock
        if not isinstance(src, ast.TableSource):
            raise SQLError(
                "FOR UPDATE is only supported on single-table queries")
        try:
            info, reader = self._planner()._plan_writable_reader(
                src, stmt.where)
        except (PlanError, ResolveError) as e:
            raise SQLError(str(e)) from None
        self.txn.related_tables.add(info.id)
        ctx = self._context(self.txn.start_ts, self.txn)
        for chunk in build_executor(reader).chunks(ctx):
            for h in chunk.columns[-1].data.tolist():
                self.txn.lock_key(tablecodec.record_key(info.id, int(h)))

    def _check_schema_valid(self, start_ver: int, table_ids) -> None:
        """Commit-time schema validation (ref: domain/schema_validator.go:
        35-47): a txn planned against schema version `start_ver` commits
        iff no later version changed a table it wrote."""
        txn = self.storage.begin()
        try:
            m = Meta(txn)
            cur = m.schema_version()
            if cur == start_ver:
                return
            for v in range(start_ver + 1, cur + 1):
                diff = m.schema_diff(v)
                if diff is None or any(t in table_ids for t in diff):
                    raise kv.SchemaChangedError(
                        f"schema changed (v{start_ver} -> v{cur}), "
                        f"txn must retry")
        finally:
            txn.rollback()

    def _note_dml_delta(self, stmt, n: int) -> None:
        ts = stmt.table
        if isinstance(ts, ast.TableSource):
            try:
                info = self.domain.info_schema().table(
                    ts.db or self.current_db, ts.name)
                self.domain.stats_handle().note_dml(info.id, n)
            except Exception:   # noqa: BLE001 - bookkeeping never fails DML
                pass

    # -- DDL / SET / EXPLAIN / ANALYZE ---------------------------------------

    def _exec_ddl(self, stmt):
        dropped = self._dropped_table_ids(stmt)
        try:
            DDLExecutor(self.storage).execute(stmt, self.current_db,
                                              domain=self.domain)
        except DDLError as e:
            raise SQLError(str(e)) from None
        for tid in dropped:
            self.domain.stats_handle().drop(tid)
        return None

    def _dropped_table_ids(self, stmt) -> list:
        """Table ids about to be dropped or truncated (their statistics
        go with them)."""
        ischema = self.domain.info_schema()
        sources = []
        if isinstance(stmt, ast.DropTableStmt):
            sources = stmt.tables
        elif isinstance(stmt, ast.TruncateTableStmt):
            sources = [stmt.table]
        elif isinstance(stmt, ast.DropDatabaseStmt):
            if ischema.has_db(stmt.name):
                return [ischema.table(stmt.name, n).id
                        for n in ischema.table_names(stmt.name)]
        out = []
        for ts in sources:
            db = ts.db or self.current_db
            if ischema.has_table(db, ts.name):
                out.append(ischema.table(db, ts.name).id)
        return out

    def _exec_set(self, stmt: ast.SetStmt):
        import dataclasses
        r = Resolver(PlanSchema([]))
        for a in stmt.assignments:
            # fold user-var reads PER assignment, after the previous
            # ones applied: SET @a = 1, @b = @a + 1 is left-to-right
            if isinstance(a.value, ast.ExprNode):
                nv, changed = self._fold_session_exprs(a.value)
                if changed:
                    a = dataclasses.replace(a, value=nv)
            if isinstance(a.value, ast.ColName):
                val = a.value.name  # bare words like STRICT
            else:
                e = r.resolve(a.value)
                d, v = e.eval_xp(np, [], 1)
                if not v[0]:
                    val = None
                elif e.ft.eval_type == EvalType.DECIMAL:
                    val = scaled_to_decimal(int(d[0]), e.ft.frac)
                else:
                    val = d[0].item() if hasattr(d[0], "item") else d[0]
            if not a.is_system:
                self.vars[a.name.lower()] = val
                continue
            if config.is_known(a.name):
                # registry knobs: GLOBAL writes the process registry;
                # session scope shadows it via the statement overlay
                try:
                    val = config.coerce(a.name, val)
                except (TypeError, ValueError):
                    raise SQLError(
                        f"invalid value for @@{a.name}: {val!r}") from None
                if getattr(a, "is_global", False):
                    config.set_var(a.name, val)
            if not getattr(a, "is_global", False):
                # GLOBAL never touches the session scope (MySQL)
                self.sys_vars[a.name.lower()] = val
                if a.name.lower() == "autocommit":
                    self.autocommit = bool(int(val)) \
                        if val is not None else True
        return None

    def _exec_explain(self, stmt: ast.ExplainStmt) -> ResultSet:
        lines = self._plan(stmt.stmt).explain().split("\n")
        return ResultSet(["plan"], [(line,) for line in lines])

    def _exec_analyze(self, stmt: ast.AnalyzeStmt):
        """ANALYZE TABLE: full-scan stats build + persist (ref:
        executor/analyze.go:42; statistics/handle.go). A large numeric
        column sorts on the storage's device (ops/stats.device_sort)."""
        from tidb_tpu_torch.statistics import analyze_table
        handle = self.domain.stats_handle()
        ischema = self.domain.info_schema()
        for ts in stmt.tables:
            try:
                info = ischema.table(ts.db or self.current_db, ts.name)
            except SchemaError as e:
                raise SQLError(str(e)) from None
            with trace.span("execute", executor="Analyze"):
                stats = analyze_table(self.storage,
                                      self.storage.current_ts(), info)
            handle.save(stats)
        return None

    # -- session-context expressions (ref: expression/builtin_info.go) ------

    _SESSION_FUNCS = ("VERSION", "USER", "SESSION_USER", "SYSTEM_USER",
                      "CURRENT_USER", "CONNECTION_ID", "DATABASE",
                      "SCHEMA", "LAST_INSERT_ID")

    def _session_expr_value(self, e):
        """-> (handled, value) for @@vars / @vars / session funcs."""
        if isinstance(e, ast.VariableExpr):
            if not e.is_system:
                return True, self.vars.get(
                    "@" + e.name.lstrip("@").lower())
            name = e.name.lower()
            if name in self.sys_vars and not e.is_global:
                return True, self.sys_vars[name]
            if config.is_known(name):
                return True, config.get_var(name)
            if name == "version":
                return True, config.SERVER_VERSION
            raise SQLError(f"Unknown system variable '{e.name}'")
        if isinstance(e, ast.FuncCall) and \
                e.name.upper() in self._SESSION_FUNCS and not e.args:
            n = e.name.upper()
            if n == "VERSION":
                return True, config.SERVER_VERSION
            if n in ("USER", "SESSION_USER", "SYSTEM_USER",
                     "CURRENT_USER"):
                return True, f"{self.user}@{self.host}"
            if n == "CONNECTION_ID":
                return True, self.session_id
            if n == "LAST_INSERT_ID":
                return True, getattr(self, "last_insert_id", 0)
            return True, self.current_db or None   # DATABASE/SCHEMA
        return False, None

    def _fold_session_exprs(self, node):
        """Rebuild the AST with session-context expressions folded to
        literals. -> (node, changed)."""
        import dataclasses
        changed = False

        def walk(x):
            nonlocal changed
            if isinstance(x, ast.VarAssignExpr):
                raise SQLError(not_ported("@v := assignment"))
            if isinstance(x, ast.ExprNode):
                handled, val = self._session_expr_value(x)
                if handled:
                    changed = True
                    return ast.Literal(val)
            if dataclasses.is_dataclass(x) and isinstance(x, ast.Node):
                updates = {}
                for f in dataclasses.fields(x):
                    v = getattr(x, f.name)
                    nv = walk(v)
                    if nv is not v:
                        updates[f.name] = nv
                return dataclasses.replace(x, **updates) if updates else x
            if isinstance(x, list):
                out = [walk(v) for v in x]
                return out if any(a is not b for a, b in zip(out, x)) \
                    else x
            if isinstance(x, tuple):
                out = tuple(walk(v) for v in x)
                return out if any(a is not b for a, b in zip(out, x)) \
                    else x
            return x

        return walk(node), changed


def _format_chunk(ch) -> list[tuple]:
    """Chunk-layer values -> client values (Decimal objects, datetime
    strings)."""
    rows = []
    cols = ch.columns
    for i in range(ch.num_rows):
        row = []
        for c in cols:
            if not c.valid[i]:
                row.append(None)
                continue
            v = c.data[i]
            et = c.ft.eval_type
            if et == EvalType.DECIMAL:
                row.append(scaled_to_decimal(int(v), c.ft.frac))
            elif et == EvalType.DATETIME:
                row.append(format_datetime(int(v), c.ft.tp))
            elif et == EvalType.DURATION:
                row.append(format_duration(int(v), c.ft.frac))
            elif isinstance(v, bytes) and c.ft.tp == TypeCode.JSON:
                # JSON text reaches clients as str; BLOB bytes stay raw
                row.append(v.decode("utf8", "replace"))
            elif hasattr(v, "item"):
                row.append(v.item())
            else:
                row.append(v)
        rows.append(tuple(row))
    return rows
