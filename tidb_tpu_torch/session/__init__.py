"""Session: the SQL entry point.

The port of the JAX package's session/__init__.py (reference: TiDB's
session.go, Session.Execute: parse -> compile -> run, :691-774;
domain/domain.go, the Domain that caches the infoschema per schema
version). `Session(storage).execute(sql)` parses the text (parser/),
plans it (plan/planner.py) over the schema that the DDL layer (ddl/)
wrote through meta/, and runs the plan through executor.build_executor
on the device of the storage (`storage.device`: CUDA unless the storage
was made on another device). `query(sql)` returns the first ResultSet.

Statements: the DDL (CREATE/DROP DATABASE and TABLE, TRUNCATE, RENAME,
CREATE/DROP INDEX, ALTER TABLE: an open transaction commits first), USE,
SET (session and GLOBAL sysvars, user variables, `autocommit`; SET
GLOBAL persists into mysql.global_variables once the catalog exists),
BEGIN/COMMIT/ROLLBACK, INSERT, UPDATE and DELETE (single- and
multi-table), LOAD DATA INFILE (executor/loaddata.py, the native
scanner), SELECT (with FOR UPDATE, subqueries and UNION), EXPLAIN and
EXPLAIN ANALYZE (the plan annotated with each operator's actuals from
the runtime-stats collector), TRACE [FORMAT='row'|'json'], ANALYZE
TABLE, SPLIT TABLE, ADMIN (SHOW DDL, SHOW DDL JOBS, CANCEL DDL JOBS,
CHECK TABLE), SHOW, PREPARE/EXECUTE/DEALLOCATE (and the `prepare` /
`execute_prepared` API the binary protocol drives), KILL
[QUERY|CONNECTION], DO, `@v := expr`, FLUSH, DROP STATS, CREATE USER /
DROP USER / GRANT / REVOKE / SET PASSWORD.

Privileges (ref: privilege/privileges/privileges.go:56
RequestVerification): once the `mysql` catalog exists (bootstrap.py), a
non-internal session's statement is checked against the grant cache
(privilege.py, `Domain.priv_cache`); without it (a storage never
bootstrapped) no check runs, as in the reference's library mode.

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

Each non-internal statement (the reference's statement adapter,
executor/adapter.go): a perfschema event and digest record
(perfschema.py), server admission for the kinds that build executors
(sched.AdmissionController, projecting the digest's recorded peak), one
memtrack statement root (carrying tidb_tpu_mem_quota_query, under the
session's root; its interrupt probe is the session's KILL flag, read by
the coprocessor's pool workers and the device pipeline too) and one
meter entry, the session's sysvars installed as the config overlay, the
duration and memory metrics and the slow-query log. After it,
`last_stats` holds the operators' counters (executor.ExecStats),
`last_collector` the runtime-stats collector, `last_mem` the statement's
ledger, `last_mem_left` the bytes it still held when the statement ended
(0 after a clean statement; the ledger is then credited back to the
session) and `last_phases` the parse/plan/execute/format wall times in
ns. A single-statement SELECT's plan is cached in `Domain.plan_cache`
under its text, database, schema version and stats version; a prepared
statement binds its markers as constants and re-plans per execution, as
the reference does. A statement's trace root is sampled at begin
(`tidb_tpu_trace_sample`), forced by TRACE, or kept when it runs past
`tidb_tpu_slow_trace_ms`; a retained tree enters the trace ring
(trace.py) and its id reaches the digest summary's `last_trace_id` and
the slow log. The runtime-stats collector (`tidb_tpu_runtime_stats`,
device times under `tidb_tpu_runtime_stats_device`) gives the digests
and the slow log their operator rows and wall times.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from dataclasses import dataclass

import numpy as np

from tidb_tpu_torch import (config, errcode, kv, memtrack, meter, metrics,
                            perfschema, sched, tablecodec, trace)
from tidb_tpu_torch import runtime_stats as rs
from tidb_tpu_torch.ddl import DDLError, DDLExecutor
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

# dedicated slow-query logger (ref: util/logutil/log.go:228-248 separate
# slow-query log file; executor/adapter.go:353 emit site)
slow_log = logging.getLogger("tidb_tpu_torch.slow_query")

# live sessions for SHOW PROCESSLIST and KILL (ref: util.SessionManager
# backing SHOW PROCESSLIST in the server package)
_SESSIONS: "weakref.WeakSet[Session]" = weakref.WeakSet()

# statement kinds subject to server admission control (sched.py): the
# ones that build executors and allocate scan/agg/join memory.
# Everything else (SET/SHOW/KILL/BEGIN/COMMIT/DDL...) always runs, so an
# operator can SET quotas, SHED and KILL a busy server out of trouble.
_ADMISSION_STMTS = (ast.SelectStmt, ast.UnionStmt, ast.InsertStmt,
                    ast.UpdateStmt, ast.DeleteStmt, ast.LoadDataStmt,
                    ast.AnalyzeStmt, ast.ExplainStmt, ast.ExecuteStmt,
                    ast.DoStmt, ast.TraceStmt)


def _needs_admission(stmt) -> bool:
    if isinstance(stmt, ast.ExplainStmt):
        # plain EXPLAIN only plans (the operator's diagnostic tool on a
        # busy server — must always answer); EXPLAIN ANALYZE executes
        return bool(getattr(stmt, "analyze", False))
    return isinstance(stmt, _ADMISSION_STMTS)


_session_seq = 0
_session_seq_lock = threading.Lock()


def processlist_snapshot() -> list[dict]:
    """Live sessions as plain dicts (the JSON-able twin of SHOW
    PROCESSLIST's rows)."""
    out = []
    now = time.time()
    with _session_seq_lock:   # adds are serialized with snapshot
        live = list(_SESSIONS)
    for s in sorted(live, key=lambda x: x.session_id):
        sql = s.current_sql
        tracker = getattr(s, "mem_tracker", None)
        rm = getattr(s, "res_meter", None)
        mtot = rm.totals() if rm is not None else {}
        out.append({
            "id": s.session_id,
            "user": s.user,
            "host": s.host,
            "db": s.current_db or None,
            "command": "Query" if sql else "Sleep",
            "time_s": int(now - s.created_at),
            "info": (sql or "")[:100] or None,
            "mem_bytes": tracker.total() if tracker is not None else 0,
            "device_ms": mtot.get("device_ns", 0) // 1_000_000,
            "rows_sent": mtot.get("rows_sent", 0),
        })
    return out

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
    handle, the grant cache, the plan cache, the DDL owner election and
    the schema and stats background workers (ref: domain.Reload,
    domain/domain.go:267). One per storage while a session of it lives:
    the registry holds the domains weakly, so a storage no session uses
    is freed with its domain."""

    _instances: "weakref.WeakValueDictionary[int, Domain]" = \
        weakref.WeakValueDictionary()
    _lock = threading.Lock()

    def __init__(self, storage):
        self.storage = storage
        self._schema: InfoSchema | None = None
        self._mu = threading.Lock()
        self._stats = None
        self._plan_cache = None
        self._priv = None
        self._ddl_owner = None
        self._schema_stop = None
        self._stats_stop = None

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

    def priv_cache(self):
        """Grant-table cache (ref: privilege/privileges/cache.go:104)."""
        if self._priv is None:
            from tidb_tpu_torch.privilege import PrivilegeCache
            self._priv = PrivilegeCache(self.storage)
        return self._priv

    # -- multi-server schema plane (ref: owner/manager.go election,
    # ddl/syncer.go version publication, domain/domain.go reload loop) -------

    SCHEMA_SYNC_PREFIX = b"m_schema_sync_"
    SCHEMA_LEASE_MS = 2000

    def ddl_owner(self):
        """This domain's DDL election participant (lazy singleton). Its
        id is the storage's, not a fresh one per Domain: the registry
        holds domains weakly, and a domain made anew for the same
        storage must renew its predecessor's lease, not wait it out."""
        with self._mu:
            if self._ddl_owner is None:
                from tidb_tpu_torch.owner import OwnerManager
                self._ddl_owner = OwnerManager(
                    self.storage, lease_ms=self.SCHEMA_LEASE_MS,
                    owner_id=f"{os.getpid():x}-{id(self.storage):x}")
            return self._ddl_owner

    def schema_worker_running(self) -> bool:
        return self._schema_stop is not None

    def publish_schema_version(self) -> None:
        """Advertise this server's loaded schema version (ref:
        ddl/syncer.go:58 UpdateSelfVersion): a lease-stamped sync record
        the DDL owner polls for convergence."""
        ver = self.info_schema().version
        key = self.SCHEMA_SYNC_PREFIX + self.ddl_owner().id.encode()
        import json as _json
        expiry = int(time.time() * 1000) + 2 * self.SCHEMA_LEASE_MS
        txn = self.storage.begin()
        try:
            txn.set(key, _json.dumps({"ver": ver,
                                      "expiry": expiry}).encode())
            txn.commit()
        except kv.KVError as e:
            # the record expires in 2x lease, so the owner would treat
            # this server as dead — say so rather than vanish silently
            logging.getLogger("tidb_tpu_torch.domain").warning(
                "schema version publish failed: %s", e)
            if getattr(txn, "valid", False):
                txn.rollback()

    def live_schema_versions(self) -> dict[str, int]:
        """Unexpired published versions by server id (ref: syncer.go
        OwnerCheckAllVersions reading etcd)."""
        import json as _json
        from tidb_tpu_torch import codec as _codec
        now = int(time.time() * 1000)
        out: dict[str, int] = {}
        snap = self.storage.snapshot(self.storage.current_ts())
        end = _codec.prefix_next(self.SCHEMA_SYNC_PREFIX)
        for k, v in snap.iter_range(self.SCHEMA_SYNC_PREFIX, end):
            try:
                o = _json.loads(v)
                if int(o["expiry"]) > now:
                    out[k[len(self.SCHEMA_SYNC_PREFIX):].decode()] = \
                        int(o["ver"])
            except (ValueError, KeyError):
                continue
        return out

    def wait_schema_convergence(self, target_ver: int,
                                timeout_ms: int | None = None) -> bool:
        """Block until every live server published >= target_ver, capped
        at 2x lease (dead servers expire out; ref: ddl_worker's
        waitSchemaChanged + 2*lease convergence rule, ddl/ddl.go)."""
        deadline = time.time() + (timeout_ms or
                                  2 * self.SCHEMA_LEASE_MS) / 1000.0
        me = self.ddl_owner().id
        while True:
            vers = self.live_schema_versions()
            lagging = [s for s, v in vers.items()
                       if s != me and v < target_ver]
            if not lagging:
                return True
            if time.time() >= deadline:
                return False
            time.sleep(0.02)

    def schema_worker_tick(self) -> None:
        """One maintenance beat: campaign for DDL ownership, drain the job
        queue when owner, reload + publish the schema version."""
        owner = self.ddl_owner()
        from tidb_tpu_torch.ddl.worker import DDLWorker
        worker = DDLWorker(self.storage)
        # re-campaign EVERY step: long drains (backfills, convergence
        # waits) must renew the lease or stop when ownership moves
        while owner.campaign():
            try:
                job = worker.run_one_step()
            except kv.RetryableError:
                break    # a competing stepper raced us: yield to it
            if job is None:
                break
            self.wait_schema_convergence(self.info_schema().version)
        self.publish_schema_version()

    def start_schema_worker(self, interval: float | None = None) -> None:
        """Background reload/election/DDL loop (ref: domain.go:320
        loadSchemaInLoop + ddl owner worker)."""
        with self._mu:
            if self._schema_stop is not None:
                return
            self._schema_stop = threading.Event()
            stop = self._schema_stop
        tick = interval if interval is not None \
            else self.SCHEMA_LEASE_MS / 2000.0
        # supervised (util/supervisor.py): a crashing tick is counted
        # in tidb_tpu_worker_restarts_total{worker="schema-worker"}
        # and backed off instead of silently swallowed
        from tidb_tpu_torch.util import supervisor
        supervisor.supervise("schema-worker", self.schema_worker_tick,
                             stop, tick)

    def stop_schema_worker(self) -> None:
        with self._mu:
            stop = self._schema_stop
            self._schema_stop = None
        if stop is not None:
            stop.set()

    # -- auto analyze (ref: statistics/handle.go auto-analyze +
    # RunAutoAnalyze wiring, tidb-server/main.go:341) -------------------------

    def auto_analyze_tick(self) -> list[int]:
        """Analyze every table whose DML delta crossed the ratio; returns
        the analyzed table ids. Called by the background stats worker and
        directly by tests."""
        from tidb_tpu_torch.statistics import analyze_table
        handle = self.stats_handle()
        done = []
        for tid in handle.pending_tables():
            located = self.info_schema().table_by_id(tid)
            if located is None:
                handle._deltas.pop(tid, None)   # dropped table
                continue
            _db, info = located
            try:
                stats = analyze_table(self.storage,
                                      self.storage.current_ts(), info)
                handle.save(stats)
                done.append(tid)
            except Exception:  # noqa: BLE001 - next tick retries
                continue
        return done

    def start_stats_worker(self, interval: float = 30.0) -> None:
        """Idempotent background auto-analyze loop."""
        with self._mu:
            if self._stats_stop is not None:
                return
            self._stats_stop = threading.Event()
            stop = self._stats_stop

        from tidb_tpu_torch.util import supervisor
        supervisor.supervise("stats-auto-analyze",
                             self.auto_analyze_tick, stop, interval)

    def stop_stats_worker(self) -> None:
        with self._mu:
            stop = self._stats_stop
            self._stats_stop = None
        if stop is not None:
            stop.set()

    def plan_cache(self):
        """Shared LRU of compiled SELECT plans keyed by (sql, db,
        schema version, stats version, plane generation) — ref:
        plan/cache.go + the kvcache-backed plan cache wired in
        tidb-server/main.go:349."""
        if self._plan_cache is None:
            from tidb_tpu_torch.util import LRUCache
            self._plan_cache = LRUCache(200)
        return self._plan_cache

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
        # internal sessions (bootstrap, the grant loader, the account
        # statements' catalog writes) bypass privilege checks and the
        # statement instrumentation — ref: ExecRestrictedSQL
        self.internal = internal
        self.txn: kv.Transaction | None = None
        self._history: list = []     # the open txn's DML, for a retry
        self.autocommit = True
        self.vars: dict[str, object] = {}
        self.sys_vars: dict[str, object] = {"autocommit": 1,
                                            "sql_mode": "STRICT_TRANS_TABLES"}
        self._prepared: dict = {}            # id/name -> _Prepared
        self._next_stmt_id = 0
        self._warnings: list = []
        self.last_stats: ExecStats | None = None
        self.last_collector = None
        self.last_mem = None
        self.last_mem_left = 0
        self.last_phases: dict[str, int] = {}
        self.mem_tracker = None
        self.res_meter = None
        with _session_seq_lock:
            _session_seq += 1
            self.session_id = _session_seq
            self.created_at = time.time()
            self.current_sql: str | None = None  # for SHOW PROCESSLIST
            self.killed = False           # KILL QUERY flag (cooperative)
            self.kill_hook = None         # the server's: closes the conn
            if not internal:
                _SESSIONS.add(self)
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

    def add_warning(self, level: str, code: int, message: str) -> None:
        """Append to the statement diagnostics area (read by SHOW
        WARNINGS/ERRORS, cleared at the start of the next statement).
        Ref: sessionctx stmtctx AppendWarning, statement.go."""
        self._warnings.append((level, code, message))

    def execute(self, sql: str):
        """Execute semicolon-separated statements; returns a list of
        ResultSet (queries) / int (affected rows) / None (commands)."""
        t0 = time.perf_counter_ns()
        stmts = parse(sql)
        parse_ns = (time.perf_counter_ns() - t0) // max(len(stmts), 1)
        single = sql if len(stmts) == 1 else None
        # auth statements never expose credentials in the processlist or
        # the slow log: the WHOLE batch text is redacted if any statement
        # in it carries one
        if any(isinstance(s, (ast.CreateUserStmt, ast.SetPasswordStmt))
               for s in stmts):
            sql = "<redacted: batch containing credentials>" \
                if len(stmts) > 1 else "<redacted: credential statement>"
        return [self._timed_stmt(stmt, parse_ns, sql, sql_text=single,
                                 batch_no=i if len(stmts) > 1 else None)
                for i, stmt in enumerate(stmts)]

    def query(self, sql: str) -> ResultSet:
        for r in self.execute(sql):
            if isinstance(r, ResultSet):
                return r
        raise SQLError("statement returned no result set")

    def plan(self, sql: str):
        """Plan a single SELECT and return the physical plan (no
        execution, no plan cache) — the programmatic EXPLAIN."""
        stmts = parse(sql)
        if len(stmts) != 1:
            raise SQLError("plan() takes a single statement")
        try:
            return self._planner().plan(stmts[0])
        except (PlanError, ResolveError) as e:
            raise SQLError(str(e)) from None

    def close(self):
        if not self.internal:
            perfschema.session_closed(self.session_id)
            self._mem_finalizer()
            self._meter_finalizer()
        if self.txn is not None:
            self.txn.rollback()
            self.txn = None

    # -- prepared statements (ref: session.go:777-855 PrepareStmt /
    # ExecutePreparedStmt; the binary protocol and SQL PREPARE share it) ----

    def prepare(self, sql: str, name: str | None = None):
        """-> (stmt_id, num_params). Parses once; EXECUTE binds the
        collected parameter markers in order."""
        stmts = parse(sql)
        if len(stmts) != 1:
            raise SQLError("can only prepare a single statement")
        markers = ast_params(stmts[0])
        self._next_stmt_id += 1
        sid = self._next_stmt_id
        p = _Prepared(stmt=stmts[0], markers=markers, sql=sql, sid=sid,
                      name=name.lower() if name else None)
        self._prepared[sid] = p
        if p.name is not None:
            self._prepared[p.name] = p
        return sid, len(markers)

    def _lookup_prepared(self, stmt_id):
        return self._prepared.get(stmt_id if not isinstance(stmt_id, str)
                                  else stmt_id.lower())

    def prepared_columns(self, stmt_id):
        """Result-column metadata of a prepared statement at PREPARE time,
        for the COM_STMT_PREPARE_OK response: the SELECT planned with its
        parameters bound to NULL (names and types come from the schema,
        not the values), memoized on the prepared statement.
        -> (names, field_types), or (None, None) for a statement without
        a result set or one that does not plan with unbound parameters."""
        p = self._lookup_prepared(stmt_id)
        if p is None:
            return (None, None)
        if p.columns_meta is not None:
            return p.columns_meta
        sel = p.stmt
        if isinstance(sel, ast.UnionStmt):
            sel = sel.selects[0]     # UNION metadata = first branch's
        if not isinstance(sel, ast.SelectStmt):
            return (None, None)
        saved = [(m.value, m.bound) for m in p.markers]
        try:
            for m in p.markers:
                m.value, m.bound = None, True
            plan = self._planner().plan(sel)
            p.columns_meta = ([c.name for c in plan.schema.cols],
                              [c.ft for c in plan.schema.cols])
            return p.columns_meta
        except Exception:
            return (None, None)
        finally:
            for m, (v, b) in zip(p.markers, saved):
                m.value, m.bound = v, b

    def execute_prepared(self, stmt_id, params=()):
        p = self._lookup_prepared(stmt_id)
        if p is None:
            raise SQLError(f"unknown prepared statement {stmt_id!r}")
        if len(params) != len(p.markers):
            raise SQLError(f"expected {len(p.markers)} parameters, "
                           f"got {len(params)}")
        for m, v in zip(p.markers, params):
            m.value = v
            m.bound = True
        if self.current_sql is not None:
            # SQL-level EXECUTE: already inside this statement's
            # _timed_stmt frame — don't double-record
            return self._run_stmt(p.stmt)
        # binary-protocol COM_STMT_EXECUTE: full instrumentation, parse
        # cost paid at prepare time
        return self._timed_stmt(p.stmt, 0, p.sql, sql_text=None)

    def deallocate_prepared(self, stmt_id) -> None:
        key = stmt_id.lower() if isinstance(stmt_id, str) else stmt_id
        p = self._prepared.pop(key, None)
        if p is not None:   # drop BOTH registrations
            self._prepared.pop(p.sid, None)
            if p.name is not None:
                self._prepared.pop(p.name, None)

    # -- statement lifecycle -------------------------------------------------

    def _timed_stmt(self, stmt, parse_ns: int, sql: str,
                    sql_text: str | None = None,
                    batch_no: int | None = None):
        """One statement as the reference's adapter runs it
        (executor/adapter.go:189, slow log :353): processlist state, a
        perfschema event, admission, the session's sysvars as the config
        overlay, a memtrack statement root with the quota and the KILL
        probe, a statement meter, a trace root whose phase spans give
        `last_phases`, then the digest record, the duration and memory
        metrics and the slow-query log. Internal sessions skip all of it:
        their catalog reads are not client statements."""
        self.killed = False   # a kill that landed while idle is a no-op
        self.last_stats = None
        self.last_collector = None
        self.last_phases = {"parse": parse_ns}
        if self.internal:
            token = trace.detach()
            try:
                with rs.suspended(), memtrack.suspended(), \
                        meter.suspended():
                    return self._run_stmt(stmt, sql_text=sql_text)
            finally:
                trace.restore(token)
        self.current_sql = sql
        stmt_start = time.perf_counter()
        # each statement resets the diagnostics area, except the SHOWs
        # that read it (MySQL: SHOW WARNINGS does not clear warnings)
        if not (isinstance(stmt, ast.ShowStmt)
                and getattr(stmt, "tp", None) in ("warnings", "errors")):
            self._warnings = []
        overlay = {k: v for k, v in self.sys_vars.items()
                   if config.is_known(k)}
        kind = type(stmt).__name__.removesuffix("Stmt").lower()
        ev = perfschema.stmt_begin(self.session_id, sql)
        # the sampling decision happens at begin: under the overlay, so
        # a session-scope SET tidb_tpu_trace_sample is honored
        if overlay:
            with config.session_overlay(overlay):
                root = trace.begin("statement", type=kind)
        else:
            root = trace.begin("statement", type=kind)
        if isinstance(stmt, ast.TraceStmt):
            # TRACE forces retention; _exec_trace reads the live tree
            root.forced = True
        # parse happened batch-wide before dispatch: record this
        # statement's share as a pre-closed phase span, and back-date the
        # root so its duration covers it
        pspan = trace.Span("parse")
        pspan.start_ns = root.start_ns - parse_ns
        pspan.end_ns = root.start_ns
        root.start_ns = pspan.start_ns
        root.children.append(pspan)
        quota_cancel: list[str] = []

        def _on_quota_cancel(msg: str) -> None:
            quota_cancel.append(msg)
            self.killed = True

        mt = memtrack.statement_root(self.mem_tracker,
                                     on_cancel=_on_quota_cancel,
                                     label=f"stmt-{self.session_id}")
        # KILL QUERY reaches the coprocessor's pool workers and the
        # device pipeline through the statement root they carry
        mt.interrupted = lambda: self.killed
        self.last_mem = mt
        # server admission (sched.py): executable statements check their
        # projected footprint (this digest's recorded peak) against
        # tidb_tpu_server_mem_quota BEFORE running — shed / queue /
        # retryable reject here instead of a mid-statement OOM cancel.
        # Control statements always run.
        adm = sched.admission()
        ticket = None
        sm = meter.statement_meter(self.res_meter)
        res = None
        err: str | None = None
        slow_ms = config.slow_query_ms()
        trace_on = slow_trace = None
        self._last_plan = None
        try:
            with config.session_overlay(overlay), meter.metering(sm):
                mt.quota = config.mem_quota_query()   # session-shadowed
                # the session-shadowed slow-log and trace knobs, read
                # while the overlay is installed
                slow_ms = config.slow_query_ms()
                trace_on = config.trace_log()
                slow_trace = config.slow_trace_ms()
                try:
                    if _needs_admission(stmt):
                        with trace.span("admission"):
                            ticket = adm.admit(
                                projected=perfschema.digest_max_mem(sql),
                                label=f"session-{self.session_id}")
                    with memtrack.tracking(mt):
                        res = self._run_stmt(stmt, sql_text=sql_text)
                except memtrack.QuotaExceededError as e:
                    # OOM cancel: the statement dies with
                    # ER_MEM_EXCEED_QUOTA, the transaction rolls back,
                    # the session survives
                    self._rollback()
                    raise SQLError(str(e)) from None
                except Exception as e:
                    if quota_cancel and "interrupted" in str(e).lower():
                        # the cancel fired on a fan-out worker: surface
                        # the quota error, not the generic interrupt
                        self._rollback()
                        raise SQLError(quota_cancel[0]) from None
                    raise
        except Exception as e:
            metrics.counter(metrics.QUERY_ERRORS)
            err = str(e)
            raise
        finally:
            trace.end(root)
            dur = time.perf_counter() - stmt_start
            for name in ("plan", "execute"):
                self.last_phases[name] = trace.phase_ns(root, name)
            metrics.gauge(metrics.QUERY_MEM, mt.host_peak, {"kind": "host"})
            metrics.gauge(metrics.QUERY_MEM, mt.device_peak,
                          {"kind": "device"})
            metrics.gauge(metrics.DEVICE_PEAK, rs.device_watermark())
            metrics.counter(metrics.QUERIES_TOTAL, {"type": kind})
            metrics.histogram(metrics.QUERY_DURATIONS, dur)
            nrows = len(res.rows) if isinstance(res, ResultSet) else \
                (res if isinstance(res, int) else 0)
            perfschema.stmt_end(ev, root=root, rows=nrows, error=err)
            coll = self.last_collector
            ops = [o.to_dict() for o in coll.ops()] \
                if coll is not None else []
            phases = {"parse": trace.phase_ns(root, "parse"),
                      "plan": trace.phase_ns(root, "plan"),
                      "exec": trace.phase_ns(root, "execute"),
                      "commit": trace.phase_ns(root, "commit")}
            # sampled, slow and TRACE-forced trees retain into the trace
            # ring; the id links the digest summary and the slow log to
            # the timeline
            trace_id = trace.finish_statement(root, sql, error=err,
                                              slow_ms=slow_trace)
            digest, norm = perfschema.digest_record(
                sql, int(dur * 1e9), phases=phases, rows=nrows,
                error=err, op_stats=ops,
                mem_bytes=mt.host_peak + mt.device_peak,
                tag=None if batch_no is None
                else f"stmt#{batch_no}:{kind}", trace_id=trace_id)
            if config.kernel_profile():
                perfschema.memo_record(digest, [o for o in ops
                                                if o["mode"]])
            sm.add(rows_sent=nrows, statements=1)
            meter.finish_statement(sm, digest, norm)
            if coll is not None:
                for o in coll.ops():
                    if not o.loops:
                        continue   # never produced (cached sub-plan)
                    metrics.histogram(metrics.OP_DURATIONS,
                                      o.time_ns / 1e9, {"op": o.name})
                    metrics.counter(metrics.OP_ROWS, {"op": o.name},
                                    inc=o.act_rows)
                    if o.device_time_ns:
                        metrics.histogram(metrics.OP_DEVICE_DURATIONS,
                                          o.device_time_ns / 1e9,
                                          {"op": o.name})
                    if o.superchunks:
                        metrics.counter(metrics.SUPERCHUNKS, {"op": o.name},
                                        inc=o.superchunks)
                        metrics.counter(metrics.SUPERCHUNK_SOURCES,
                                        {"op": o.name},
                                        inc=o.coalesced_chunks)
                        metrics.counter(metrics.SUPERCHUNK_FILL_ROWS,
                                        {"op": o.name},
                                        inc=o.superchunk_fill_rows)
                        metrics.counter(metrics.SUPERCHUNK_BUCKET_ROWS,
                                        {"op": o.name},
                                        inc=o.superchunk_bucket_rows)
                    if o.pipeline_stall_ns:
                        metrics.histogram(metrics.PIPELINE_STALLS,
                                          o.pipeline_stall_ns / 1e9,
                                          {"op": o.name})
            if trace_on:
                trace.log_tree(root, sql)
            if dur * 1000 >= slow_ms:
                metrics.counter(metrics.SLOW_QUERIES)
                slow_log.warning("%s", self._slow_log_record(
                    sql, dur, digest, ops, err, mt, trace_id=trace_id))
            # the collector outlives the statement on the session: it
            # must not pin the executed plan and operator trees
            self._last_plan = None
            if coll is not None:
                coll.seal()
            # release-on-close: credit everything still held back to the
            # session root; the peaks stay readable on last_mem
            self.last_mem_left = mt.total()
            if self.last_stats is not None:
                self.last_stats.mem_left = mt.total()
                self.last_stats.mem_peak = mt.total_peak
                self.last_stats.mem_device_at_peak = mt.device_at_peak
                self.last_stats.fault_degraded = mt.fault_degraded
            mt.detach()
            adm.finish(ticket)
            self.killed = False
            self.current_sql = None
        return res

    def _slow_log_record(self, sql: str, dur: float, digest: str,
                         ops: list, err: str | None, mem,
                         trace_id: int | None = None) -> str:
        """Structured slow-log record: digest, the retained trace's id,
        memory peaks and the operators' rows, loops and times ride with
        the SQL (ref: the multi-line slow log, executor/adapter.go:353)."""
        lines = [f"slow query: {dur:.3f}s user={self.user} "
                 f"db={self.current_db} digest={digest}"
                 + (" error=1" if err else "")]
        if trace_id is not None:
            lines.append(f"# Trace_id: {trace_id}")
        lines.append(
            f"# Mem: {rs.fmt_bytes(mem.host_peak + mem.device_peak)}"
            f" host={rs.fmt_bytes(mem.host_peak)}"
            f" device={rs.fmt_bytes(mem.device_peak)}")
        plan = self._last_plan
        if plan is not None:
            try:
                for ln in plan.explain().split("\n"):
                    lines.append("# Plan: " + ln)
            except Exception:  # noqa: BLE001 - logging must not fail stmts
                pass
        for o in ops:
            if not o["loops"] and not o["time_ns"]:
                continue
            ln = (f"# Op: {o['name']} act_rows={o['act_rows']} "
                  f"loops={o['loops']} time={rs.fmt_ns(o['time_ns'])}")
            if o["device_time_ns"]:
                ln += f" device_time={rs.fmt_ns(o['device_time_ns'])}"
            if o["cop_tasks"]:
                ln += f" cop_tasks={o['cop_tasks']}"
            if o["mode"]:
                ln += f" mode={o['mode']}"
            lines.append(ln)
        lines.append("# SQL: " + sql[:2048])
        return "\n".join(lines)

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

    def _run_stmt(self, stmt: ast.StmtNode, sql_text: str | None = None):
        self._check_privileges(stmt)
        if isinstance(stmt, (ast.CreateUserStmt, ast.DropUserStmt,
                             ast.GrantStmt, ast.RevokeStmt,
                             ast.SetPasswordStmt)):
            return self._exec_account(stmt)
        if isinstance(stmt, (ast.SelectStmt, ast.UnionStmt)):
            stmt, folded = self._fold_session_exprs(stmt)
            return self._exec_query(
                stmt, sql_text=None if folded else sql_text)
        if isinstance(stmt, ast.PrepareStmt):
            text = stmt.sql
            if stmt.from_var is not None:
                text = self.vars.get(stmt.from_var.lower())
                if not isinstance(text, str):
                    raise SQLError(
                        f"variable {stmt.from_var} does not hold a "
                        "statement text")
            self.prepare(text, name=stmt.name)
            return None
        if isinstance(stmt, ast.ExecuteStmt):
            # user variable names are case-insensitive in MySQL
            params = [self.vars.get(v.lower()) for v in stmt.using]
            return self.execute_prepared(stmt.name, params)
        if isinstance(stmt, ast.DeallocateStmt):
            self.deallocate_prepared(stmt.name)
            return None
        if isinstance(stmt, (ast.InsertStmt, ast.UpdateStmt,
                             ast.DeleteStmt, ast.LoadDataStmt)):
            stmt, _ = self._fold_session_exprs(stmt)
            return self._exec_dml(stmt)
        if isinstance(stmt, ast.SplitTableStmt):
            return self._exec_split_table(stmt)
        if isinstance(stmt, ast.TraceStmt):
            return self._exec_trace(stmt)
        if isinstance(stmt, ast.KillStmt):
            return self._exec_kill(stmt)
        if isinstance(stmt, ast.DoStmt):
            # evaluate for side effects/errors, discard results (ref:
            # executor/simple.go DoStmt)
            stmt, _ = self._fold_session_exprs(stmt)  # @v / @v := ...
            r = Resolver(PlanSchema([]))
            for e in stmt.exprs:
                try:
                    r.resolve(e).eval_xp(np, [], 1)
                except (ResolveError, PlanError) as err:
                    raise SQLError(str(err)) from None
            return None
        if isinstance(stmt, ast.FlushStmt):
            if stmt.tp == "privileges":
                # re-read the grant tables (ref: executeFlush ->
                # LoadPrivilegeLoop notify)
                self.domain.priv_cache().invalidate()
            elif stmt.tp not in ("status", "tables"):
                raise SQLError(f"unsupported FLUSH {stmt.tp}")
            return None
        if isinstance(stmt, ast.CreateViewStmt):
            raise SQLError("CREATE VIEW is not supported")
        if isinstance(stmt, ast.DropViewStmt):
            if not stmt.if_exists:
                names = ", ".join(t.name for t in stmt.tables)
                raise SQLError(f"Unknown view '{names}'")
            return None     # IF EXISTS: nothing to drop, by construction
        if isinstance(stmt, ast.DropStatsStmt):
            db = stmt.table.db or self.current_db
            try:
                info = self.domain.info_schema().table(db, stmt.table.name)
            except SchemaError as e:
                raise SQLError(str(e)) from None
            self.domain.stats_handle().drop(info.id)
            return None
        if isinstance(stmt, _DDL_STMTS):
            if self.txn is not None:
                self._commit()  # implicit commit before DDL (MySQL)
            if isinstance(stmt, ast.DropTableStmt) and stmt.if_exists:
                ischema = self.domain.info_schema()
                for t in stmt.tables:
                    db = t.db or self.current_db
                    if not ischema.has_table(db, t.name):
                        # MySQL: one Note per missing IF EXISTS target
                        self.add_warning(
                            "Note", errcode.ER_BAD_TABLE_ERROR,
                            f"Unknown table '{db}.{t.name}'")
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
            if stmt.db.lower() not in ("information_schema",
                                       "performance_schema") and \
                    not ischema.has_db(stmt.db):
                raise SQLError(f"Unknown database '{stmt.db}'")
            self.current_db = stmt.db
            return None
        if isinstance(stmt, ast.SetStmt):
            return self._exec_set(stmt)
        if isinstance(stmt, ast.ShowStmt):
            return self._exec_show(stmt)
        if isinstance(stmt, ast.ExplainStmt):
            return self._exec_explain(stmt)
        if isinstance(stmt, ast.AnalyzeStmt):
            return self._exec_analyze(stmt)
        if isinstance(stmt, ast.AdminStmt):
            return self._exec_admin(stmt)
        raise SQLError(f"unsupported statement {type(stmt).__name__}")

    # -- ADMIN (ref: util/admin/admin.go:42 GetDDLInfo, :231
    # CheckRecordAndIndex / CheckIndicesCount) -------------------------------

    def _exec_admin(self, stmt: ast.AdminStmt) -> ResultSet:
        if stmt.tp == "show_ddl":
            txn = self.storage.begin()
            try:
                m = Meta(txn)
                ver = m.schema_version()
            finally:
                txn.rollback()
            return ResultSet(["SCHEMA_VER", "OWNER", "SELF_ID"],
                             [(ver, "self", "self")])
        if stmt.tp == "show_ddl_jobs":
            # queue front-to-back, then recent history (ref: the ADMIN
            # SHOW DDL JOBS surface over meta's job queue/history)
            from tidb_tpu_torch.ddl.job import Job
            txn = self.storage.begin()
            try:
                m = Meta(txn)
                rows = []
                for raw in m.t.litems(Meta.JOB_LIST_KEY):
                    j = Job.loads(raw)
                    rows.append((j.id, j.tp.value, j.schema_id,
                                 j.table_id, j.state.value,
                                 int(j.schema_state), "queue"))
                hist = m.t.hgetall(Meta.JOB_HISTORY_KEY)
                for _f, raw in sorted(hist, reverse=True)[:16]:
                    j = Job.loads(raw)
                    rows.append((j.id, j.tp.value, j.schema_id,
                                 j.table_id, j.state.value,
                                 int(j.schema_state), "history"))
            finally:
                txn.rollback()
            return ResultSet(["JOB_ID", "JOB_TYPE", "SCHEMA_ID",
                              "TABLE_ID", "STATE", "SCHEMA_STATE",
                              "SOURCE"], rows)
        if stmt.tp == "cancel_ddl_jobs":
            # flip still-QUEUEING jobs to CANCELLED in the meta queue
            # (ref: admin.CancelJobs — running jobs can't be cancelled
            # here; the single transition already commits atomically)
            from tidb_tpu_torch.ddl.job import Job, JobState
            rows = []
            txn = self.storage.begin()
            try:
                m = Meta(txn)
                items = list(m.t.litems(Meta.JOB_LIST_KEY))
                for jid in stmt.job_ids:
                    found = False
                    for pos, raw in enumerate(items):
                        j = Job.loads(raw)
                        if j.id != jid:
                            continue
                        found = True
                        if j.state == JobState.QUEUEING:
                            j.state = JobState.CANCELLED
                            m.t.lset(Meta.JOB_LIST_KEY, pos, j.dumps())
                            rows.append((jid, "cancelled"))
                        else:
                            rows.append((jid, f"cannot cancel: "
                                              f"{j.state.value}"))
                        break
                    if not found:
                        rows.append((jid, "not found"))
                txn.commit()
            except Exception:
                txn.rollback()
                raise
            return ResultSet(["JOB_ID", "RESULT"], rows)
        if stmt.tp != "check_table":
            return ResultSet(columns=["info"], rows=[])
        from tidb_tpu_torch import codec as _codec
        from tidb_tpu_torch.schema.model import SchemaState
        snap = self.storage.snapshot(self.storage.current_ts())
        for ts in stmt.tables:
            info = self._resolve_table(ts)
            lo, hi = tablecodec.table_prefix_range(info.id)
            rp = tablecodec.record_prefix(info.id)
            rows: dict[int, dict] = {}            # handle -> {col_id: datum}
            actual: dict[int, set] = {}           # idx_id -> {(key, value)}
            for k, v in snap.iter_range(lo, hi):
                if k.startswith(rp):
                    h = tablecodec.decode_record_key(k)[1]
                    rows[h] = tablecodec.decode_row(v)
                    continue
                try:
                    _tid, iid, _suffix = tablecodec.decode_index_key(k)
                except ValueError:
                    continue
                actual.setdefault(iid, set()).add((k, v))
            for idx in info.indexes:
                if idx.state != SchemaState.PUBLIC:
                    continue
                # expected entries recomputed from the ROW VALUES, so
                # stale-value index corruption is caught, not just
                # count/handle drift (ref: admin.go CheckRecordAndIndex)
                expect: set = set()
                col_ids = [info.col_by_name(c).id for c in idx.columns]
                for h, rowvals in rows.items():
                    vals = [rowvals.get(cid) for cid in col_ids]
                    if idx.unique and all(x is not None for x in vals):
                        expect.add((
                            tablecodec.index_key(info.id, idx.id, vals),
                            _codec.encode_int(h)))
                    else:
                        expect.add((
                            tablecodec.index_key(info.id, idx.id, vals,
                                                 handle=h), b"0"))
                got = actual.get(idx.id, set())
                if got != expect:
                    missing = len(expect - got)
                    extra = len(got - expect)
                    raise SQLError(
                        f"admin check table {info.name} index "
                        f"{idx.name}: {missing} missing and {extra} "
                        f"unexpected index entries")
        return ResultSet(columns=["info"],
                         rows=[("check passed",)])

    # -- privileges (ref: privilege/privileges/privileges.go:56
    # RequestVerification, wired at plan time via visitInfo in the
    # reference's optimizer, plan/optimizer.go:73-77) ------------------------

    def _check_privileges(self, stmt) -> None:
        if self.internal:
            return
        from tidb_tpu_torch.privilege import Priv
        ischema = self.domain.info_schema()
        if not ischema.has_db("mysql"):
            return   # bootstrap-less library mode: no grant tables yet
        cache = self.domain.priv_cache()

        def deny(what: str):
            raise SQLError(
                f"{what} command denied to user '{self.user}'@"
                f"'{self.host}'")

        def need(db: str, table: str, want: int, what: str):
            if not cache.request_verification(self.user, self.host,
                                              (db or "").lower(),
                                              (table or "").lower(), want):
                deny(what)

        if isinstance(stmt, (ast.CreateUserStmt, ast.DropUserStmt)):
            need("", "", Priv.CREATE_USER, "CREATE USER")
            return
        if isinstance(stmt, ast.SetPasswordStmt):
            # SET PASSWORD without FOR changes the session's own matched
            # account; ANY FOR form needs CREATE USER (stricter than
            # MySQL's current_user() carve-out, never laxer: a
            # same-username different-host account is a DIFFERENT
            # account)
            if stmt.user is not None:
                need("", "", Priv.CREATE_USER, "SET PASSWORD")
            return
        if isinstance(stmt, (ast.GrantStmt, ast.RevokeStmt)):
            # GRANT at the statement's own scope suffices (MySQL: you
            # may grant onward anything you hold WITH GRANT OPTION at
            # that scope; the hierarchy check handles global > db)
            gdb = "" if stmt.db == "*" else \
                (stmt.db or self.current_db or "").lower()
            gtbl = "" if stmt.table == "*" else (stmt.table or "").lower()
            need(gdb, gtbl, Priv.GRANT, "GRANT")
            return
        if isinstance(stmt, (ast.SelectStmt, ast.UnionStmt,
                             ast.AnalyzeStmt)):
            for db, tbl in _referenced_tables(stmt):
                db = (db or self.current_db or "").lower()
                if db in ("information_schema", "performance_schema"):
                    continue   # catalog metadata is world-readable
                need(db, tbl, Priv.SELECT, "SELECT")
            return
        if isinstance(stmt, ast.SplitTableStmt):
            need("", "", Priv.SUPER, "SPLIT TABLE")
            return
        if isinstance(stmt, ast.KillStmt):
            return   # target resolved ONCE in _exec_kill (no TOCTOU)
        if isinstance(stmt, ast.LoadDataStmt) and not stmt.local:
            # server-side file read: gated like MySQL's global FILE priv
            # (SUPER here) so table INSERT alone can't read server files
            need("", "", Priv.SUPER, "LOAD DATA INFILE (FILE)")
        if isinstance(stmt, ast.DeleteStmt) and stmt.targets:
            # multi-table DELETE: DELETE on every target, SELECT on
            # every table read by the join
            def _tdb(ts):
                return ((ts.db or self.current_db) or "").lower()
            for ts in stmt.targets:
                need(_tdb(ts), ts.name.lower(), Priv.DELETE, "DELETE")

            # the generic walker covers the join tree, ON-clause
            # subqueries, and WHERE subqueries alike
            for db, tbl in _referenced_tables([stmt.refs, stmt.where]):
                need(db or self.current_db, tbl, Priv.SELECT, "SELECT")
            return
        if isinstance(stmt, ast.UpdateStmt) and \
                not isinstance(stmt.table, ast.TableSource):
            # multi-table UPDATE: UPDATE+SELECT on every joined table
            # (conservative superset of MySQL's assigned-only UPDATE),
            # SELECT on tables read by WHERE/SET subqueries
            for db, tbl in _referenced_tables([stmt.table]):
                need(db or self.current_db, tbl, Priv.UPDATE, "UPDATE")
                need(db or self.current_db, tbl, Priv.SELECT, "SELECT")
            for db, tbl in _referenced_tables(
                    [stmt.where, stmt.assignments]):
                need(db or self.current_db, tbl, Priv.SELECT, "SELECT")
            return
        if isinstance(stmt, (ast.InsertStmt, ast.UpdateStmt,
                             ast.DeleteStmt, ast.LoadDataStmt)):
            want, what = {
                ast.InsertStmt: (Priv.INSERT, "INSERT"),
                ast.UpdateStmt: (Priv.UPDATE, "UPDATE"),
                ast.DeleteStmt: (Priv.DELETE, "DELETE"),
                ast.LoadDataStmt: (Priv.INSERT, "LOAD DATA"),
            }[type(stmt)]
            target = stmt.table
            tdb = (((target.db or self.current_db) or "") if
                   isinstance(target, ast.TableSource) else
                   (self.current_db or ""))
            tname = (target.name.lower()
                     if isinstance(target, ast.TableSource) else "")
            need(tdb, tname, want, what)
            # reading columns needs SELECT: a WHERE on the target (MySQL
            # checks column reads; a bare UPDATE t SET a=1 needs none)
            if getattr(stmt, "where", None) is not None:
                need(tdb, tname, Priv.SELECT, "SELECT")
            # every table in a READ position needs SELECT — the target
            # included when subqueries in WHERE / SET / VALUES / ON
            # DUPLICATE or an INSERT ... SELECT source read from it
            read_positions = [getattr(stmt, "where", None),
                              getattr(stmt, "select", None),
                              getattr(stmt, "values", None),
                              getattr(stmt, "assignments", None),
                              getattr(stmt, "on_duplicate", None)]
            for db, tbl in _referenced_tables(read_positions):
                need(db or self.current_db, tbl, Priv.SELECT, "SELECT")
            return
        if isinstance(stmt, ast.SetStmt):
            if any(getattr(a, "is_global", False)
                   for a in stmt.assignments):
                # only GLOBAL mutates shared state; session-scope SET of
                # registry variables shadows per session and is free
                need("", "", Priv.SUPER, "SUPER (SET GLOBAL)")
            return
        if isinstance(stmt, (ast.CreateDatabaseStmt, ast.DropDatabaseStmt)):
            # check against the TARGET database, not the session's current
            want = Priv.CREATE if isinstance(stmt, ast.CreateDatabaseStmt) \
                else Priv.DROP
            need(stmt.name, "", want, "DDL")
            return
        ddl_privs = {ast.CreateTableStmt: Priv.CREATE,
                     ast.CreateIndexStmt: Priv.INDEX,
                     ast.DropTableStmt: Priv.DROP,
                     ast.DropIndexStmt: Priv.INDEX,
                     ast.AlterTableStmt: Priv.ALTER,
                     ast.TruncateTableStmt: Priv.DROP,
                     ast.RenameTableStmt: Priv.ALTER}
        want = ddl_privs.get(type(stmt))
        if want is not None:
            for db, tbl in _referenced_tables(stmt) or [("", "")]:
                need(db or self.current_db, tbl, want, "DDL")
        # SHOW / SET / EXPLAIN / txn control / prepared mgmt: unchecked
        # (EXPLAIN checks happen when the prepared/inner stmt runs)

    # -- account management (ref: executor/grant.go, executor/simple.go
    # CREATE USER / DROP USER) ------------------------------------------------

    def _account_session(self) -> "Session":
        return Session(self.storage, db="mysql", internal=True)

    def _exec_account(self, stmt):
        from tidb_tpu_torch.privilege import PRIV_BY_NAME, encode_password
        s = self._account_session()
        try:
            if isinstance(stmt, ast.SetPasswordStmt):
                if stmt.user is not None:
                    user, host = stmt.user.user, stmt.user.host
                else:
                    # own account: the MOST SPECIFIC stored row whose
                    # host pattern matches this session (CURRENT_USER()
                    # semantics: exact host beats patterns beats '%')
                    from tidb_tpu_torch.privilege import _host_match
                    user = self.user or ""
                    my_host = self.host or ""
                    candidates = [
                        h for (h,) in s.query(
                            "SELECT host FROM mysql.user WHERE user = "
                            f"'{_q(user)}'").rows
                        if _host_match(h, my_host)]
                    if not candidates:
                        raise SQLError(
                            f"no account matches '{user}'@'{my_host}'")
                    candidates.sort(
                        key=lambda h: (h != my_host, h == "%",
                                       -len(h)))
                    host = candidates[0]
                if not s.query("SELECT user FROM mysql.user WHERE user ="
                               f" '{_q(user)}' AND host = '{_q(host)}'"
                               ).rows:
                    raise SQLError(
                        f"user '{user}'@'{host}' does not exist")
                auth = encode_password(stmt.password)
                s.execute("UPDATE mysql.user SET authentication_string ="
                          f" '{auth}' WHERE user = '{_q(user)}' AND "
                          f"host = '{_q(host)}'")
            elif isinstance(stmt, ast.CreateUserStmt):
                for u in stmt.users:
                    exists = s.query(
                        "SELECT user FROM mysql.user WHERE user = "
                        f"'{_q(u.user)}' AND host = '{_q(u.host)}'").rows
                    if exists:
                        if stmt.if_not_exists:
                            continue
                        raise SQLError(f"user '{u.user}'@'{u.host}' "
                                       "already exists")
                    auth = encode_password(u.password or "")
                    s.execute("INSERT INTO mysql.user VALUES "
                              f"('{_q(u.host)}', '{_q(u.user)}', "
                              f"'{auth}', 0)")
            elif isinstance(stmt, ast.DropUserStmt):
                for u in stmt.users:
                    exists = s.query(
                        "SELECT user FROM mysql.user WHERE user = "
                        f"'{_q(u.user)}' AND host = '{_q(u.host)}'").rows
                    if not exists and not stmt.if_exists:
                        raise SQLError(f"user '{u.user}'@'{u.host}' "
                                       "does not exist")
                    cond = (f"user = '{_q(u.user)}' AND "
                            f"host = '{_q(u.host)}'")
                    s.execute(f"DELETE FROM mysql.user WHERE {cond}")
                    s.execute(f"DELETE FROM mysql.db WHERE {cond}")
                    s.execute(
                        f"DELETE FROM mysql.tables_priv WHERE {cond}")
            else:
                is_grant = isinstance(stmt, ast.GrantStmt)
                bits = 0
                for p in stmt.privs:
                    bits |= PRIV_BY_NAME[p]
                db = stmt.db if stmt.db != "" else self.current_db
                if not db:
                    raise SQLError("No database selected")
                for u in stmt.users:
                    if not s.query(
                            "SELECT user FROM mysql.user WHERE user = "
                            f"'{_q(u.user)}' AND host = "
                            f"'{_q(u.host)}'").rows:
                        raise SQLError(
                            f"user '{u.user}'@'{u.host}' does not exist")
                    self._apply_grant(s, u, db.lower(), stmt.table.lower(),
                                      bits, is_grant)
        finally:
            s.close()
            # ALWAYS invalidate: a mid-loop error may follow committed
            # writes (autocommit per internal statement)
            self.domain.priv_cache().invalidate()
        return None

    @staticmethod
    def _apply_grant(s: "Session", u, db: str, table: str, bits: int,
                     is_grant: bool) -> None:
        cond = f"user = '{_q(u.user)}' AND host = '{_q(u.host)}'"
        if db == "*":                     # global level -> mysql.user
            tbl, cond2, ins = "mysql.user", cond, None
        elif table == "*":                # db level -> mysql.db
            tbl = "mysql.db"
            cond2 = cond + f" AND db = '{_q(db)}'"
            ins = (f"INSERT INTO mysql.db VALUES ('{_q(u.host)}', "
                   f"'{_q(u.user)}', '{_q(db)}', {{privs}})")
        else:                             # table level -> mysql.tables_priv
            tbl = "mysql.tables_priv"
            cond2 = cond + (f" AND db = '{_q(db)}' AND table_name = "
                            f"'{_q(table)}'")
            ins = (f"INSERT INTO mysql.tables_priv VALUES ('{_q(u.host)}',"
                   f" '{_q(u.user)}', '{_q(db)}', '{_q(table)}', "
                   "{privs}")
            ins += ")"
        rows = s.query(f"SELECT privs FROM {tbl} WHERE {cond2}").rows
        cur = int(rows[0][0]) if rows else 0
        new = (cur | bits) if is_grant else (cur & ~bits)
        if rows:
            if new == cur:
                return
            if new == 0 and tbl != "mysql.user":
                s.execute(f"DELETE FROM {tbl} WHERE {cond2}")
            else:
                s.execute(f"UPDATE {tbl} SET privs = {new} WHERE {cond2}")
        elif is_grant and ins is not None:
            s.execute(ins.format(privs=new))

    def _planner(self) -> Planner:
        return Planner(self.domain.info_schema(), self.current_db,
                       stats_handle=self.domain.stats_handle(),
                       storage=self.storage)

    def _plan(self, stmt):
        with trace.span("plan", cached=False):
            planner = self._planner()
            try:
                plan = planner.plan(stmt)
            except (PlanError, ResolveError, SchemaError) as e:
                raise SQLError(str(e)) from None
            # degraded-but-answered notes (cluster_* fan-out with an
            # unreachable member) surface via SHOW WARNINGS; the cluster
            # memtables are cacheable=False, so a cache hit can never
            # skip a fan-out that would have warned
            for w in planner.warnings:
                self.add_warning(*w)
            return plan

    def _context(self, read_ts: int, txn=None) -> ExecContext:
        return ExecContext(self.storage.device, storage=self.storage,
                           read_ts=read_ts, txn=txn,
                           interrupted=lambda: self.killed)

    def _stats_collector(self):
        """The statement's runtime-stats collector: EXPLAIN ANALYZE's
        when it installed one, else a fresh one (timing the device under
        tidb_tpu_runtime_stats_device); None with tidb_tpu_runtime_stats
        = 0 or for an internal session."""
        if self.internal:
            return None
        active = rs.current()
        if active is not None:
            return active
        if not config.runtime_stats_enabled():
            return None
        return rs.StatsCollector(device=config.runtime_stats_device())

    def _exec_query(self, stmt, sql_text: str | None = None) -> ResultSet:
        if getattr(stmt, "for_update", False) and self.txn is None and \
                not self.autocommit:
            # autocommit=0: the SELECT starts the transaction, so its
            # locks hold until COMMIT (MySQL)
            self._begin_txn()
        plan = None
        cache_key = None
        if sql_text is not None:
            # the plan cache (ref: plan/cache.go): a single-statement
            # SELECT's text under this database, schema, stats and
            # device plane (a plan routed onto one plane never outlives
            # a topology change)
            from tidb_tpu_torch import devplane
            cache_key = (sql_text, self.current_db,
                         self.domain.info_schema().version,
                         self.domain.stats_handle().version,
                         devplane.mesh_generation())
            plan = self.domain.plan_cache().get(cache_key)
        if plan is None:
            plan = self._plan(stmt)
            if cache_key is not None and _plan_cacheable(plan):
                self.domain.plan_cache().put(cache_key, plan)
        ctx = self._context(self._read_ts(), self.txn)
        coll = self._stats_collector()
        self._last_plan = plan
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
        if isinstance(stmt, ast.LoadDataStmt):
            with trace.span("execute", executor="LoadData"):
                return self._load_data_in_txn(stmt)
        plan = self._plan(stmt)
        if isinstance(plan, (ph.PhysInsert, ph.PhysUpdate, ph.PhysDelete)):
            # schema validation scope: the tables this txn WRITES
            self.txn.related_tables.add(plan.table.id)
        elif isinstance(plan, (ph.PhysMultiUpdate, ph.PhysMultiDelete)):
            for target in plan.targets:
                self.txn.related_tables.add(target[0].id)
        ctx = self._context(self.txn.start_ts, self.txn)
        coll = self._stats_collector()
        self._last_plan = plan
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
            is_global = getattr(a, "is_global", False)
            if config.is_known(a.name):
                # registry knobs: GLOBAL writes the process registry;
                # session scope shadows it via the statement overlay
                try:
                    val = config.coerce(a.name, val)
                except (TypeError, ValueError):
                    raise SQLError(
                        f"invalid value for @@{a.name}: {val!r}") from None
                if is_global:
                    config.set_var(a.name, val)
                elif config.is_global_only(a.name):
                    # a session-scope write would shadow the value on
                    # this thread while its side effect (failpoint
                    # arming) never fires
                    raise SQLError(
                        f"Variable '{a.name}' is a GLOBAL variable "
                        f"and should be set with SET GLOBAL")
            if is_global:
                # GLOBAL never touches the session scope (MySQL)
                self._persist_global_var(a.name.lower(), val)
            else:
                self.sys_vars[a.name.lower()] = val
                if a.name.lower() == "autocommit":
                    self.autocommit = bool(int(val)) \
                        if val is not None else True
        return None

    def _persist_global_var(self, name: str, val) -> None:
        """SET GLOBAL persists into mysql.global_variables (ref:
        session.go:588-640 SetGlobalSysVar) when the catalog exists."""
        if not self.domain.info_schema().has_db("mysql"):
            return
        s = Session(self.storage, db="mysql", internal=True)
        try:
            cond = f"variable_name = '{_q(name)}'"
            if s.query("SELECT variable_name FROM mysql.global_variables "
                       f"WHERE {cond}").rows:
                s.execute("UPDATE mysql.global_variables SET "
                          f"variable_value = '{_q(str(val))}' WHERE {cond}")
            else:
                s.execute("INSERT INTO mysql.global_variables VALUES "
                          f"('{_q(name)}', '{_q(str(val))}')")
        finally:
            s.close()

    @staticmethod
    def _filter_show_rows(rs: "ResultSet", where) -> "ResultSet":
        """Minimal SHOW ... WHERE evaluator: `col = literal` conjuncts
        over the result columns (the shape the reference's SHOW WHERE
        sees in practice)."""
        conds = []

        def walk(e):
            if isinstance(e, ast.BinaryOp) and e.op.upper() == "AND":
                walk(e.left)
                walk(e.right)
                return
            if isinstance(e, ast.BinaryOp) and e.op == "=" and \
                    isinstance(e.left, ast.ColName) and \
                    isinstance(e.right, ast.Literal):
                conds.append((e.left.name.lower(), e.right.value))
                return
            raise SQLError("unsupported SHOW ... WHERE (use col = "
                           "literal [AND ...])")

        walk(where)
        lower = [c.lower() for c in rs.columns]
        idx = []
        for name, val in conds:
            if name not in lower:
                raise SQLError(f"unknown column '{name}' in SHOW WHERE")
            idx.append((lower.index(name), val))
        # SHOW result columns carry utf8 ci collation in MySQL, so the
        # value comparison is case-insensitive
        rows = [r for r in rs.rows
                if all(str(r[i]).lower() == str(v).lower()
                       for i, v in idx)]
        return ResultSet(rs.columns, rows)


    # -- LOAD DATA (ref: executor/write.go:1373 LoadDataExec) ----------------

    def _load_data_in_txn(self, stmt: ast.LoadDataStmt) -> int:
        from tidb_tpu_torch.executor.loaddata import (RowsInsert,
                                                      convert_fields,
                                                      parse_lines,
                                                      read_text_chunks)
        info = self._resolve_table_or_err(stmt.table)
        col_names = [c.lower() for c in stmt.columns] \
            or [c.name.lower() for c in info.public_columns()]
        cols = [info.col_by_name(c) for c in col_names]
        try:
            f = open(stmt.path, "r", encoding="utf-8", newline="")
        except OSError as e:
            raise SQLError(f"Can't get stat of '{stmt.path}': {e}") from None
        with f:
            self.txn.related_tables.add(info.id)
            ctx = self._context(self.txn.start_ts, self.txn)

            def rows():
                for i, fields in enumerate(
                        parse_lines(read_text_chunks(f), stmt)):
                    if i % 1024 == 0:
                        ctx.check_interrupt()
                    yield convert_fields(info, col_names, fields, cols)

            return RowsInsert(info, rows(), stmt.dup_mode).execute(ctx)

    # -- TRACE (ref: the reference's TRACE statement rendering its
    # per-statement span tree, executor/trace.go) ----------------------------

    def _exec_trace(self, stmt: ast.TraceStmt) -> ResultSet:
        """Execute the inner statement under THIS statement's (forced)
        trace root — admission, scheduler-slot, dispatch/finalize and
        worker spans all land on one tree — then render that tree: row
        form is the operator-facing indented table, json form one
        document (also retained in the ring under the returned
        trace_id, so GET /trace/<id> serves the same tree)."""
        inner = stmt.stmt
        if isinstance(inner, ast.TraceStmt):
            raise SQLError("TRACE statements cannot nest")
        self._run_stmt(inner)    # result discarded: the tree IS the output
        root = trace.current_root()
        if root is None:
            raise SQLError("TRACE: no statement trace is active")
        tid = trace.ensure_id(root)
        snap = trace.tree(root)
        if stmt.format == "json":
            import json as _json
            return ResultSet(
                ["trace"],
                [(_json.dumps({"trace_id": tid, "spans": snap}),)])
        rows: list[tuple] = []

        def walk(d: dict, depth: int) -> None:
            op = "  " * depth + d["name"]
            tags = d.get("tags")
            if tags:
                op += " " + " ".join(f"{k}={v}" for k, v in
                                     sorted(tags.items()))
            rows.append((op, f"{d['start_us'] / 1e3:.3f}ms",
                         f"{d['duration_us'] / 1e3:.3f}ms"))
            for ev in d.get("events", ()):
                rows.append(("  " * (depth + 1) + "! " + ev["name"],
                             f"{ev['at_us'] / 1e3:.3f}ms", "-"))
            for c in d.get("children", ()):
                walk(c, depth + 1)

        walk(snap, 0)
        return ResultSet(["operation", "start", "duration"], rows)

    # -- SPLIT TABLE (ref: store/tikv/split_region.go:29; mocktikv
    # cluster.go:276 Split/SplitTable) ---------------------------------------

    def _exec_split_table(self, stmt: ast.SplitTableStmt) -> ResultSet:
        info = self._resolve_table_or_err(stmt.table)
        cluster = getattr(self.storage, "cluster", None)
        if cluster is None:
            raise SQLError("storage does not support region split")
        if stmt.regions:
            done = cluster.split_table(info.id, stmt.regions)
        else:
            done = 0
            for e in stmt.at_values:
                if not isinstance(e, ast.Literal) or \
                        not isinstance(e.value, int):
                    raise SQLError("SPLIT TABLE AT takes integer literals")
                try:
                    cluster.split(
                        tablecodec.record_key(info.id, int(e.value)))
                    done += 1
                except ValueError:   # already a region boundary
                    pass
        cache = getattr(self.storage, "region_cache", None)
        if done and cache is not None:
            # the split regions' cached epochs are stale: without this
            # the next request sends one task over the old region (the
            # reference's behaviour) and under-counts its cop tasks
            cache.invalidate_range(*tablecodec.table_prefix_range(info.id))
        return ResultSet(["TOTAL_SPLIT_REGION"], [(done,)])

    # -- KILL (ref: ast/misc.go:341 KillStmt; server.go:333 Kill) ------------

    def _exec_kill(self, stmt: ast.KillStmt) -> None:
        with _session_seq_lock:
            live = list(_SESSIONS)
        target = next((s for s in live
                       if s.session_id == stmt.conn_id), None)
        if target is None:
            raise SQLError(f"Unknown thread id: {stmt.conn_id}")
        # privilege check on the RESOLVED target (the pre-exec check
        # would race a new connection claiming the id)
        if target.user != self.user and not self.internal:
            from tidb_tpu_torch.privilege import Priv
            ischema = self.domain.info_schema()
            if ischema.has_db("mysql") and not \
                    self.domain.priv_cache().request_verification(
                        self.user, self.host, "", "", Priv.SUPER):
                raise SQLError(
                    f"KILL command denied to user "
                    f"'{self.user}'@'{self.host}'")
        target.killed = True
        if not stmt.query_only:
            hook = target.kill_hook
            if hook is not None:
                try:
                    hook()            # server closes the connection
                except Exception:     # noqa: BLE001
                    pass
        return None

    def _show_stats(self, stmt: ast.ShowStmt) -> ResultSet:
        """SHOW STATS_META / STATS_HISTOGRAMS / STATS_BUCKETS (ref: the
        reference's statistics memtables surfaced through SHOW). WHERE
        filters on the text columns apply post-projection."""
        import datetime as _dt2
        handle = self.domain.stats_handle()
        is_ = self.domain.info_schema()
        meta_rows, hist_rows, bucket_rows = [], [], []
        for dbn in is_.db_names():
            if dbn.lower() in ("mysql",):
                continue
            for tn in is_.table_names(dbn):
                info = is_.table(dbn, tn)
                ts = handle.get(info.id)
                if ts.pseudo:
                    continue
                # stats version is a hybrid TSO ts: physical ms << 18
                upd = _dt2.datetime.fromtimestamp(
                    (ts.version >> 18) / 1e3).strftime(
                    "%Y-%m-%d %H:%M:%S") if ts.version else ""
                meta_rows.append((dbn, tn, upd, ts.modify_count,
                                  ts.count))
                for cid, cs in ts.columns.items():
                    col = next((c for c in info.columns if c.id == cid),
                               None)
                    h = getattr(cs, "hist", None) or getattr(
                        cs, "histogram", None)
                    if col is None:
                        continue
                    ndv = getattr(h, "ndv", 0) if h else 0
                    nulls = getattr(h, "null_count", 0) if h else 0
                    hist_rows.append((dbn, tn, col.name, 0, upd, ndv,
                                      nulls))
                    if h:
                        for bi in range(len(h.uppers)):
                            cnt = h.counts[bi] - (h.counts[bi - 1]
                                                  if bi else 0)
                            bucket_rows.append(
                                (dbn, tn, col.name, 0, bi, cnt,
                                 str(h.lowers[bi]), str(h.uppers[bi])))
        if stmt.tp == "stats_meta":
            rs = ResultSet(["Db_name", "Table_name", "Update_time",
                            "Modify_count", "Row_count"], meta_rows)
        elif stmt.tp == "stats_histograms":
            rs = ResultSet(["Db_name", "Table_name", "Column_name",
                            "Is_index", "Update_time", "Distinct_count",
                            "Null_count"], hist_rows)
        else:
            rs = ResultSet(["Db_name", "Table_name", "Column_name",
                            "Is_index", "Bucket_id", "Count",
                            "Lower_Bound", "Upper_Bound"], bucket_rows)
        if stmt.where is not None:
            rs = self._filter_show_rows(rs, stmt.where)
        return rs

    def _exec_show(self, stmt: ast.ShowStmt) -> ResultSet:
        ischema = self.domain.info_schema()
        if stmt.tp == "databases":
            return ResultSet(["Database"],
                             [(n,) for n in ischema.db_names()])
        if stmt.tp == "tables":
            db = stmt.db or self.current_db
            if db.lower() == "information_schema":
                from tidb_tpu_torch.plan.planner import Planner as _P
                return ResultSet([f"Tables_in_{db}"],
                                 [(n,) for n in _P._MEMTABLES])
            if db.lower() == "performance_schema":
                from tidb_tpu_torch.plan.planner import Planner as _P
                return ResultSet([f"Tables_in_{db}"],
                                 [(n,) for n in _P._PERF_TABLES])
            try:
                names = ischema.table_names(db)
            except SchemaError as e:
                raise SQLError(str(e)) from None
            return ResultSet([f"Tables_in_{db}"],
                             [(n,) for n in names])
        if stmt.tp == "columns":
            db = stmt.table.db or self.current_db
            t = ischema.table(db, stmt.table.name)
            rows = []
            for c in t.public_columns():
                rows.append((c.name, _type_name(c),
                             "NO" if c.ft.not_null else "YES",
                             "PRI" if (t.pk_is_handle and
                                       c.name == t.pk_col_name) else "",
                             None, ""))
            return ResultSet(["Field", "Type", "Null", "Key", "Default",
                              "Extra"], rows)
        if stmt.tp == "variables":
            from tidb_tpu_torch import config
            # all_vars() already applies this thread's session overlay;
            # non-registry session sysvars layer on top
            merged = dict(config.all_vars())
            merged.update(self.sys_vars)
            rows = sorted((k, str(v)) for k, v in merged.items())
            if stmt.pattern:
                import re
                from tidb_tpu_torch.expression.core import _like_to_regex
                rx = re.compile(_like_to_regex(stmt.pattern))
                rows = [r for r in rows if rx.fullmatch(r[0])]
            rs = ResultSet(["Variable_name", "Value"], rows)
            return self._filter_show_rows(rs, stmt.where) \
                if getattr(stmt, "where", None) is not None else rs
        if stmt.tp == "processlist":
            rows = []
            now = time.time()
            with _session_seq_lock:   # adds are serialized with snapshot
                live = list(_SESSIONS)
            for s in sorted(live, key=lambda x: x.session_id):
                sql = s.current_sql
                tracker = getattr(s, "mem_tracker", None)
                rm = getattr(s, "res_meter", None)
                mtot = rm.totals() if rm is not None else {}
                rows.append((s.session_id, s.user, s.host,
                             s.current_db or None,
                             "Query" if sql else "Sleep",
                             int(now - s.created_at),
                             "" if sql else None,
                             # SHOW FULL PROCESSLIST: untruncated SQL
                             ((sql or "") if stmt.full
                              else (sql or "")[:100]) or None,
                             tracker.total() if tracker is not None
                             else 0,
                             # cumulative metered work (meter.py):
                             # device busy-time in ms + rows served
                             mtot.get("device_ns", 0) // 1_000_000,
                             mtot.get("rows_sent", 0)))
            return ResultSet(["Id", "User", "Host", "db", "Command",
                              "Time", "State", "Info", "Mem",
                              "DeviceTime", "RowsSent"], rows)
        if stmt.tp == "create_table":
            db = stmt.table.db or self.current_db
            t = ischema.table(db, stmt.table.name)

            def col_sql(c):
                out = f"`{c.name}` {_type_name(c)}"
                if c.ft.is_ci:
                    # non-default collation must round-trip dump/restore
                    out += f" COLLATE {c.ft.collation}"
                if c.ft.not_null:
                    out += " NOT NULL"
                if c.auto_increment:
                    out += " AUTO_INCREMENT"
                return out

            parts = [col_sql(c) for c in t.public_columns()]
            if t.pk_is_handle and t.pk_col_name:
                parts.append(f"PRIMARY KEY (`{t.pk_col_name}`)")
            from tidb_tpu_torch.schema.model import SchemaState
            for idx in t.indexes:
                if idx.state != SchemaState.PUBLIC:
                    continue
                cols_s = ",".join(f"`{c}`" for c in idx.columns)
                if idx.primary:
                    parts.append(f"PRIMARY KEY ({cols_s})")
                elif idx.unique:
                    parts.append(
                        f"UNIQUE KEY `{idx.name}` ({cols_s})")
                else:
                    parts.append(f"KEY `{idx.name}` ({cols_s})")
            body = ",\n  ".join(parts)
            return ResultSet(["Table", "Create Table"],
                             [(t.name,
                               f"CREATE TABLE `{t.name}` (\n  {body}\n)")])
        if stmt.tp == "index":
            from tidb_tpu_torch.schema.model import SchemaState
            t = self._resolve_table_or_err(stmt.table)
            rows = []
            if t.pk_is_handle and t.pk_col_name:
                rows.append((t.name, 0, "PRIMARY", 1,
                             t.pk_col_name.lower(), "BTREE"))
            for idx in t.indexes:
                if idx.state != SchemaState.PUBLIC:
                    continue
                for seq, cn in enumerate(idx.columns, 1):
                    rows.append((t.name, 0 if idx.unique else 1,
                                 idx.name.lower(), seq, cn.lower(),
                                 "BTREE"))
            return ResultSet(["Table", "Non_unique", "Key_name",
                              "Seq_in_index", "Column_name",
                              "Index_type"], rows)
        if stmt.tp == "status":
            from tidb_tpu_torch import metrics
            rows = sorted((k, str(v))
                          for k, v in metrics.snapshot().items())
            return ResultSet(["Variable_name", "Value"], rows)
        if stmt.tp == "engines":
            return ResultSet(
                ["Engine", "Support", "Comment"],
                [("tidb-tpu", "DEFAULT",
                  "MVCC KV with CUDA analytical executors")])
        if stmt.tp == "collation":
            # the two implemented collations (sqltypes.FieldType.is_ci;
            # _general_ci approximated by unicode casefold)
            return ResultSet(
                ["Collation", "Charset", "Default"],
                [("utf8mb4_bin", "utf8mb4", "Yes"),
                 ("utf8mb4_general_ci", "utf8mb4", ""),
                 ("utf8_bin", "utf8", ""),
                 ("utf8_general_ci", "utf8", "")])
        if stmt.tp in ("warnings", "errors"):
            # statement diagnostics area: populated by add_warning();
            # cleanly-executed statements leave it empty, like MySQL
            rows = [(lvl, code, msg)
                    for lvl, code, msg in getattr(self, "_warnings", [])]
            return ResultSet(["Level", "Code", "Message"],
                             rows if stmt.tp == "warnings" else
                             [r for r in rows if r[0] == "Error"])
        if stmt.tp == "plugins":
            return ResultSet(["Name", "Status", "Type", "Library",
                              "License"], [])
        if stmt.tp == "profiles":
            return ResultSet(["Query_ID", "Duration", "Query"], [])
        if stmt.tp == "triggers":
            return ResultSet(["Trigger", "Event", "Table", "Statement",
                              "Timing", "Created"], [])
        if stmt.tp == "events":
            return ResultSet(["Db", "Name", "Definer", "Time zone",
                              "Type", "Status"], [])
        if stmt.tp in ("procedure_status", "function_status"):
            return ResultSet(["Db", "Name", "Type", "Definer",
                              "Modified", "Created"], [])
        if stmt.tp == "master_status":
            return ResultSet(["File", "Position", "Binlog_Do_DB",
                              "Binlog_Ignore_DB"], [])
        if stmt.tp == "charset":
            return ResultSet(
                ["Charset", "Description", "Default collation",
                 "Maxlen"],
                [("utf8mb4", "UTF-8 Unicode", "utf8mb4_bin", 4),
                 ("utf8", "UTF-8 Unicode", "utf8_bin", 3),
                 ("binary", "Binary pseudo charset", "binary", 1)])
        if stmt.tp in ("stats_meta", "stats_histograms", "stats_buckets"):
            return self._show_stats(stmt)
        if stmt.tp == "grants":
            target = stmt.pattern or (self.user or "")
            user, _, host = target.partition("@")
            is_self = user == (self.user or "") and \
                (not host or host == (self.host or ""))
            if not is_self and not self.internal:
                # viewing ANOTHER account's grants needs catalog access
                # (MySQL: SELECT on the mysql schema)
                from tidb_tpu_torch.privilege import Priv
                cache0 = self.domain.priv_cache()
                ischema0 = self.domain.info_schema()
                if ischema0.has_db("mysql") and not \
                        cache0.request_verification(
                            self.user, self.host, "mysql", "",
                            Priv.SELECT):
                    raise SQLError(
                        f"SHOW GRANTS denied to user '{self.user}'@"
                        f"'{self.host}'")
            cache = self.domain.priv_cache()
            grants = cache.describe_grants(user, host or None)
            if not grants:
                grants = [f"GRANT USAGE ON *.* TO '{user}'@'%'"]
            return ResultSet([f"Grants for {user}"],
                             [(g,) for g in grants])
        return ResultSet(["info"], [])

    def _resolve_table(self, ts):
        ischema = self.domain.info_schema()
        db = (getattr(ts, "db", "") or self.current_db)
        return ischema.table(db, ts.name)

    def _resolve_table_or_err(self, ts):
        from tidb_tpu_torch.schema.infoschema import SchemaError
        try:
            return self._resolve_table(ts)
        except SchemaError:
            raise SQLError(f"Table '{ts.name}' doesn't exist") from None

    def _exec_explain(self, stmt: ast.ExplainStmt) -> ResultSet:
        if stmt.analyze:
            return self._exec_explain_analyze(stmt.stmt)
        lines = self._plan(stmt.stmt).explain().split("\n")
        return ResultSet(["plan"], [(line,) for line in lines])

    def _exec_explain_analyze(self, inner: ast.StmtNode) -> ResultSet:
        """EXPLAIN ANALYZE: execute the statement for real under a
        runtime-stats collector, then render the executed plan annotated
        with per-operator actuals (ref: the reference's EXPLAIN ANALYZE
        over RuntimeStatsColl, executor/explain.go)."""
        if not isinstance(inner, (ast.SelectStmt, ast.UnionStmt,
                                  ast.InsertStmt, ast.UpdateStmt,
                                  ast.DeleteStmt)):
            raise SQLError(
                "EXPLAIN ANALYZE supports SELECT/UNION and DML statements")
        device = config.runtime_stats_device()
        coll = rs.StatsCollector(device=device)
        self._last_plan = None
        with rs.collecting(coll):
            self._run_stmt(inner)
        plan = self._last_plan
        if plan is None:
            raise SQLError("EXPLAIN ANALYZE: no plan was executed")
        # per-op mem comes from the statement's memory-tracker nodes
        # (host + device ledgers), collected by default — NOT from the
        # process-global backend watermark, which a concurrent
        # statement's allocations would contaminate
        mt = memtrack.current()
        rows = []
        for depth, node in plan.explain_nodes():
            st = coll.get(node)
            mnode = mt.get(node) if mt is not None else None
            mem = rs.fmt_bytes(mnode.peak_total()) \
                if mnode is not None else "-"
            est = "" if node.est_rows is None else f"{node.est_rows:.0f}"
            if st is None:
                rows.append(("  " * depth + node.explain_line(), est,
                             0, 0, "-", "-", mem, 0, "-", "-"))
                continue
            rows.append((
                "  " * depth + node.explain_line(), est,
                st.act_rows, st.loops, rs.fmt_ns(st.time_ns),
                rs.fmt_ns(st.device_time_ns) if device else "-",
                mem, st.cop_tasks, _fmt_pipeline(st), _fmt_kernel(st)))
        return ResultSet(["id", "est_rows", "act_rows", "loops", "time",
                          "device_time", "mem", "cop_tasks", "pipeline",
                          "kernel"],
                         rows)


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
    _CLIENT_SYSVAR_DEFAULTS = {
        "version_comment": "tidb-tpu",
        "character_set_client": "utf8mb4",
        "character_set_results": "utf8mb4",
        "character_set_connection": "utf8mb4",
        "collation_connection": "utf8mb4_bin",
        "collation_server": "utf8mb4_bin",
        "max_allowed_packet": 67108864,
        "wait_timeout": 28800,
        "interactive_timeout": 28800,
        "lower_case_table_names": 1,
        "time_zone": "SYSTEM",
        "tx_isolation": "REPEATABLE-READ",
        "transaction_isolation": "REPEATABLE-READ",
    }


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
            if name == "tidb_current_ts":
                # start ts of the open txn, 0 outside one (ref:
                # sessionctx/variable TiDBCurrentTS)
                return True, (self.txn.start_ts
                              if self.txn is not None else 0)
            if name in self._CLIENT_SYSVAR_DEFAULTS:
                return True, self._CLIENT_SYSVAR_DEFAULTS[name]
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

    def _eval_scalar_expr(self, e):
        """Evaluate a table-free AST expression to a python value (used
        by @v := assignments)."""
        import numpy as np
        from tidb_tpu_torch import sqltypes as st2
        from tidb_tpu_torch.expression.core import Constant
        from tidb_tpu_torch.plan.resolver import PlanSchema, Resolver, \
            ResolveError

        def unwrap(val, ft):
            if val is None:
                return None
            if ft.eval_type == st2.EvalType.DECIMAL and ft.frac > 0:
                return st2.scaled_to_decimal(int(val), ft.frac)
            if isinstance(val, (np.integer,)):
                return int(val)
            if isinstance(val, np.floating):
                return float(val)
            return val

        try:
            r = Resolver(PlanSchema([])).resolve(e)
            if isinstance(r, Constant):
                return unwrap(r.value, r.ft)
            data, valid = r.eval_xp(np, [], 1)
        except (ResolveError, ExecError) as ex:
            # keep the SQLError API contract for @v := <bad expr>
            raise SQLError(str(ex)) from None
        if not bool(np.asarray(valid)[0]):
            return None
        return unwrap(np.asarray(data)[0], r.ft)

    def _fold_session_exprs(self, node):
        """Rebuild the AST with session-context expressions folded to
        literals. -> (node, changed)."""
        import dataclasses
        changed = False

        def walk(x):
            nonlocal changed
            if isinstance(x, ast.VarAssignExpr):
                # @v := expr: fold inner session refs, evaluate once per
                # statement (constant contexts) and store
                val = self._eval_scalar_expr(walk(x.value))
                self.vars["@" + x.name.lstrip("@").lower()] = val
                changed = True
                return ast.Literal(val)
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


@dataclass
class _Prepared:
    stmt: ast.StmtNode
    markers: list          # ParamMarkers in occurrence order
    sql: str
    sid: int = 0
    name: str | None = None
    columns_meta: tuple | None = None   # memoized (names, field_types)


def _q(s: str) -> str:
    """Escape a string literal for the internal account SQL."""
    return str(s).replace("\\", "\\\\").replace("'", "\\'")


def _referenced_tables(stmt) -> list[tuple[str, str]]:
    """(db, table) pairs of every TableSource in the statement tree
    (subqueries included) — the privilege-check surface."""
    out: list[tuple[str, str]] = []
    seen: set[int] = set()

    def walk(x):
        if id(x) in seen or x is None:
            return
        seen.add(id(x))
        if isinstance(x, ast.TableSource):
            out.append(((x.db or "").lower(), x.name.lower()))
            return
        if isinstance(x, (list, tuple)):
            for item in x:
                walk(item)
            return
        if hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f))

    walk(stmt)
    # dedupe, keep order
    uniq = []
    for p in out:
        if p not in uniq:
            uniq.append(p)
    return uniq


def ast_params(node) -> list:
    """Collect ParamMarker nodes of a statement in occurrence order."""
    out = []
    seen = set()

    def walk(x):
        if id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, ast.ParamMarker):
            out.append(x)
            return
        if isinstance(x, (list, tuple)):
            for item in x:
                walk(item)
            return
        if hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f))

    walk(node)
    return out


def _plan_cacheable(plan) -> bool:
    """Plans with correlated apply cells mutate during execution, and
    plans with volatile plan-time folds (NOW()) or memtable snapshots go
    stale — never share those via the cache. A cached plan holds no
    device tensor and no storage state of its own: the executors are
    built anew per execution, and the one thing the coprocessor caches
    on a CopPlan (its kernels, per device) is what a re-created plan
    would fetch from the process-wide kernel cache anyway."""
    from tidb_tpu_torch.plan import physical as _ph
    if not plan.cacheable:
        return False
    if isinstance(plan, _ph.PhysApply) and plan.corr:
        return False
    for c in plan.children:
        if not _plan_cacheable(c):
            return False
    inner = getattr(plan, "inner", None)
    if inner is not None and not _plan_cacheable(inner):
        return False
    return True


def _type_name(c) -> str:
    ft = c.ft
    names = {TypeCode.LONGLONG: "bigint", TypeCode.LONG: "int",
             TypeCode.SHORT: "smallint", TypeCode.TINY: "tinyint",
             TypeCode.DOUBLE: "double", TypeCode.FLOAT: "float",
             TypeCode.NEWDECIMAL: f"decimal({ft.flen},{ft.frac})",
             TypeCode.VARCHAR: f"varchar({ft.flen})",
             TypeCode.STRING: f"char({ft.flen})",
             TypeCode.BLOB: "text", TypeCode.DATE: "date",
             TypeCode.DATETIME: "datetime",
             TypeCode.TIMESTAMP: "timestamp",
             TypeCode.DURATION: "time", TypeCode.YEAR: "year",
             TypeCode.JSON: "json"}
    if ft.tp in (TypeCode.ENUM, TypeCode.SET):
        kind = "enum" if ft.tp == TypeCode.ENUM else "set"
        members = ",".join(f"'{e}'" for e in ft.elems)
        return f"{kind}({members})"
    return names.get(ft.tp, "unknown")


def _fmt_pipeline(st) -> str:
    """EXPLAIN ANALYZE `pipeline` cell: how the operator's device work
    was coalesced (superchunks/source chunks), how full the padded
    buckets were, how long the host sat blocked on readback — and how
    often the operator fell back to the host path (the note that makes
    an invisible device->host cliff visible in the plan)."""
    fb = f" fallback={st.fallbacks}" if st.fallbacks else ""
    # encoded-execution mode (encoded / decoded / direct-agg /
    # fused:<fragment>): how the operator consumed its dict columns —
    # the note that makes an encoded->decoded regression diagnosable
    # from the operator's chair
    enc = f" enc={st.encoding}" if st.encoding else ""
    if not st.superchunks:
        return f"-{fb}{enc}" if fb or enc else "-"
    return (f"{st.superchunks}sc/{st.coalesced_chunks}ch "
            f"fill={st.fill_ratio():.2f} "
            f"stall={rs.fmt_ns(st.pipeline_stall_ns)}{fb}{enc}")


def _fmt_kernel(st) -> str:
    """EXPLAIN ANALYZE `kernel` cell: which kernel family served the
    operator, whether this statement paid a compile (miss) or rode the
    in-process (cached) / persistent (hit) compile cache, the achieved
    memory bandwidth, and where that sits against the platform's memory
    roofline — e.g. `hashagg compile=cached 12.3GB/s roof=0.18`."""
    if not st.kernel_family or not st.kernel_dispatches:
        return "-"
    from tidb_tpu_torch import profiler
    s = st.kernel_family
    if st.kernel_compile:
        s += f" compile={st.kernel_compile}"
    if st.mode:
        s += f" mode={st.mode}"
    g = profiler.achieved_gbps(st.kernel_bytes, st.kernel_busy_ns)
    if g is not None:
        s += f" {g:.1f}GB/s"
        frac = profiler.roofline_fraction(st.kernel_bytes,
                                          st.kernel_busy_ns)
        if frac is not None:
            s += f" roof={frac:.2f}"
    return s


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
