"""DDL: statement validation + job construction (the API half).

The port's copy of the JAX package's ddl/__init__.py: CREATE/DROP
DATABASE, CREATE/DROP TABLE, TRUNCATE, RENAME, CREATE/DROP INDEX and
ALTER TABLE, each job run to the end by the in-process worker (one
process is the only owner: no election, no remote wait).

Reference: TiDB's ddl/ddl_api.go (validation + job build),
ddl/ddl.go:406 doDDLJob (enqueue, then wait for the owner's worker to
finish the job). Statements validate against the current schema, enqueue a
`Job`, and drive the in-process worker (ddl/worker.py) until the job
reaches history — so the session API is synchronous while the metadata
walks the full F1 state machine, one schema version per transition, with
every intermediate state visible to concurrent sessions.
"""

from __future__ import annotations

from tidb_tpu_torch import kv
from tidb_tpu_torch.ddl.job import Job, JobType
from tidb_tpu_torch.ddl.worker import DDLWorker, JobFailed
from tidb_tpu_torch.meta import Meta
from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.schema.model import (ColumnInfo, DBInfo, IndexInfo,
                                         TableInfo)
from tidb_tpu_torch.sqltypes import EvalType, Flag
from tidb_tpu_torch.table import Table  # noqa: F401  (re-export for callers)

__all__ = ["DDLError", "DDL", "DDLExecutor", "build_table_info"]


class DDLError(kv.KVError):
    pass


class DDL:
    """Validates a DDL statement, enqueues its job(s), runs the worker."""

    def __init__(self, storage, worker: DDLWorker | None = None):
        self.storage = storage
        self.worker = worker or DDLWorker(storage)

    def execute(self, stmt: ast.StmtNode, current_db: str,
                domain=None) -> None:
        m = getattr(self, "_build_" + type(stmt).__name__, None)
        if m is None:
            raise DDLError(f"unsupported DDL {type(stmt).__name__}")
        # one process is the only owner: each job runs here, to the end
        # (the reference's owner election and remote wait are not ported).
        # Build + run jobs one at a time: later specs of one ALTER
        # validate against the schema the earlier ones produced.
        for build in m(stmt, current_db):
            job = self._enqueue(build)
            if job is None:
                continue
            try:
                self.worker.run_job(job.id)
            except JobFailed as e:
                raise DDLError(str(e)) from None

    def _enqueue(self, build) -> Job | None:
        """Run `build(meta) -> Job|None` and enqueue in one meta txn."""
        txn = self.storage.begin()
        try:
            meta = Meta(txn)
            job = build(meta)
            if job is None:
                txn.rollback()
                return None
            job.id = meta.gen_global_id()
            meta.enqueue_job(job)
            txn.commit()
            return job
        except Exception:
            if txn.valid:
                txn.rollback()
            raise

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _find_db(meta: Meta, name: str) -> DBInfo:
        for db in meta.list_databases():
            if db.name.lower() == name.lower():
                return db
        raise DDLError(f"Unknown database '{name}'")

    @staticmethod
    def _find_table(meta: Meta, db_id: int, name: str):
        for t in meta.list_tables(db_id):
            if t.name.lower() == name.lower():
                return t
        return None

    def _resolve(self, meta: Meta, ts: ast.TableSource, current_db: str):
        dbn = ts.db or current_db
        if not dbn:
            raise DDLError("No database selected")
        db = self._find_db(meta, dbn)
        return db, self._find_table(meta, db.id, ts.name)

    def _must_resolve(self, meta: Meta, ts, current_db):
        db, t = self._resolve(meta, ts, current_db)
        if t is None:
            raise DDLError(f"table '{ts.name}' doesn't exist")
        return db, t

    # -- databases -----------------------------------------------------------

    def _build_CreateDatabaseStmt(self, stmt, _db):
        def build(meta: Meta):
            for db in meta.list_databases():
                if db.name.lower() == stmt.name.lower():
                    if stmt.if_not_exists:
                        return None
                    raise DDLError(f"database '{stmt.name}' exists")
            return Job(tp=JobType.CREATE_SCHEMA,
                       schema_id=meta.gen_global_id(),
                       args={"name": stmt.name})
        return [build]

    def _build_DropDatabaseStmt(self, stmt, _db):
        def build(meta: Meta):
            for db in meta.list_databases():
                if db.name.lower() == stmt.name.lower():
                    return Job(tp=JobType.DROP_SCHEMA, schema_id=db.id)
            if stmt.if_exists:
                return None
            raise DDLError(f"database '{stmt.name}' doesn't exist")
        return [build]

    # -- tables --------------------------------------------------------------

    def _build_CreateTableStmt(self, stmt, current_db):
        def build(meta: Meta):
            db, existing = self._resolve(meta, stmt.table, current_db)
            if existing is not None:
                if stmt.if_not_exists:
                    return None
                raise DDLError(f"table '{stmt.table.name}' exists")
            if stmt.like_table is not None:
                # CREATE TABLE a LIKE b: clone b's schema with fresh ids
                # (ref: ddl_api.go CreateTableWithLike)
                _sdb, src = self._must_resolve(meta, stmt.like_table,
                                               current_db)
                info = TableInfo.from_json(src.to_json())   # deep copy
                info.id = meta.gen_global_id()
                info.name = stmt.table.name
                info.auto_inc_id = 0
            else:
                info = build_table_info(meta, stmt)
            return Job(tp=JobType.CREATE_TABLE, schema_id=db.id,
                       table_id=info.id, args={"table": info.to_json()})
        return [build]

    def _build_DropTableStmt(self, stmt, current_db):
        builders = []
        for ts in stmt.tables:
            def build(meta: Meta, ts=ts):
                db, t = self._resolve(meta, ts, current_db)
                if t is None:
                    if stmt.if_exists:
                        return None
                    raise DDLError(f"table '{ts.name}' doesn't exist")
                return Job(tp=JobType.DROP_TABLE, schema_id=db.id,
                           table_id=t.id)
            builders.append(build)
        return builders

    def _build_TruncateTableStmt(self, stmt, current_db):
        def build(meta: Meta):
            db, t = self._must_resolve(meta, stmt.table, current_db)
            return Job(tp=JobType.TRUNCATE_TABLE, schema_id=db.id,
                       table_id=t.id,
                       args={"new_table_id": meta.gen_global_id()})
        return [build]

    def _build_RenameTableStmt(self, stmt, current_db):
        builders = []
        for old_ts, new_ts in stmt.pairs:
            def build(meta: Meta, old_ts=old_ts, new_ts=new_ts):
                db, t = self._must_resolve(meta, old_ts, current_db)
                new_db = self._find_db(meta, new_ts.db or current_db)
                if self._find_table(meta, new_db.id, new_ts.name) is not None:
                    raise DDLError(f"table '{new_ts.name}' exists")
                return Job(tp=JobType.RENAME_TABLE, schema_id=db.id,
                           table_id=t.id,
                           args={"new_name": new_ts.name,
                                 "new_schema_id": new_db.id})
            builders.append(build)
        return builders

    # -- indexes -------------------------------------------------------------

    def _index_job(self, meta: Meta, db, t: TableInfo, name: str,
                   columns: list[str], unique: bool) -> Job:
        if t.index_by_name(name) is not None:
            raise DDLError(f"index '{name}' exists")
        for cn in columns:
            if t.col_by_name(cn) is None:
                raise DDLError(f"Unknown column '{cn}'")
        idx = IndexInfo(id=t.alloc_index_id(), name=name, columns=columns,
                        unique=unique)
        # persist the bumped max_index_id now so a concurrent/later job
        # can't hand out the same id
        meta.update_table(db.id, t)
        return Job(tp=JobType.ADD_INDEX, schema_id=db.id, table_id=t.id,
                   args={"index": idx.to_json()})

    def _build_CreateIndexStmt(self, stmt, current_db):
        def build(meta: Meta):
            db, t = self._must_resolve(meta, stmt.table, current_db)
            return self._index_job(meta, db, t, stmt.index_name,
                                   stmt.columns, stmt.unique)
        return [build]

    def _build_DropIndexStmt(self, stmt, current_db):
        def build(meta: Meta):
            db, t = self._must_resolve(meta, stmt.table, current_db)
            if t.index_by_name(stmt.index_name) is None:
                if stmt.if_exists:
                    return None
                raise DDLError(f"index '{stmt.index_name}' doesn't exist")
            return Job(tp=JobType.DROP_INDEX, schema_id=db.id,
                       table_id=t.id, args={"name": stmt.index_name})
        return [build]

    # -- ALTER ---------------------------------------------------------------

    def _build_AlterTableStmt(self, stmt, current_db):
        # one schema change per statement, like the reference
        # (ddl_api.go AlterTable: errRunMultiSchemaChanges) — keeps ALTER
        # atomic: a failing spec can't leave earlier specs applied.
        # Parse-level no-ops (LOCK=/ALGORITHM=/ENABLE KEYS) don't count.
        specs = [sp for sp in stmt.specs if sp.tp != "noop"]
        if not specs:
            return []
        if len(specs) != 1:
            raise DDLError("running multiple schema changes in one "
                           "statement is not supported")
        spec = specs[0]
        if spec.tp == "add_columns":
            if len(spec.columns) != 1:
                raise DDLError("running multiple schema changes in one "
                               "statement is not supported")
            spec = ast.AlterSpec(tp="add_column", column=spec.columns[0])

        def build(meta: Meta):
            db, t = self._must_resolve(meta, stmt.table, current_db)
            return self._alter_spec_job(meta, db, t, spec)
        return [build]

    def _alter_spec_job(self, meta: Meta, db, t: TableInfo, spec):
        if spec.tp == "add_column":
            cd = spec.column
            _check_column_type(cd)
            if t.col_by_name(cd.name) is not None:
                raise DDLError(f"column '{cd.name}' exists")
            default = None
            has_default = cd.has_default
            if cd.has_default and cd.default is not None:
                default = _const_default(cd)
            elif not cd.ft.not_null:
                has_default = True   # NULL default for existing rows
            col = ColumnInfo(id=t.alloc_column_id(), name=cd.name,
                             offset=len(t.columns), ft=cd.ft,
                             default=default, has_default=has_default,
                             auto_increment=cd.auto_increment)
            meta.update_table(db.id, t)   # persist max_column_id bump
            if spec.position == "after" and \
                    t.col_by_name(spec.after_col) is None:
                raise DDLError(f"Unknown column '{spec.after_col}'")
            return Job(tp=JobType.ADD_COLUMN, schema_id=db.id,
                       table_id=t.id,
                       args={"column": col.to_json(),
                             "position": spec.position,
                             "after_col": spec.after_col})
        if spec.tp == "drop_column":
            col = t.col_by_name(spec.name)
            if col is None:
                raise DDLError(f"Unknown column '{spec.name}'")
            if t.pk_is_handle and \
                    t.pk_col_name.lower() == spec.name.lower():
                raise DDLError("cannot drop the integer primary key")
            for idx in t.indexes:
                if any(c.lower() == spec.name.lower()
                       for c in idx.columns):
                    raise DDLError(f"column '{spec.name}' is indexed; "
                                   "drop index first")
            return Job(tp=JobType.DROP_COLUMN, schema_id=db.id,
                       table_id=t.id, args={"name": spec.name})
        if spec.tp == "add_index":
            idef = spec.index
            return self._index_job(meta, db, t,
                                   idef.name or "_".join(idef.columns),
                                   idef.columns, idef.unique)
        if spec.tp == "drop_index":
            if t.index_by_name(spec.name) is None:
                raise DDLError(f"index '{spec.name}' doesn't exist")
            return Job(tp=JobType.DROP_INDEX, schema_id=db.id,
                       table_id=t.id, args={"name": spec.name})
        if spec.tp in ("modify_column", "change_column"):
            old_name = spec.name if spec.tp == "change_column" \
                else spec.column.name
            old = t.col_by_name(old_name)
            if old is None:
                raise DDLError(f"Unknown column '{old_name}'")
            # MySQL MODIFY/CHANGE replaces the whole definition: the
            # default must be restated or it resets
            cd = spec.column
            default = _const_default(cd) if cd.has_default else None
            new = ColumnInfo(id=old.id, name=cd.name,
                             offset=old.offset, ft=cd.ft,
                             default=default,
                             has_default=cd.has_default or
                             not cd.ft.not_null)
            if spec.position == "after":
                # AFTER resolves against the post-change schema: the
                # column being moved (old or new name) can't anchor it
                if spec.after_col.lower() in (old_name.lower(),
                                              cd.name.lower()) or \
                        t.col_by_name(spec.after_col) is None:
                    raise DDLError(
                        f"Unknown column '{spec.after_col}'")
            return Job(tp=JobType.MODIFY_COLUMN, schema_id=db.id,
                       table_id=t.id,
                       args={"old_name": old_name,
                             "column": new.to_json(),
                             "position": spec.position,
                             "after_col": spec.after_col})
        if spec.tp in ("set_default", "drop_default"):
            old = t.col_by_name(spec.name)
            if old is None:
                raise DDLError(f"Unknown column '{spec.name}'")
            # metadata-only change, rides the MODIFY_COLUMN job
            fake = ast.ColumnDef(name=old.name, ft=old.ft,
                                 default=spec.default,
                                 has_default=spec.tp == "set_default")
            default = _const_default(fake) \
                if spec.tp == "set_default" else None
            new = ColumnInfo(id=old.id, name=old.name, offset=old.offset,
                             ft=old.ft, default=default,
                             has_default=spec.tp == "set_default" or
                             not old.ft.not_null,
                             auto_increment=old.auto_increment)
            return Job(tp=JobType.MODIFY_COLUMN, schema_id=db.id,
                       table_id=t.id,
                       args={"old_name": old.name,
                             "column": new.to_json()})
        if spec.tp == "rename":
            if spec.new_db and spec.new_db.lower() != db.name.lower():
                raise DDLError("cross-database RENAME is not supported")
            existing = self._find_table(meta, db.id, spec.name)
            if existing is not None and existing.id != t.id:
                raise DDLError(f"table '{spec.name}' exists")
            return Job(tp=JobType.RENAME_TABLE, schema_id=db.id,
                       table_id=t.id,
                       args={"new_name": spec.name,
                             "new_schema_id": db.id})
        raise DDLError(f"unsupported ALTER {spec.tp}")


# Back-compat alias: the session layer predates the job-based front-end.
DDLExecutor = DDL


# MySQL's cap (ref: types/mydecimal.go, 65 digits via 9-digit words).
# p<=18 rides the scaled-int64 device lane; wider columns use exact
# scaled python ints on the host object lane (FieldType.is_wide_decimal)
MAX_DECIMAL_DIGITS = 65


def _check_column_type(cd) -> None:
    from tidb_tpu_torch.sqltypes import TypeCode
    if cd.ft.tp == TypeCode.NEWDECIMAL:
        if cd.ft.flen > MAX_DECIMAL_DIGITS:
            raise DDLError(
                f"column '{cd.name}': DECIMAL({cd.ft.flen},{cd.ft.frac}) "
                f"exceeds the supported precision "
                f"({MAX_DECIMAL_DIGITS} digits)")
        if cd.ft.frac > cd.ft.flen:
            raise DDLError(
                f"column '{cd.name}': scale {cd.ft.frac} > "
                f"precision {cd.ft.flen}")


def build_table_info(meta: Meta, stmt: ast.CreateTableStmt) -> TableInfo:
    info = TableInfo(id=meta.gen_global_id(), name=stmt.table.name)
    names = set()
    # table-level default collation applies to string columns without an
    # explicit COLLATE (ref: util/charset; only _bin and _general_ci are
    # implemented — docs/DEVIATIONS.md)
    table_coll = (stmt.options or {}).get("collate", "").lower()
    for i, cd in enumerate(stmt.columns):
        if cd.name.lower() in names:
            raise DDLError(f"duplicate column '{cd.name}'")
        names.add(cd.name.lower())
        _check_column_type(cd)
        ft = cd.ft
        if table_coll and ft.eval_type == EvalType.STRING and \
                not getattr(cd, "explicit_collation", False):
            import dataclasses
            ft = dataclasses.replace(ft, collation=table_coll)
        default = _const_default(cd) if cd.has_default else None
        info.columns.append(ColumnInfo(
            id=i + 1, name=cd.name, offset=i, ft=ft, default=default,
            has_default=cd.has_default or not cd.ft.not_null,
            auto_increment=cd.auto_increment, comment=cd.comment))
    info.max_column_id = len(stmt.columns)

    # primary key: inline or table-level
    pk_cols: list[str] = [cd.name for cd in stmt.columns if cd.is_primary]
    idx_id = 0
    for idef in stmt.indexes:
        if idef.primary:
            pk_cols = pk_cols or idef.columns
            if idef.columns != pk_cols:
                raise DDLError("multiple primary keys")
    if len(pk_cols) == 1:
        pkc = info.col_by_name(pk_cols[0])
        if pkc is not None and pkc.ft.eval_type == EvalType.INT:
            info.pk_is_handle = True
            info.pk_col_name = pkc.name
            pkc.ft = pkc.ft.with_flags(Flag.PRI_KEY | Flag.NOT_NULL)
    if pk_cols and not info.pk_is_handle:
        idx_id += 1
        info.indexes.append(IndexInfo(id=idx_id, name="PRIMARY",
                                      columns=pk_cols, unique=True,
                                      primary=True))
    for cd in stmt.columns:
        if cd.is_unique:
            idx_id += 1
            info.indexes.append(IndexInfo(id=idx_id, name=cd.name,
                                          columns=[cd.name], unique=True))
    for idef in stmt.indexes:
        if idef.primary:
            continue
        idx_id += 1
        info.indexes.append(IndexInfo(
            id=idx_id, name=idef.name or "_".join(idef.columns),
            columns=idef.columns, unique=idef.unique))
    info.max_index_id = idx_id
    for idx in info.indexes:
        for cn in idx.columns:
            if info.col_by_name(cn) is None:
                raise DDLError(f"Unknown column '{cn}' in index")
    return info


def _const_default(cd: ast.ColumnDef):
    d = cd.default
    if d is None:
        return None
    if isinstance(d, ast.Literal):
        v = d.value
        if v is not None and cd.ft.eval_type == EvalType.DATETIME and \
                isinstance(v, str):
            from tidb_tpu_torch import sqltypes as st
            return st.parse_datetime(v)
        return v
    # DEFAULT CURRENT_TIMESTAMP[()] / NOW() on time columns: stored as
    # a sentinel, evaluated at each insert (ref: ddl_api.go
    # setDefaultValue + types CurrentTimestamp handling)
    name = d.name.upper() if isinstance(d, (ast.ColName,
                                            ast.FuncCall)) else ""
    if name in ("CURRENT_TIMESTAMP", "NOW", "LOCALTIME",
                "LOCALTIMESTAMP") and \
            cd.ft.eval_type == EvalType.DATETIME:
        return "CURRENT_TIMESTAMP"
    raise DDLError("only literal defaults supported")
