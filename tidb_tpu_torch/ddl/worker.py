"""Online DDL worker: the F1 schema-change state machine.

The port's copy of the JAX package's ddl/worker.py (reference: TiDB's
ddl/ddl_worker.go:33-320, the job loop, one state transition per meta
transaction; ddl/index.go:280,480-676, the add-index states and the
checkpointed backfill; ddl/column.go, the add/drop column walk;
ddl/reorg.go:71, the resumable reorgInfo; ddl/delete_range.go:51,
deferred range deletion; model/model.go:27-37, schema states).

Every transition runs in its own meta transaction and bumps the global
schema version with a SchemaDiff record, so concurrent sessions reload
incrementally and the schema validator can detect conflicting commits.
A crash between any two transactions leaves a resumable state: the job
queue and the reorg checkpoint are the only progress markers.
"""

from __future__ import annotations

from typing import Callable, Optional

from tidb_tpu_torch import codec, kv, tablecodec
from tidb_tpu_torch.ddl.job import Job, JobState, JobType
from tidb_tpu_torch.meta import Meta
from tidb_tpu_torch.schema.model import (ColumnInfo, DBInfo, IndexInfo,
                                         SchemaState, TableInfo)
from tidb_tpu_torch.table import DupKeyError, Table

__all__ = ["DDLWorker", "JobFailed"]

BACKFILL_BATCH = 256   # rows per backfill txn (ref: defaultTaskHandleCnt)


class JobFailed(kv.KVError):
    """Raised by run_job for a job that finished CANCELLED."""


class DDLWorker:
    """Single DDL owner (the reference elects one via etcd, owner/manager.go;
    in-process there is exactly one — multi-server deployments point every
    server's worker at the same job queue and the queue pop serializes)."""

    def __init__(self, storage,
                 on_state_change: Optional[Callable[[Job], None]] = None,
                 on_backfill_batch: Optional[Callable[[Job, int], None]]
                 = None):
        self.storage = storage
        self.on_state_change = on_state_change
        self.on_backfill_batch = on_backfill_batch

    # -- driving -------------------------------------------------------------

    def run_job(self, job_id: int, between_steps=None) -> Job:
        """Run queue steps until job_id finishes; raise if cancelled.
        `between_steps()` (owner-lease renewal + per-version convergence,
        session Domain) runs after every transition; returning
        False means ownership was lost — stop stepping (the new owner's
        worker continues the job) and report the job as-is."""
        while True:
            job = self.run_one_step()
            if job is not None and between_steps is not None and \
                    not between_steps():
                return job
            if job is None:
                # queue empty: the job must be in history
                txn = self.storage.begin()
                try:
                    done = Meta(txn).history_job(job_id)
                finally:
                    txn.rollback()
                if done is None:
                    raise kv.KVError(f"ddl job {job_id} vanished")
                job = done
            if job.id == job_id and job.finished:
                if job.state == JobState.CANCELLED:
                    raise JobFailed(job.error)
                return job

    def run_one_step(self) -> Job | None:
        """Apply one state transition of the queue-head job (plus, for a
        reorg state, the out-of-band backfill that precedes it)."""
        txn = self.storage.begin()
        try:
            head = Meta(txn).first_job()
        finally:
            txn.rollback()
        if head is None:
            return None
        if head.tp == JobType.ADD_INDEX and head.state == JobState.RUNNING \
                and head.schema_state == int(SchemaState.WRITE_REORG):
            try:
                self._backfill_index(head)
            except DupKeyError as e:
                # data violates the new unique index: walk the states back
                # (crash-like errors propagate instead — the checkpointed
                # reorg resumes on the next worker pass)
                self._cancel_or_rollback(head, str(e))
                return self._reload_head(head)

        txn = self.storage.begin()
        m = Meta(txn)
        job = m.first_job()
        if job is None:
            txn.rollback()
            return None
        if job.state == JobState.QUEUEING:
            job.state = JobState.RUNNING
        try:
            changed = self._dispatch(m, job)
        except Exception as e:  # noqa: BLE001 - job-level failure
            txn.rollback()
            self._cancel_or_rollback(job, str(e))
            return self._reload_head(job)
        if changed:
            ver = m.gen_schema_version()
            m.set_schema_diff(ver, [job.table_id] if job.table_id else [])
        if job.finished:
            m.finish_job(job)
        else:
            m.update_job(job)
        txn.commit()
        if job.finished and job.args.get("has_ranges"):
            self._seal_delete_ranges(job)
        if self.on_state_change is not None:
            self.on_state_change(job)
        return job

    def _seal_delete_ranges(self, job: Job) -> None:
        """Stamp the job's queued ranges with a ts acquired AFTER its final
        txn committed — an upper bound on the drop's commit ts, so GC can
        safely order the physical delete against the safepoint. Best
        effort: if this crashes, the GC worker re-seals orphaned ranges of
        finished jobs (gcworker._drain_delete_ranges)."""
        txn = self.storage.begin()
        try:
            Meta(txn).seal_delete_ranges(job.id, txn.start_ts)
            txn.commit()
        except Exception:
            if txn.valid:
                txn.rollback()

    def _reload_head(self, job: Job) -> Job:
        txn = self.storage.begin()
        try:
            head = Meta(txn).first_job()
            return head if head is not None and head.id == job.id else job
        finally:
            txn.rollback()

    def _cancel_or_rollback(self, job: Job, err: str) -> None:
        """Validation failure: cancel outright if nothing is half-built,
        else flip to ROLLBACK so the state machine walks backwards."""
        txn = self.storage.begin()
        m = Meta(txn)
        fresh = m.first_job()
        if fresh is None or fresh.id != job.id:
            txn.rollback()
            return
        fresh.error = err
        if fresh.tp == JobType.ADD_INDEX and \
                fresh.schema_state != int(SchemaState.NONE):
            fresh.state = JobState.ROLLBACK
            m.update_job(fresh)
        else:
            fresh.state = JobState.CANCELLED
            m.finish_job(fresh)
        txn.commit()

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, m: Meta, job: Job) -> bool:
        if job.state == JobState.ROLLBACK:
            return self._step_rollback_add_index(m, job)
        return {
            JobType.CREATE_SCHEMA: self._step_create_schema,
            JobType.DROP_SCHEMA: self._step_drop_schema,
            JobType.CREATE_TABLE: self._step_create_table,
            JobType.DROP_TABLE: self._step_drop_table,
            JobType.TRUNCATE_TABLE: self._step_truncate_table,
            JobType.RENAME_TABLE: self._step_rename_table,
            JobType.ADD_COLUMN: self._step_add_column,
            JobType.DROP_COLUMN: self._step_drop_column,
            JobType.MODIFY_COLUMN: self._step_modify_column,
            JobType.ADD_INDEX: self._step_add_index,
            JobType.DROP_INDEX: self._step_drop_index,
        }[job.tp](m, job)

    def _table(self, m: Meta, job: Job) -> TableInfo:
        info = m.get_table(job.schema_id, job.table_id)
        if info is None:
            raise kv.KVError(f"table {job.table_id} doesn't exist")
        return info

    # -- schema / table jobs (single transition) -----------------------------

    def _step_create_schema(self, m: Meta, job: Job) -> bool:
        db = DBInfo(id=job.schema_id, name=job.args["name"])
        for existing in m.list_databases():
            if existing.name.lower() == db.name.lower():
                raise kv.KVError(f"database '{db.name}' exists")
        m.create_database(db)
        job.state = JobState.DONE
        return True

    def _step_drop_schema(self, m: Meta, job: Job) -> bool:
        for t in m.list_tables(job.schema_id):
            lo, hi = tablecodec.table_prefix_range(t.id)
            m.add_delete_range(job.id, lo, hi)
            job.args["has_ranges"] = True
        m.drop_database(job.schema_id)
        job.state = JobState.DONE
        return True

    def _step_create_table(self, m: Meta, job: Job) -> bool:
        info = TableInfo.from_json(job.args["table"])
        # re-validate at apply time: two sessions may have raced the enqueue
        for t in m.list_tables(job.schema_id):
            if t.name.lower() == info.name.lower():
                raise kv.KVError(f"table '{info.name}' exists")
        m.create_table(job.schema_id, info)
        job.state = JobState.DONE
        return True

    def _step_drop_table(self, m: Meta, job: Job) -> bool:
        """PUBLIC -> WRITE_ONLY -> DELETE_ONLY -> gone
        (ref: ddl/table.go onDropTable)."""
        info = self._table(m, job)
        if info.state == SchemaState.PUBLIC:
            info.state = SchemaState.WRITE_ONLY
            m.update_table(job.schema_id, info)
        elif info.state == SchemaState.WRITE_ONLY:
            info.state = SchemaState.DELETE_ONLY
            m.update_table(job.schema_id, info)
        else:
            m.drop_table(job.schema_id, info.id)
            lo, hi = tablecodec.table_prefix_range(info.id)
            m.add_delete_range(job.id, lo, hi)
            job.args["has_ranges"] = True
            job.state = JobState.DONE
        job.schema_state = int(info.state)
        return True

    def _step_truncate_table(self, m: Meta, job: Job) -> bool:
        info = self._table(m, job)
        m.drop_table(job.schema_id, info.id)
        lo, hi = tablecodec.table_prefix_range(info.id)
        m.add_delete_range(job.id, lo, hi)
        job.args["has_ranges"] = True
        info.id = job.args["new_table_id"]
        m.create_table(job.schema_id, info)
        job.state = JobState.DONE
        return True

    def _step_rename_table(self, m: Meta, job: Job) -> bool:
        info = self._table(m, job)
        new_name = job.args["new_name"]
        new_db = job.args["new_schema_id"]
        for t in m.list_tables(new_db):
            if t.id != info.id and t.name.lower() == new_name.lower():
                raise kv.KVError(f"table '{new_name}' exists")
        m.drop_table(job.schema_id, info.id)
        info.name = new_name
        m.create_table(new_db, info)
        job.state = JobState.DONE
        return True

    # -- column jobs ---------------------------------------------------------

    def _step_add_column(self, m: Meta, job: Job) -> bool:
        """NONE -> DELETE_ONLY -> WRITE_ONLY -> WRITE_REORG -> PUBLIC
        (ref: ddl/column.go onAddColumn). No physical backfill: existing
        rows materialize the default lazily at decode."""
        info = self._table(m, job)
        col = info.col_by_name(job.args["column"]["name"])
        if col is None:
            # first transition: attach in DELETE_ONLY
            col = ColumnInfo.from_json(job.args["column"])
            col.state = SchemaState.DELETE_ONLY
            col.offset = len(info.columns)
            info.columns.append(col)
        elif col.state == SchemaState.DELETE_ONLY:
            col.state = SchemaState.WRITE_ONLY
        elif col.state == SchemaState.WRITE_ONLY:
            col.state = SchemaState.WRITE_REORG
        elif col.state == SchemaState.WRITE_REORG:
            col.state = SchemaState.PUBLIC
            self._position_column(info, col, job.args.get("position"),
                                  job.args.get("after_col"))
            job.state = JobState.DONE
        job.schema_state = int(col.state)
        m.update_table(job.schema_id, info)
        return True

    @staticmethod
    def _position_column(info: TableInfo, col: ColumnInfo,
                         position: str | None, after: str | None) -> None:
        if position in ("first", "after"):
            info.columns.remove(col)
            if position == "first":
                info.columns.insert(0, col)
            else:
                ai = next(i for i, c in enumerate(info.columns)
                          if c.name.lower() == after.lower())
                info.columns.insert(ai + 1, col)
        for i, c in enumerate(info.columns):
            c.offset = i

    def _step_drop_column(self, m: Meta, job: Job) -> bool:
        """PUBLIC -> WRITE_ONLY -> DELETE_ONLY -> DELETE_REORG -> gone
        (ref: ddl/column.go onDropColumn). Row values of the dropped column
        become dead bytes in the row codec; no physical rewrite."""
        info = self._table(m, job)
        col = info.col_by_name(job.args["name"])
        if col is None:
            raise kv.KVError(f"Unknown column '{job.args['name']}'")
        if col.state == SchemaState.PUBLIC:
            col.state = SchemaState.WRITE_ONLY
        elif col.state == SchemaState.WRITE_ONLY:
            col.state = SchemaState.DELETE_ONLY
        elif col.state == SchemaState.DELETE_ONLY:
            col.state = SchemaState.DELETE_REORG
        else:
            info.columns.remove(col)
            for i, c in enumerate(info.columns):
                c.offset = i
            job.state = JobState.DONE
        job.schema_state = int(col.state)
        m.update_table(job.schema_id, info)
        return True

    def _step_modify_column(self, m: Meta, job: Job) -> bool:
        info = self._table(m, job)
        col = info.col_by_name(job.args["old_name"])
        if col is None:
            raise kv.KVError(f"Unknown column '{job.args['old_name']}'")
        new = ColumnInfo.from_json(job.args["column"])
        col.name = new.name
        col.ft = new.ft
        col.default = new.default        # SET/DROP DEFAULT ride this job
        col.has_default = new.has_default
        # CHANGE ... FIRST/AFTER x: order is metadata only (rows store
        # col-id -> value pairs)
        self._position_column(info, col, job.args.get("position"),
                              job.args.get("after_col"))
        m.update_table(job.schema_id, info)
        job.state = JobState.DONE
        return True

    # -- index jobs ----------------------------------------------------------

    def _step_add_index(self, m: Meta, job: Job) -> bool:
        """NONE -> DELETE_ONLY -> WRITE_ONLY -> WRITE_REORG(backfill) ->
        PUBLIC (ref: ddl/index.go:280 onCreateIndex)."""
        info = self._table(m, job)
        name = job.args["index"]["name"]
        idx = info.index_by_name(name)
        if idx is None:
            idx = IndexInfo.from_json(job.args["index"])
            idx.state = SchemaState.DELETE_ONLY
            info.indexes.append(idx)
        elif idx.state == SchemaState.DELETE_ONLY:
            idx.state = SchemaState.WRITE_ONLY
        elif idx.state == SchemaState.WRITE_ONLY:
            idx.state = SchemaState.WRITE_REORG
            # reorg reads rows as of this snapshot; later writes maintain
            # the index themselves (it has been WRITE_ONLY since)
            job.snapshot_ver = m.txn.start_ts
            job.reorg_handle = None
        elif idx.state == SchemaState.WRITE_REORG:
            # run_one_step completed the backfill before this transition
            idx.state = SchemaState.PUBLIC
            job.state = JobState.DONE
        job.schema_state = int(idx.state)
        m.update_table(job.schema_id, info)
        return True

    def _step_drop_index(self, m: Meta, job: Job) -> bool:
        info = self._table(m, job)
        idx = info.index_by_name(job.args["name"])
        if idx is None:
            raise kv.KVError(f"index '{job.args['name']}' doesn't exist")
        if idx.state == SchemaState.PUBLIC:
            idx.state = SchemaState.WRITE_ONLY
        elif idx.state == SchemaState.WRITE_ONLY:
            idx.state = SchemaState.DELETE_ONLY
        else:
            info.indexes.remove(idx)
            prefix = tablecodec.index_prefix(info.id, idx.id)
            m.add_delete_range(job.id, prefix, codec.prefix_next(prefix))
            job.args["has_ranges"] = True
            job.state = JobState.DONE
        job.schema_state = int(idx.state)
        m.update_table(job.schema_id, info)
        return True

    def _step_rollback_add_index(self, m: Meta, job: Job) -> bool:
        """Walk a half-built index back down and cancel the job
        (ref: ddl/index.go onDropIndex reuse for rollback)."""
        info = self._table(m, job)
        idx = info.index_by_name(job.args["index"]["name"])
        if idx is None:
            job.state = JobState.CANCELLED
            return False
        if idx.state in (SchemaState.WRITE_REORG, SchemaState.WRITE_ONLY):
            idx.state = SchemaState.DELETE_ONLY
            m.update_table(job.schema_id, info)
        else:
            info.indexes.remove(idx)
            prefix = tablecodec.index_prefix(info.id, idx.id)
            m.add_delete_range(job.id, prefix, codec.prefix_next(prefix))
            job.args["has_ranges"] = True
            m.update_table(job.schema_id, info)
            job.state = JobState.CANCELLED
        job.schema_state = int(idx.state)
        return True

    # -- backfill ------------------------------------------------------------

    def _backfill_index(self, job: Job) -> None:
        """Checkpointed backfill: batched txns, progress persisted in the
        job (ref: ddl/index.go:541-676 addTableIndex + reorg.go)."""
        while True:
            txn = self.storage.begin()
            m = Meta(txn)
            jb = m.first_job()
            if jb is None or jb.id != job.id or \
                    jb.state != JobState.RUNNING:
                txn.rollback()
                return
            info = m.get_table(jb.schema_id, jb.table_id)
            idx = info.index_by_name(jb.args["index"]["name"]) \
                if info is not None else None
            if idx is None:
                txn.rollback()
                return
            snap = self.storage.snapshot(jb.snapshot_ver)
            tbl = Table(info, self.storage)
            start = jb.reorg_handle + 1 if jb.reorg_handle is not None \
                else None
            n = 0
            last = None
            try:
                for handle, _snap_row in tbl.iter_records(
                        snap, start_handle=start):
                    # the snapshot scan only supplies handles; entry values
                    # come from the CURRENT row in this txn, so rows
                    # updated/deleted since the snapshot (whose entries the
                    # mutating txn already maintained — the index has been
                    # WRITE_ONLY throughout) are never resurrected
                    raw = txn.get(tablecodec.record_key(info.id, handle))
                    if raw is None:
                        last = handle
                        continue
                    row = tablecodec.decode_row(raw)
                    self._write_backfill_entry(txn, info, idx, row, handle)
                    last = handle
                    n += 1
                    if n >= BACKFILL_BATCH:
                        break
            except Exception:
                txn.rollback()
                raise
            if last is not None:
                jb.reorg_handle = last
            done = n < BACKFILL_BATCH
            m.update_job(jb)
            txn.commit()
            if self.on_backfill_batch is not None:
                self.on_backfill_batch(jb, n)
            if done:
                return

    @staticmethod
    def _write_backfill_entry(txn, info: TableInfo, idx: IndexInfo,
                              row: dict, handle: int) -> None:
        vals = []
        for cname in idx.columns:
            col = info.col_by_name(cname)
            vals.append(row.get(col.id))
        if idx.unique and all(v is not None for v in vals):
            ik = tablecodec.index_key(info.id, idx.id, vals)
            existing = txn.get(ik)
            if existing is not None:
                other, _ = codec.decode_int(existing)
                if other != handle:
                    raise DupKeyError(
                        f"duplicate entry {vals} for key '{idx.name}'")
            txn.set(ik, codec.encode_int(handle))
        else:
            txn.set(tablecodec.index_key(info.id, idx.id, vals,
                                         handle=handle), b"0")
