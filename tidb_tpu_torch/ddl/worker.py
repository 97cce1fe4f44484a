"""Online DDL worker: the F1 schema-change state machine.

The port's copy of the JAX package's ddl/worker.py for the jobs of
CREATE/DROP DATABASE and CREATE/DROP TABLE (reference: TiDB's
ddl/ddl_worker.go:33-320, the job loop, one state transition per meta
transaction; ddl/delete_range.go:51, deferred range deletion;
model/model.go:27-37, schema states). The column and index jobs (ADD
and DROP COLUMN and INDEX, MODIFY COLUMN, with the add-index backfill
and its rollback), TRUNCATE and RENAME are not ported yet: the DDL
front end (ddl/__init__.py) refuses their statements.

Every transition runs in its own meta transaction and bumps the global
schema version with a SchemaDiff record, so concurrent sessions reload
incrementally and the schema validator can detect conflicting commits.
A crash between any two transactions leaves a resumable state: the job
queue and the reorg checkpoint are the only progress markers.
"""

from __future__ import annotations

from typing import Callable, Optional

from tidb_tpu_torch import kv, tablecodec
from tidb_tpu_torch.ddl.job import Job, JobState, JobType
from tidb_tpu_torch.meta import Meta
from tidb_tpu_torch.schema.model import DBInfo, SchemaState, TableInfo

__all__ = ["DDLWorker", "JobFailed"]


class JobFailed(kv.KVError):
    """Raised by run_job for a job that finished CANCELLED."""


class DDLWorker:
    """Single DDL owner (the reference elects one via etcd, owner/manager.go;
    in-process there is exactly one — multi-server deployments point every
    server's worker at the same job queue and the queue pop serializes)."""

    def __init__(self, storage,
                 on_state_change: Optional[Callable[[Job], None]] = None):
        self.storage = storage
        self.on_state_change = on_state_change

    # -- driving -------------------------------------------------------------

    def run_job(self, job_id: int, between_steps=None) -> Job:
        """Run queue steps until job_id finishes; raise if cancelled.
        `between_steps()` (owner-lease renewal + per-version convergence,
        tidb_tpu_torch/session Domain) runs after every transition; returning
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
        fresh.state = JobState.CANCELLED
        m.finish_job(fresh)
        txn.commit()

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, m: Meta, job: Job) -> bool:
        return {
            JobType.CREATE_SCHEMA: self._step_create_schema,
            JobType.DROP_SCHEMA: self._step_drop_schema,
            JobType.CREATE_TABLE: self._step_create_table,
            JobType.DROP_TABLE: self._step_drop_table,
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
