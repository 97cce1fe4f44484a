"""Schema metadata on the KV plane.

Reference: TiDB's meta/meta.go:55-178, layered on structure/
TxStructure exactly as the reference is: databases live in one "DBs"
hash (dbID -> DBInfo json), each database's tables in a "DB:{id}" hash
(tableID -> TableInfo), counters in strings, the DDL job queue in a
list, DDL history in a hash (meta.go:443-457 EnQueue/DeQueue/history).
Every op runs inside the caller's transaction so metadata mutations
commit atomically with schema version bumps.

All structure keys live under the "m" namespace, disjoint from table
data ("t..." keys)."""

from __future__ import annotations

import json

from tidb_tpu_torch import kv
from tidb_tpu_torch.schema.model import DBInfo, TableInfo
from tidb_tpu_torch.structure import TxStructure

__all__ = ["Meta", "MetaError"]


class MetaError(Exception):
    pass


def _f(n: int) -> bytes:
    return b"%020d" % n


class Meta:
    """Meta operations inside one kv.Transaction (like the reference, every
    meta op set runs in its caller's txn for atomicity with schema version
    bumps)."""

    NEXT_ID_KEY = b"NextGlobalID"
    SCHEMA_VERSION_KEY = b"SchemaVersion"
    DBS_KEY = b"DBs"
    JOB_LIST_KEY = b"DDLJobList"
    JOB_HISTORY_KEY = b"DDLJobHistory"
    SCHEMA_DIFF_KEY = b"SchemaDiffs"
    DELETE_RANGE_KEY = b"DeleteRanges"

    def __init__(self, txn: kv.Transaction):
        self.txn = txn
        self.t = TxStructure(txn, prefix=b"m")

    # -- id allocation -------------------------------------------------------

    def gen_global_id(self) -> int:
        return self.t.inc(self.NEXT_ID_KEY)

    def gen_schema_version(self) -> int:
        """Ref: meta.go:177 GenSchemaVersion."""
        return self.t.inc(self.SCHEMA_VERSION_KEY)

    def schema_version(self) -> int:
        return self.t.get_int(self.SCHEMA_VERSION_KEY)

    # -- auto increment ------------------------------------------------------

    def gen_auto_id(self, table_id: int, step: int) -> tuple[int, int]:
        """Allocate [base+1, base+step]; returns (first, last).
        Ref: meta/autoid batched allocator (autoid.go:36-46)."""
        last = self.t.inc(b"AutoID:" + _f(table_id), step)
        return last - step + 1, last

    def rebase_auto_id(self, table_id: int, at_least: int) -> None:
        key = b"AutoID:" + _f(table_id)
        if at_least > self.t.get_int(key):
            self.t.set(key, b"%d" % at_least)

    # -- databases (ref: meta.go mDBs hash) ----------------------------------

    def create_database(self, db: DBInfo) -> None:
        if self.t.hget(self.DBS_KEY, _f(db.id)) is not None:
            raise MetaError(f"db {db.id} already exists")
        self.t.hset(self.DBS_KEY, _f(db.id), db.dumps())

    def drop_database(self, db_id: int) -> None:
        self.t.hdel(self.DBS_KEY, _f(db_id))
        self.t.hclear(b"DB:" + _f(db_id))

    def get_database(self, db_id: int) -> DBInfo | None:
        raw = self.t.hget(self.DBS_KEY, _f(db_id))
        return DBInfo.loads(raw) if raw else None

    def list_databases(self) -> list[DBInfo]:
        return [DBInfo.loads(v) for _f_, v in self.t.hgetall(self.DBS_KEY)]

    # -- tables (ref: meta.go mDBPrefix hash per db) -------------------------

    def create_table(self, db_id: int, tbl: TableInfo) -> None:
        if self.get_database(db_id) is None:
            raise MetaError(f"db {db_id} does not exist")
        if self.t.hget(b"DB:" + _f(db_id), _f(tbl.id)) is not None:
            raise MetaError(f"table {tbl.id} already exists")
        self.t.hset(b"DB:" + _f(db_id), _f(tbl.id), tbl.dumps())

    def update_table(self, db_id: int, tbl: TableInfo) -> None:
        self.t.hset(b"DB:" + _f(db_id), _f(tbl.id), tbl.dumps())

    def drop_table(self, db_id: int, table_id: int) -> None:
        self.t.hdel(b"DB:" + _f(db_id), _f(table_id))

    def get_table(self, db_id: int, table_id: int) -> TableInfo | None:
        raw = self.t.hget(b"DB:" + _f(db_id), _f(table_id))
        return TableInfo.loads(raw) if raw else None

    def list_tables(self, db_id: int) -> list[TableInfo]:
        return [TableInfo.loads(v)
                for _f_, v in self.t.hgetall(b"DB:" + _f(db_id))]

    # -- DDL job queue (ref: meta.go:443-457 EnQueue/DeQueue/history) --------

    JOB_SEQ_KEY = b"DDLJobSeq"

    def enqueue_job(self, job) -> None:
        job.seq = self.t.inc(self.JOB_SEQ_KEY)
        self.t.rpush(self.JOB_LIST_KEY, job.dumps())

    def first_job(self):
        from tidb_tpu_torch.ddl.job import Job
        raw = self.t.lindex(self.JOB_LIST_KEY, 0)
        return Job.loads(raw) if raw else None

    def _job_index(self, job) -> int | None:
        from tidb_tpu_torch.ddl.job import Job
        for i, raw in enumerate(self.t.litems(self.JOB_LIST_KEY)):
            if Job.loads(raw).seq == job.seq:
                return i
        return None

    def update_job(self, job) -> None:
        i = self._job_index(job)
        if i is None:
            raise MetaError(f"job seq {job.seq} not in queue")
        self.t.lset(self.JOB_LIST_KEY, i, job.dumps())

    def finish_job(self, job) -> None:
        """Move from queue to history (ref: job to history queue)."""
        i = self._job_index(job)
        if i is not None:
            self.t.lrem_at(self.JOB_LIST_KEY, i)
        self.t.hset(self.JOB_HISTORY_KEY, _f(job.id), job.dumps())

    def history_job(self, job_id: int):
        from tidb_tpu_torch.ddl.job import Job
        raw = self.t.hget(self.JOB_HISTORY_KEY, _f(job_id))
        return Job.loads(raw) if raw else None

    # -- schema diffs (ref: model.SchemaDiff; consumed by the schema
    # validator and incremental infoschema reload) ---------------------------

    def set_schema_diff(self, version: int, table_ids: list[int]) -> None:
        self.t.hset(self.SCHEMA_DIFF_KEY, _f(version),
                    json.dumps(table_ids).encode())

    def schema_diff(self, version: int) -> list[int] | None:
        raw = self.t.hget(self.SCHEMA_DIFF_KEY, _f(version))
        return json.loads(raw) if raw else None

    # -- delete-range queue (ref: ddl/delete_range.go:51 inserts into
    # mysql.gc_delete_range; drained by the GC worker) -----------------------

    DR_SEQ_KEY = b"DeleteRangeSeq"

    def add_delete_range(self, job_id: int, start: bytes, end: bytes) -> None:
        seq = self.t.inc(self.DR_SEQ_KEY)
        # ts stays 0 until the job's txn COMMITS; the worker then seals the
        # range with a fresh timestamp (>= the drop's commit ts). GC only
        # drains sealed ranges whose seal ts <= safepoint, so snapshots
        # that still see the pre-drop schema can still read the data
        # (ref: gc_delete_range.ts, written after the job finishes).
        # Fields are job-prefixed so sealing is a per-job prefix scan; GC
        # re-seals orphans (job finished but seal crashed) so nothing leaks.
        rec = json.dumps({"job": job_id, "start": start.hex(),
                          "end": end.hex(), "ts": 0}).encode()
        self.t.hset(self.DELETE_RANGE_KEY, _f(job_id) + b"/" + _f(seq), rec)

    def seal_delete_ranges(self, job_id: int, ts: int) -> None:
        """Stamp a finished job's ranges as deletable once safepoint > ts."""
        for f, v in self.t.hscan_prefix(self.DELETE_RANGE_KEY,
                                        _f(job_id) + b"/"):
            o = json.loads(v)
            if not o["ts"]:
                o["ts"] = ts
                self.t.hset(self.DELETE_RANGE_KEY, f,
                            json.dumps(o).encode())

    def pending_delete_ranges(self
                              ) -> list[tuple[bytes, int, bytes, bytes, int]]:
        """-> [(queue_field, job_id, start, end, ts)]"""
        out = []
        for f, v in self.t.hgetall(self.DELETE_RANGE_KEY):
            o = json.loads(v)
            out.append((f, o["job"], bytes.fromhex(o["start"]),
                        bytes.fromhex(o["end"]), o.get("ts", 0)))
        return out

    def remove_delete_range(self, queue_field: bytes) -> None:
        self.t.hdel(self.DELETE_RANGE_KEY, queue_field)
