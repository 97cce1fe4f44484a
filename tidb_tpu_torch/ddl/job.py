"""DDL job model.

Reference: TiDB's model/ddl.go:126 (Job) — a serializable record
that walks the F1 state machine one transition per meta transaction, so any
worker (and any crash) leaves the cluster in a consistent, resumable state.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum


class JobType(Enum):
    CREATE_SCHEMA = "create schema"
    DROP_SCHEMA = "drop schema"
    CREATE_TABLE = "create table"
    DROP_TABLE = "drop table"
    TRUNCATE_TABLE = "truncate table"
    RENAME_TABLE = "rename table"
    ADD_COLUMN = "add column"
    DROP_COLUMN = "drop column"
    MODIFY_COLUMN = "modify column"
    ADD_INDEX = "add index"
    DROP_INDEX = "drop index"


class JobState(Enum):
    QUEUEING = "queueing"
    RUNNING = "running"
    ROLLBACK = "rollback"      # failed mid-flight; walking states backwards
    DONE = "done"
    CANCELLED = "cancelled"


@dataclass
class Job:
    id: int = 0
    tp: JobType = JobType.CREATE_TABLE
    schema_id: int = 0
    table_id: int = 0
    state: JobState = JobState.QUEUEING
    # args: per-type payload (json-able); e.g. TableInfo dict for
    # CREATE_TABLE, index def for ADD_INDEX
    args: dict = field(default_factory=dict)
    schema_state: int = 0          # model.SchemaState of the target object
    snapshot_ver: int = 0          # read snapshot for reorg backfill
    reorg_handle: int | None = None  # backfill checkpoint (ref: reorg.go:71)
    error: str = ""
    error_count: int = 0
    seq: int = 0                   # queue position (set by meta)

    def dumps(self) -> bytes:
        return json.dumps({
            "id": self.id, "tp": self.tp.value, "schema_id": self.schema_id,
            "table_id": self.table_id, "state": self.state.value,
            "args": self.args, "schema_state": self.schema_state,
            "snapshot_ver": self.snapshot_ver,
            "reorg_handle": self.reorg_handle, "error": self.error,
            "error_count": self.error_count, "seq": self.seq,
        }).encode()

    @staticmethod
    def loads(raw: bytes) -> "Job":
        o = json.loads(raw)
        return Job(id=o["id"], tp=JobType(o["tp"]),
                   schema_id=o["schema_id"], table_id=o["table_id"],
                   state=JobState(o["state"]), args=o["args"],
                   schema_state=o["schema_state"],
                   snapshot_ver=o["snapshot_ver"],
                   reorg_handle=o["reorg_handle"], error=o["error"],
                   error_count=o["error_count"], seq=o["seq"])

    @property
    def finished(self) -> bool:
        return self.state in (JobState.DONE, JobState.CANCELLED)
