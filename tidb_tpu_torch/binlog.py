"""Binlog: transaction change-capture stream.

The port's copy of the JAX package's binlog.py (ref: sessionctx/
binloginfo, the pump client hook, binloginfo.go:40-61; the 2PC
prewrite/commit binlog writes, store/tikv/2pc.go:664-697; tidb.go:275,
the pump gRPC client). The reference ships every txn's prewrite payload
plus a commit record to an external "pump" process; here the pump is a
pluggable sink fed once per successfully committed transaction with
(start_ts, commit_ts, mutations): the same information, one event
instead of two wire messages. The commit hook is store/txn.py's
`commit`, which writes to `storage.binlog_pump` where one is set.

Consumers decode row-level changes with `decode_row_events`: record-key
mutations become (table_id, handle, op, column values)."""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

from tidb_tpu_torch import tablecodec
from tidb_tpu_torch.kv import Mutation, MutationOp

__all__ = ["BinlogEvent", "MemoryPump", "RowChange", "decode_row_events"]


@dataclass(frozen=True)
class BinlogEvent:
    start_ts: int
    commit_ts: int
    mutations: tuple          # ((op_name, key, value|None), ...)


@dataclass(frozen=True)
class RowChange:
    table_id: int
    handle: int
    op: str                   # "PUT" | "DELETE"
    values: dict | None       # column_id -> datum (None for DELETE)


class MemoryPump:
    """Bounded in-process sink (the test/devel pump; a network pump
    implements the same write())."""

    def __init__(self, cap: int = 4096):
        self._mu = threading.Lock()
        self._events: deque = deque(maxlen=cap)
        self._subs: list = []

    def write(self, event: BinlogEvent) -> None:
        with self._mu:
            self._events.append(event)
            subs = list(self._subs)
        for fn in subs:
            try:
                fn(event)
            except Exception:   # noqa: BLE001 - sinks never break commits
                pass

    def subscribe(self, fn) -> None:
        with self._mu:
            self._subs.append(fn)

    def events(self, since_commit_ts: int = 0) -> list[BinlogEvent]:
        """Events in commit_ts order. Concurrent committers may ARRIVE
        out of ts order (commit_ts allocation and the pump write are not
        one atomic step); readers see the sorted stream, subscribers get
        best-effort arrival order."""
        with self._mu:
            return sorted((e for e in self._events
                           if e.commit_ts > since_commit_ts),
                          key=lambda e: e.commit_ts)


def make_event(start_ts: int, commit_ts: int,
               mutations: dict[bytes, Mutation]):
    """-> BinlogEvent, or None when nothing changed (a FOR UPDATE txn's
    LOCK mutations are concurrency control, not data changes — CDC
    consumers must never see phantom rows for them)."""
    muts = tuple(sorted(
        (m.op.name, k, m.value if m.op == MutationOp.PUT else None)
        for k, m in mutations.items() if m.op != MutationOp.LOCK))
    if not muts:
        return None
    return BinlogEvent(start_ts=start_ts, commit_ts=commit_ts,
                       mutations=muts)


def decode_row_events(event: BinlogEvent) -> list[RowChange]:
    """Record-key mutations -> row changes (index/meta keys skipped:
    consumers reconstruct indexes from row values, as CDC sinks do)."""
    out = []
    for op, key, value in event.mutations:
        try:
            table_id, handle = tablecodec.decode_record_key(key)
        except (ValueError, IndexError):
            continue
        values = None
        if op == "PUT" and value is not None:
            try:
                values = tablecodec.decode_row(value)
            except (ValueError, IndexError):
                values = None
        out.append(RowChange(table_id=table_id, handle=handle, op=op,
                             values=values))
    return out
