"""The distsql leaves over the store: the ports of the JAX package's
TableReaderExec, IndexReaderExec and IndexLookUpExec
(executor/__init__.py; ref: executor/distsql.go:297, :412, :524-737).

`TableReader.partials(ctx)` sends the reader's pushed CopPlan to the
coprocessor client of `ctx.storage` as one request over the table's
record range at the statement's snapshot `ctx.read_ts`, and yields each
region's partial aggregate (a GroupResult) as it arrives; `chunks(ctx)`
does the same for a scan or selection plan and applies its LIMIT. As a
join child it shows the `schema` (one SchemaCol per column of
`cop.cols`), `col(name)` and the `table` name that executor/scan.
TableScan shows, so HashJoin takes either leaf unchanged. A session
statement's interrupt probe (`ctx.check_interrupt`) runs per response.

In a transaction that wrote the table (`txn_is_dirty`), the reader
scans through the union store instead (ref: UnionScanExec,
executor/union_scan.go:90): the buffered writes shadow the snapshot, and
the cop plan runs over those chunks at the root, on the statement's
device (`ctx.device`), so an aggregate over them launches the
segment-sum kernel where a chunk reaches `tidb_tpu_device_min_rows`.
A full scan with a feedback range reports its true row count to the
statistics handle (`StatsHandle.feedback_range`).

`IndexReader` decodes index entries instead of rows. `IndexLookUp`
streams handles from an index scan in batches of 1024 and fetches their
rows with batched point reads on a pool of 4 workers, in submission
order. One deviation: the workers only read and decode; the table cop
plan over each fetched batch runs on the statement's thread, which holds
the statement's scheduler slots (the JAX package runs it on the worker,
a thread that holds none and must wait for a slot the statement's
thread may hold).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

from tidb_tpu_torch import codec, tablecodec
from tidb_tpu_torch.expression import ColumnRef
from tidb_tpu_torch.kv import CopRequest, KVRange, ReqType
from tidb_tpu_torch.plan.physical import CopPlan
from tidb_tpu_torch.plan.resolver import SchemaCol
from tidb_tpu_torch.store.copr import exec_cop_plan
from tidb_tpu_torch.table import index_kvrows_to_chunk, kvrows_to_chunk

__all__ = ["TableReader", "IndexReader", "IndexLookUp", "txn_is_dirty"]

# rows per union-store chunk (the JAX package's _dirty_chunks batch)
_DIRTY_BATCH = 65536


def txn_is_dirty(ctx, table_id: int) -> bool:
    """Has the statement's transaction buffered a write to `table_id`?"""
    if ctx.txn is None:
        return False
    lo, hi = tablecodec.table_prefix_range(table_id)
    return ctx.txn.us.membuf.any_in_range(lo, hi)


class TableReader:
    """distsql leaf over one table's pushed subplan `cop`."""

    def __init__(self, cop: CopPlan, keep_order: bool = False):
        self.cop = cop
        self.keep_order = keep_order
        self.table = cop.table.name
        self.schema = [SchemaCol(c.name, self.table, c.ft, c.id)
                       for c in cop.cols]

    def col(self, name: str) -> ColumnRef:
        """A ColumnRef to this reader's column `name`."""
        j = next(i for i, c in enumerate(self.schema) if c.name == name)
        return ColumnRef(j, self.schema[j].ft, name)

    def _ranges(self):
        cop = self.cop
        if cop.ranges is not None:
            return cop.ranges
        lo = tablecodec.record_prefix(cop.table.id)
        return [KVRange(lo, codec.prefix_next(lo))]

    def _request(self, ctx) -> CopRequest:
        return CopRequest(tp=ReqType.DAG, ranges=self._ranges(),
                          plan=self.cop, start_ts=ctx.read_ts,
                          keep_order=self.keep_order)

    def partials(self, ctx):
        """Agg mode: yields GroupResults."""
        cop = self.cop
        if txn_is_dirty(ctx, cop.table.id):
            for chunk in self._dirty_chunks(ctx):
                yield exec_cop_plan(cop, chunk, device=ctx.device).chunk
            return
        for resp in ctx.storage.client().send(self._request(ctx)):
            ctx.check_interrupt()
            yield resp.chunk

    def chunks(self, ctx):
        cop = self.cop
        assert not cop.is_agg
        if txn_is_dirty(ctx, cop.table.id):
            for chunk in self._dirty_chunks(ctx):
                yield exec_cop_plan(cop, chunk, device=ctx.device).chunk
            return
        req = self._request(ctx)
        if cop.feedback is not None and cop.limit is None:
            yield from self._chunks_with_feedback(ctx, req)
            return
        remaining = cop.limit
        for resp in ctx.storage.client().send(req):
            ctx.check_interrupt()
            ch = resp.chunk
            if remaining is not None:
                if remaining <= 0:
                    return
                if ch.num_rows > remaining:
                    ch = ch.slice(0, remaining)
                remaining -= ch.num_rows
            yield ch

    def _chunks_with_feedback(self, ctx, req):
        """Stream the scan while counting its rows; report the range's
        true cardinality to the stats handle afterwards (ref:
        statistics/update.go:88, QueryFeedback at the reader)."""
        cop = self.cop
        actual = 0
        for resp in ctx.storage.client().send(req):
            ctx.check_interrupt()
            actual += resp.chunk.num_rows
            yield resp.chunk
        col_id, dranges = cop.feedback
        try:
            from tidb_tpu_torch.session import Domain
            Domain.get(ctx.storage).stats_handle().feedback_range(
                cop.table.id, col_id, dranges, actual)
        except Exception:   # noqa: BLE001 - feedback must never fail reads
            pass

    def _decode_rows(self, rows):
        cop = self.cop
        return kvrows_to_chunk(cop.table, cop.cols, rows, cop.handle_col)

    def _dirty_chunks(self, ctx):
        """Union-store scan: buffered writes shadow the snapshot. The
        last chunk may be empty (a table the transaction emptied)."""
        rows = []
        for rng in self._ranges():
            for k, v in ctx.txn.iter_range(rng.start, rng.end):
                rows.append((k, v))
                if len(rows) >= _DIRTY_BATCH:
                    yield self._decode_rows(rows)
                    rows = []
        yield self._decode_rows(rows)


class IndexReader(TableReader):
    """Covering-index distsql leaf: the same client machinery; the
    storage side decodes index entries instead of rows."""

    def _decode_rows(self, rows):
        cop = self.cop
        return index_kvrows_to_chunk(cop.table, cop.index, cop.cols, rows,
                                     cop.handle_col)


class IndexLookUp:
    """Index scan -> handle batches -> parallel batched row fetch, in
    submission order."""

    BATCH = 1024              # handles per lookup task
    LOOKUP_CONCURRENCY = 4    # ref: IndexLookupConcurrency default

    def __init__(self, index_cop: CopPlan, table_cop: CopPlan,
                 keep_order: bool, schema):
        self.index_cop = index_cop
        self.table_cop = table_cop
        self.keep_order = keep_order
        self.table = table_cop.table.name
        self.schema = list(schema)

    def _handle_batches(self, ctx):
        icop = self.index_cop
        req = CopRequest(tp=ReqType.DAG, ranges=icop.ranges, plan=icop,
                         start_ts=ctx.read_ts, keep_order=self.keep_order)
        batch: list[int] = []
        hcol = icop.handle_col
        for resp in ctx.storage.client().send(req):
            ctx.check_interrupt()
            for h in resp.chunk.columns[hcol].data.tolist():
                batch.append(h)
                if len(batch) >= self.BATCH:
                    yield batch
                    batch = []
        if batch:
            yield batch

    def _fetch_rows(self, ctx, handles: list[int]):
        """One batch's rows, read and decoded on a pool worker."""
        tcop = self.table_cop
        snap = ctx.storage.snapshot(ctx.read_ts)
        keys = [tablecodec.record_key(tcop.table.id, h) for h in handles]
        got = snap.batch_get(keys)
        kvrows = [(k, got[k]) for k in keys if k in got]
        return kvrows_to_chunk(tcop.table, tcop.cols, kvrows,
                               tcop.handle_col)

    def chunks(self, ctx):
        tcop = self.table_cop
        if txn_is_dirty(ctx, tcop.table.id):
            # own writes visible: all conjuncts are kept in the residual
            # filters, so a full union-store scan is equivalent
            reader = TableReader(tcop)
            reader.schema = self.schema
            yield from reader.chunks(ctx)
            return
        pool = ThreadPoolExecutor(max_workers=self.LOOKUP_CONCURRENCY,
                                  thread_name_prefix="idxlookup")
        pending = deque()
        try:
            for batch in self._handle_batches(ctx):
                pending.append(pool.submit(self._fetch_rows, ctx, batch))
                while len(pending) >= self.LOOKUP_CONCURRENCY:
                    yield self._table_plan(ctx, pending.popleft().result())
            while pending:
                yield self._table_plan(ctx, pending.popleft().result())
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def _table_plan(self, ctx, chunk):
        return exec_cop_plan(self.table_cop, chunk, device=ctx.device).chunk
