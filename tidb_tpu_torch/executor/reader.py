"""Table reader over the store: the port of the JAX package's
TableReaderExec (executor/__init__.py), the distsql leaf.

`partials(ctx)` sends the reader's pushed CopPlan to the coprocessor
client of `ctx.storage` as one request over the table's record range at
the statement's snapshot `ctx.read_ts`, and yields each region's partial
aggregate (a GroupResult) as it arrives; `chunks(ctx)` does the same for
a scan or selection plan and applies its LIMIT. As a join child it shows
the `schema` (one SchemaCol per column of `cop.cols`), `col(name)` and
the `table` name that executor/scan.TableScan shows, so HashJoin takes
either leaf unchanged. Left out, with the session that owns them: the dirty-transaction fallback through the union
store (a reader inside a transaction with its own writes) and the query
feedback to the statistics handle.
"""

from __future__ import annotations

from tidb_tpu_torch import codec, tablecodec
from tidb_tpu_torch.executor.scan import SchemaCol
from tidb_tpu_torch.expression import ColumnRef
from tidb_tpu_torch.kv import CopRequest, KVRange, ReqType
from tidb_tpu_torch.plan.physical import CopPlan

__all__ = ["TableReader"]


class TableReader:
    """distsql leaf over one table's pushed subplan `cop`."""

    def __init__(self, cop: CopPlan, keep_order: bool = False):
        self.cop = cop
        self.keep_order = keep_order
        self.table = cop.table.name
        self.schema = [SchemaCol(self.table, c.name, c.ft)
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
        for resp in ctx.storage.client().send(self._request(ctx)):
            yield resp.chunk

    def chunks(self, ctx):
        cop = self.cop
        assert not cop.is_agg
        remaining = cop.limit
        for resp in ctx.storage.client().send(self._request(ctx)):
            ch = resp.chunk
            if remaining is not None:
                if remaining <= 0:
                    return
                if ch.num_rows > remaining:
                    ch = ch.slice(0, remaining)
                remaining -= ch.num_rows
            yield ch
