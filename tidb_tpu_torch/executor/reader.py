"""Table reader over the store: the port of the JAX package's
TableReaderExec (executor/__init__.py), the distsql leaf.

`partials(ctx)` sends the reader's pushed CopPlan to the coprocessor
client of `ctx.storage` as one request over the table's record range at
the statement's snapshot `ctx.read_ts`, and yields each region's partial
aggregate (a GroupResult) as it arrives; `chunks(ctx)` does the same for
a scan or selection plan and applies its LIMIT. As a join child it shows
the `schema` (one SchemaCol per column of `cop.cols`), `col(name)` and
the `table` name that executor/scan.TableScan shows, so HashJoin takes
either leaf unchanged. A session statement's interrupt probe
(`ctx.check_interrupt`) runs per response. Not ported yet: the
dirty-transaction path through the union store (a read of a table its
own open transaction wrote raises) and the query feedback to the
statistics handle.
"""

from __future__ import annotations

from tidb_tpu_torch import codec, tablecodec
from tidb_tpu_torch.errcode import not_ported
from tidb_tpu_torch.executor import ExecError
from tidb_tpu_torch.expression import ColumnRef
from tidb_tpu_torch.kv import CopRequest, KVRange, ReqType
from tidb_tpu_torch.plan.physical import CopPlan
from tidb_tpu_torch.plan.resolver import SchemaCol

__all__ = ["TableReader"]


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
        if ctx.txn is not None:
            lo, hi = tablecodec.table_prefix_range(self.cop.table.id)
            for _kv in ctx.txn.us.membuf.iter_range(lo, hi):
                raise ExecError(not_ported(
                    "a read of a table its own transaction wrote (the "
                    "union scan)"))
        return CopRequest(tp=ReqType.DAG, ranges=self._ranges(),
                          plan=self.cop, start_ts=ctx.read_ts,
                          keep_order=self.keep_order)

    def partials(self, ctx):
        """Agg mode: yields GroupResults."""
        for resp in ctx.storage.client().send(self._request(ctx)):
            ctx.check_interrupt()
            yield resp.chunk

    def chunks(self, ctx):
        cop = self.cop
        assert not cop.is_agg
        remaining = cop.limit
        for resp in ctx.storage.client().send(self._request(ctx)):
            ctx.check_interrupt()
            ch = resp.chunk
            if remaining is not None:
                if remaining <= 0:
                    return
                if ch.num_rows > remaining:
                    ch = ch.slice(0, remaining)
                remaining -= ch.num_rows
            yield ch
