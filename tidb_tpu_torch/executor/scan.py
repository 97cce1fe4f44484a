"""Table scans over one table's chunks in hand.

What the JAX package's coprocessor does for a selection-only cop plan
(store/copr.exec_cop_plan): each chunk of the table is filtered on the
host, first by the host filter (the string conjuncts), then by the
pushed filter, with `runtime.eval_filter_host`. The chunks come from the
run's context (`ctx.tables`): this is the leaf of the chunk path's entry
points (executor/agg.run_q3 / run_q5). Reads through the store take
executor/reader.TableReader instead (run_q3_store / run_q5_store).
"""

from __future__ import annotations

from tidb_tpu_torch.expression import ColumnRef
from tidb_tpu_torch.ops.runtime import eval_filter_host
from tidb_tpu_torch.plan.resolver import SchemaCol

__all__ = ["TableScan"]


class TableScan:
    """Scan of table `table` with the columns `columns` ([(name, ft)], in
    the table's DDL order): `filter` is the pushed (device-safe)
    predicate, `host_filter` the string one."""

    def __init__(self, table: str, columns, filter=None, host_filter=None):
        self.table = table
        self.schema = [SchemaCol(name, table, ft) for name, ft in columns]
        self.filter = filter
        self.host_filter = host_filter

    def col(self, name: str) -> ColumnRef:
        """A ColumnRef to this scan's column `name`."""
        j = next(i for i, c in enumerate(self.schema) if c.name == name)
        return ColumnRef(j, self.schema[j].ft, name)

    def chunks(self, ctx):
        for chunk in ctx.tables[self.table]:
            for flt in (self.host_filter, self.filter):
                if flt is not None and chunk.num_rows:
                    chunk = chunk.filter(eval_filter_host(flt, chunk))
            if chunk.num_rows:
                yield chunk
