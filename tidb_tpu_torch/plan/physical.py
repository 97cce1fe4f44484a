"""The pushed-down subplan a storage node executes next to the data.

A copy of `CopPlan` from the JAX package's plan/physical.py, over the
port's expressions and AggDesc. The rest of that module (the root-side
physical plans) comes with the planner.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from tidb_tpu_torch.expression import AggDesc, Expression
from tidb_tpu_torch.kv import KVRange
from tidb_tpu_torch.schema.model import ColumnInfo, IndexInfo, TableInfo

__all__ = ["CopPlan"]


@dataclass
class CopPlan:
    """Storage-side subplan: scan -> [host_filter] -> [filter] ->
    [partial agg] -> [limit], executed per region."""

    table: TableInfo
    cols: list[ColumnInfo]                  # scan output, in order
    handle_col: Optional[int] = None        # emit handle at this position
    ranges: Optional[list[KVRange]] = None  # None = whole table
    filter: Optional[Expression] = None     # device-safe conjuncts
    host_filter: Optional[Expression] = None  # string/varlen conjuncts
    group_exprs: Optional[list[Expression]] = None
    aggs: Optional[list[AggDesc]] = None
    limit: Optional[int] = None             # only when no aggs
    desc: bool = False
    index: Optional[IndexInfo] = None       # index scan: decode index keys
    # (col_id, DatumRanges) of a pure pk-range scan: the reader reports
    # actual row counts back to the stats handle (query feedback)
    feedback: Optional[tuple] = None
    # USE/IGNORE/FORCE INDEX hints from the table factor
    index_hints: list = field(default_factory=list)

    @property
    def is_agg(self) -> bool:
        return self.aggs is not None
