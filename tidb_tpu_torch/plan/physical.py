"""Physical plan nodes: the port's copy of the JAX package's
plan/physical.py. executor/builder.py lowers each onto the port's
operators.

Reference: TiDB's plan/physical_plans.go + the copTask/rootTask
split of plan/task.go:31-49 — `CopPlan` is the pushed-down subplan a
storage node executes next to the data (the tipb.DAGRequest analogue,
plan/plan_to_pb.go:30), everything else runs at the root.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from tidb_tpu_torch.expression import AggDesc, Expression
from tidb_tpu_torch.kv import KVRange
from tidb_tpu_torch.plan.resolver import PlanSchema
from tidb_tpu_torch.schema.model import ColumnInfo, IndexInfo, TableInfo

__all__ = ["CopPlan", "PhysPlan", "PhysTableReader", "PhysIndexReader",
           "PhysIndexLookUp", "PhysPointGet", "PhysSelection",
           "PhysProjection", "PhysHashAgg", "PhysFinalAgg", "PhysStreamAgg",
           "PhysHashJoin", "PhysMergeJoin", "PhysIndexJoin",
           "PhysApply", "PhysSort", "PhysLimit", "PhysTopN", "PhysInsert",
           "PhysUpdate", "PhysDelete", "PhysMultiDelete", "PhysValues"]


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


@dataclass
class PhysPlan:
    schema: PlanSchema = field(default_factory=PlanSchema)
    children: list = field(default_factory=list)

    est_rows = None   # CBO row estimate, set by the planner when stats exist
    cacheable = True  # False when plan-time folds are volatile (NOW(), ...)

    def explain(self, depth: int = 0) -> str:
        name = type(self).__name__.replace("Phys", "")
        line = "  " * depth + name + self._explain_info()
        if self.est_rows is not None:
            line += f" est_rows:{self.est_rows:.0f}"
        return "\n".join([line] + [c.explain(depth + 1)
                                   for c in self.children])

    def explain_nodes(self, depth: int = 0):
        """(depth, node) pairs in tree order — the per-node form of
        explain(), so EXPLAIN ANALYZE can pair each rendered line with
        the node's runtime stats. Sub-plans hanging off dedicated
        attributes (Apply's inner, DML readers/sources) are included."""
        yield depth, self
        for c in self.children:
            yield from c.explain_nodes(depth + 1)
        for attr in ("inner", "reader", "source"):
            sub = getattr(self, attr, None)
            if isinstance(sub, PhysPlan):
                yield from sub.explain_nodes(depth + 1)

    def explain_line(self) -> str:
        """One node's operator name + info (no children; PhysApply's
        _explain_info embeds the inner tree inline — strip it)."""
        name = type(self).__name__.replace("Phys", "")
        return name + self._explain_info().split("\n", 1)[0]

    def _explain_info(self) -> str:
        return ""


@dataclass
class PhysTableReader(PhysPlan):
    cop: CopPlan = None
    keep_order: bool = False   # handle-ordered delivery (merge join feeds)

    def _explain_info(self):
        parts = [f" table:{self.cop.table.name}"]
        if self.keep_order:
            parts.append(" keep_order")
        if self.cop.filter is not None:
            parts.append(f" pushed_filter:{self.cop.filter!r}")
        if self.cop.host_filter is not None:
            parts.append(f" host_filter:{self.cop.host_filter!r}")
        if self.cop.is_agg:
            parts.append(f" partial_agg:{self.cop.aggs!r}")
        if self.cop.limit is not None:
            parts.append(f" limit:{self.cop.limit}")
        return ",".join(parts)


@dataclass
class PhysIndexReader(PhysPlan):
    """Covering-index scan: the cop subplan scans index keys only and its
    decoded columns satisfy the whole reader schema (ref:
    executor/distsql.go:412 IndexReaderExecutor)."""

    cop: CopPlan = None

    def _explain_info(self):
        return (f" table:{self.cop.table.name} index:{self.cop.index.name}"
                f" ranges:{len(self.cop.ranges or [])}")


@dataclass
class PhysIndexLookUp(PhysPlan):
    """Index scan -> handles -> batched row fetch (ref:
    executor/distsql.go:524 IndexLookUpExecutor). `index_cop` scans and
    decodes index entries (index cols + handle); residual filters over the
    fetched full rows live in `table_cop` (ranges unused there)."""

    index_cop: CopPlan = None
    table_cop: CopPlan = None
    keep_order: bool = False

    def _explain_info(self):
        parts = [f" table:{self.table_cop.table.name}"
                 f" index:{self.index_cop.index.name}"
                 f" ranges:{len(self.index_cop.ranges or [])}"]
        if self.table_cop.filter is not None:
            parts.append(f" filter:{self.table_cop.filter!r}")
        if self.table_cop.host_filter is not None:
            parts.append(f" host_filter:{self.table_cop.host_filter!r}")
        return ",".join(parts)


@dataclass
class PhysPointGet(PhysPlan):
    """Single-row fetch by handle or unique index point (ref: the point-get
    fast path, executor/adapter.go:381). Bypasses the coprocessor."""

    table: TableInfo = None
    cols: list = field(default_factory=list)   # ColumnInfo to emit
    handle_col: Optional[int] = None
    handle: Optional[int] = None               # pk-is-handle point
    index: Optional[IndexInfo] = None          # or unique-index point
    index_values: Optional[list] = None
    filter: Optional[Expression] = None        # residual conjuncts

    def _explain_info(self):
        via = f"handle:{self.handle}" if self.index is None else \
            f"index:{self.index.name}"
        return f" table:{self.table.name} {via}"


@dataclass
class PhysSelection(PhysPlan):
    cond: Expression = None

    def _explain_info(self):
        return f" cond:{self.cond!r}"


@dataclass
class PhysProjection(PhysPlan):
    exprs: list = field(default_factory=list)

    def _explain_info(self):
        return f" exprs:{self.exprs!r}"


@dataclass
class PhysHashAgg(PhysPlan):
    """Root-side complete aggregation (input = raw rows)."""

    group_exprs: list = field(default_factory=list)
    aggs: list = field(default_factory=list)

    def _explain_info(self):
        return f" group:{self.group_exprs!r} aggs:{self.aggs!r}"


@dataclass
class PhysFinalAgg(PhysPlan):
    """Root-side merge of storage-side partial agg results."""

    aggs: list = field(default_factory=list)
    num_group_cols: int = 0

    def _explain_info(self):
        return f" aggs:{self.aggs!r}"


@dataclass
class PhysStreamAgg(PhysPlan):
    """Sort-based aggregation: sort child rows by the group keys, then
    segment-reduce on device (ref: executor/aggregate.go:150-170
    StreamAggExec over sorted input). Chosen by the cost pass when the
    estimated group cardinality would blow the hash kernel's device
    table, or when the child already delivers key-contiguous rows
    (sorted_input=True skips the sort)."""

    group_exprs: list = field(default_factory=list)
    aggs: list = field(default_factory=list)
    sorted_input: bool = False

    def _explain_info(self):
        s = " sorted" if self.sorted_input else ""
        return f"{s} group:{self.group_exprs!r} aggs:{self.aggs!r}"


@dataclass
class PhysHashJoin(PhysPlan):
    left_keys: list = field(default_factory=list)
    right_keys: list = field(default_factory=list)
    # inner/left/right, plus semi/anti (decorrelated EXISTS/IN: emit
    # probe rows by match existence, never the joined width)
    join_type: str = "inner"
    other_cond: Optional[Expression] = None

    def _explain_info(self):
        return (f" type:{self.join_type} lkeys:{self.left_keys!r} "
                f"rkeys:{self.right_keys!r}")


@dataclass
class PhysMergeJoin(PhysPlan):
    """Sorted-merge equi-join (ref: executor/merge_join.go:34). Both
    children deliver rows sorted ascending by their single join key (the
    planner guarantees it: pk-handle table scans are key-ordered, and
    index readers with keep_order deliver index order); the executor
    streams both sides with a bounded window — no full build-side
    materialization."""

    left_keys: list = field(default_factory=list)   # single-expr today
    right_keys: list = field(default_factory=list)
    join_type: str = "inner"       # inner/left
    other_cond: Optional[Expression] = None

    def _explain_info(self):
        return (f" type:{self.join_type} lkeys:{self.left_keys!r} "
                f"rkeys:{self.right_keys!r}")


@dataclass
class PhysIndexJoin(PhysPlan):
    """Index nested-loop join (ref: executor/index_lookup_join.go:87
    IndexLookUpJoin): children = [outer, inner_reader]. The outer side
    streams; for each outer batch the executor collects distinct join-key
    values and fetches only the matching inner rows through the inner
    table's index (or pk handle) — never scanning the inner table. The
    inner reader's cop carries the inner scan schema + residual filters;
    its ranges are synthesized per batch."""

    left_keys: list = field(default_factory=list)   # exprs over outer schema
    right_keys: list = field(default_factory=list)  # ColumnRefs, inner schema
    inner_index: Optional[IndexInfo] = None     # None = pk-handle lookup
    join_type: str = "inner"                    # inner/left
    other_cond: Optional[Expression] = None     # over joined schema

    def _explain_info(self):
        via = self.inner_index.name if self.inner_index else "handle"
        return (f" type:{self.join_type} "
                f"inner:{self.children[1].cop.table.name} "
                f"via:{via} okeys:{self.left_keys!r}")


@dataclass
class PhysApply(PhysPlan):
    """Correlated-subquery apply: for each outer row, bind the correlated
    cells and run the inner plan; the predicate decides whether the row
    survives (ref: executor/join.go:447 NestedLoopApplyExec). With no
    correlated cells the inner runs once and the predicate vectorizes
    (the reference's uncorrelated EvalSubquery rewrite)."""

    inner: "PhysPlan" = None
    mode: str = "exists"           # exists | in | cmp | scalar
    negated: bool = False
    left: Optional[Expression] = None      # IN target / cmp left side
    cmp_op: Optional[object] = None        # expression Op for cmp mode
    quant: str = ""                # cmp mode: "" | "any" | "all"
    corr: list = field(default_factory=list)   # [(outer_idx, CorrelatedCol)]

    def _explain_info(self):
        neg = "not " if self.negated else ""
        corr = "correlated" if self.corr else "uncorrelated"
        info = f" {neg}{self.mode} ({corr})"
        return info + "\n" + self.inner.explain(2)


@dataclass
class PhysSort(PhysPlan):
    by: list = field(default_factory=list)     # [(Expression, desc)]

    def _explain_info(self):
        return f" by:{[(repr(e), d) for e, d in self.by]}"


@dataclass
class PhysTopN(PhysPlan):
    by: list = field(default_factory=list)
    count: int = 0
    offset: int = 0

    def _explain_info(self):
        return f" by:{[(repr(e), d) for e, d in self.by]} n:{self.count}"


@dataclass
class PhysLimit(PhysPlan):
    count: int = 0
    offset: int = 0

    def _explain_info(self):
        return f" n:{self.count} offset:{self.offset}"


@dataclass
class PhysValues(PhysPlan):
    """Constant rows (SELECT without FROM / INSERT VALUES source)."""

    rows: list = field(default_factory=list)   # [[Expression]]


@dataclass
class PhysUnion(PhysPlan):
    """UNION ALL of the children's chunk streams (column types unified to
    the schema's; DISTINCT is a HashAgg grouped on every column layered
    on top by the planner — ref: executor/union handling via builder.go
    UnionExec)."""

    def _explain_info(self):
        return f" branches:{len(self.children)}"


@dataclass
class PhysInsert(PhysPlan):
    table: TableInfo = None
    columns: list = field(default_factory=list)     # column names, in order
    source: PhysPlan = None                         # PhysValues or select
    on_duplicate: list = field(default_factory=list)  # [(col_name, Expression)]
    is_replace: bool = False
    ignore: bool = False


@dataclass
class PhysUpdate(PhysPlan):
    table: TableInfo = None
    reader: PhysPlan = None        # scan emitting full row + handle
    assignments: list = field(default_factory=list)  # [(col_name, Expression)]


@dataclass
class PhysDelete(PhysPlan):
    table: TableInfo = None
    reader: PhysPlan = None


@dataclass
class PhysMultiUpdate(PhysPlan):
    """UPDATE t1, t2 SET ... (ref: executor/write.go:479). Per target:
    (TableInfo, col_start, handle_idx, [(col_name, Expression)])."""

    targets: list = field(default_factory=list)
    reader: PhysPlan = None


@dataclass
class PhysMultiDelete(PhysPlan):
    """DELETE t1, t2 FROM <join> (ref: executor/write.go:194
    deleteMultiTables). Per target: (TableInfo, col_start, handle_idx)
    locating its column block + handle inside the join output."""

    targets: list = field(default_factory=list)
    reader: PhysPlan = None
