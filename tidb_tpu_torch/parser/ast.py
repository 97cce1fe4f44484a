"""AST node hierarchy.

Reference: TiDB's ast/ — Node/ExprNode/StmtNode (ast/ast.go:29-94),
DML nodes (ast/dml.go), DDL nodes (ast/ddl.go). Dataclasses instead of the
reference's visitor-heavy interfaces; the planner pattern-matches on types.
Unresolved names live here; the planner resolves them into
tidb_tpu_torch.expression columnar trees.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional

from tidb_tpu_torch.sqltypes import FieldType

__all__ = [
    "Node", "ExprNode", "StmtNode",
    "Literal", "ColName", "Star", "BinaryOp", "UnaryOp", "FuncCall",
    "AggregateCall", "CaseExpr", "InExpr", "BetweenExpr", "LikeExpr",
    "IsNullExpr", "CastExpr", "ExistsSubquery", "SubqueryExpr",
    "QuantSubquery", "RowExpr",
    "VariableExpr", "DefaultExpr", "ParamMarker",
    "JoinType", "TableSource", "Join", "SubqueryTable",
    "SelectField", "ByItem", "SelectStmt", "UnionStmt",
    "InsertStmt", "UpdateStmt", "DeleteStmt", "Assignment",
    "ColumnDef", "IndexDef", "CreateTableStmt", "CreateDatabaseStmt",
    "CreateIndexStmt", "DropTableStmt", "DropDatabaseStmt", "DropIndexStmt",
    "AlterTableStmt", "AlterSpec", "TruncateTableStmt", "RenameTableStmt",
    "UseStmt", "BeginStmt", "CommitStmt", "RollbackStmt",
    "SetStmt", "VarAssignment", "ShowStmt", "ExplainStmt", "AnalyzeStmt",
    "AdminStmt", "PrepareStmt", "ExecuteStmt", "DeallocateStmt",
    "LoadDataStmt", "SplitTableStmt", "KillStmt", "DoStmt", "FlushStmt",
]


class Node:
    pass


class ExprNode(Node):
    pass


class StmtNode(Node):
    pass


# ---------------------------------------------------------------------------
# Expressions

@dataclass
class Literal(ExprNode):
    value: Any               # python value; Decimal for DECIMAL literals
    ft: Optional[FieldType] = None


@dataclass
class ColName(ExprNode):
    name: str
    table: str = ""
    db: str = ""

    def __repr__(self):
        parts = [p for p in (self.db, self.table, self.name) if p]
        return ".".join(parts)


@dataclass
class Star(ExprNode):
    table: str = ""          # t.* form


@dataclass
class BinaryOp(ExprNode):
    op: str                  # '+', '-', '*', '/', 'DIV', '%', '=', '<', ...
    left: ExprNode
    right: ExprNode


@dataclass
class UnaryOp(ExprNode):
    op: str                  # '-', '+', 'NOT', '~'
    operand: ExprNode


@dataclass
class FuncCall(ExprNode):
    name: str                # uppercased
    args: list = field(default_factory=list)


@dataclass
class AggregateCall(ExprNode):
    name: str                # COUNT/SUM/AVG/MIN/MAX/GROUP_CONCAT...
    args: list = field(default_factory=list)   # empty for COUNT(*)
    distinct: bool = False
    star: bool = False
    sep: str = ","           # GROUP_CONCAT ... SEPARATOR '...'


@dataclass
class CaseExpr(ExprNode):
    operand: Optional[ExprNode]          # CASE x WHEN ... / CASE WHEN ...
    when_clauses: list = field(default_factory=list)  # [(cond, result)]
    else_clause: Optional[ExprNode] = None


@dataclass
class InExpr(ExprNode):
    expr: ExprNode
    items: list = field(default_factory=list)  # exprs, or a SubqueryExpr
    negated: bool = False


@dataclass
class BetweenExpr(ExprNode):
    expr: ExprNode
    low: ExprNode
    high: ExprNode
    negated: bool = False


@dataclass
class LikeExpr(ExprNode):
    expr: ExprNode
    pattern: ExprNode
    negated: bool = False
    escape: str = "\\"       # LIKE ... ESCAPE 'c'; "" = no escape char


@dataclass
class IsNullExpr(ExprNode):
    expr: ExprNode
    negated: bool = False


@dataclass
class CastExpr(ExprNode):
    expr: ExprNode
    ft: FieldType


@dataclass
class SubqueryExpr(ExprNode):
    select: "SelectStmt" = None


@dataclass
class QuantSubquery(ExprNode):
    """expr <cmp> ANY/SOME/ALL (SELECT ...)."""
    expr: ExprNode = None
    op: str = "="            # comparison operator token
    quant: str = "any"       # "any" (SOME == ANY) | "all"
    select: "SelectStmt" = None


@dataclass
class ExistsSubquery(ExprNode):
    select: "SelectStmt" = None
    negated: bool = False


@dataclass
class RowExpr(ExprNode):
    items: list = field(default_factory=list)


@dataclass
class VariableExpr(ExprNode):
    name: str
    is_global: bool = False
    is_system: bool = False


@dataclass
class VarAssignExpr(ExprNode):
    """@v := expr in expression position (SELECT @a := 1)."""
    name: str = ""
    value: ExprNode | None = None


@dataclass
class DefaultExpr(ExprNode):
    pass              # bare DEFAULT; DEFAULT(col) parses as FuncCall


@dataclass
class ParamMarker(ExprNode):
    index: int = 0
    # bound by the session before planning a prepared execution
    value: object = None
    bound: bool = False


# ---------------------------------------------------------------------------
# Table references

class JoinType(Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    CROSS = "cross"


@dataclass
class TableSource(Node):
    name: str
    db: str = ""
    alias: str = ""
    # (kind, [index names]) with kind USE|IGNORE|FORCE
    index_hints: list = field(default_factory=list)

    @property
    def ref_name(self) -> str:
        return self.alias or self.name


@dataclass
class SubqueryTable(Node):
    select: "SelectStmt" = None
    alias: str = ""


@dataclass
class Join(Node):
    left: Node
    right: Node
    tp: JoinType = JoinType.CROSS
    on: Optional[ExprNode] = None
    using: list = field(default_factory=list)
    natural: bool = False    # NATURAL JOIN: USING(all common names)


# ---------------------------------------------------------------------------
# SELECT

@dataclass
class SelectField(Node):
    expr: ExprNode           # Star for '*'
    alias: str = ""


@dataclass
class ByItem(Node):
    expr: ExprNode
    desc: bool = False


@dataclass
class SelectStmt(StmtNode):
    fields: list = field(default_factory=list)        # [SelectField]
    from_clause: Optional[Node] = None                # TableSource/Join/None
    where: Optional[ExprNode] = None
    group_by: list = field(default_factory=list)      # [ByItem]
    having: Optional[ExprNode] = None
    order_by: list = field(default_factory=list)      # [ByItem]
    limit: Optional[int] = None
    offset: int = 0
    distinct: bool = False
    for_update: bool = False


@dataclass
class UnionStmt(StmtNode):
    selects: list = field(default_factory=list)
    # alls[i] is True iff the connector before selects[i+1] was UNION ALL
    # (per-branch, as in MySQL; a single sticky flag would make one ALL
    # poison every branch)
    alls: list = field(default_factory=list)
    order_by: list = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0


# ---------------------------------------------------------------------------
# DML

@dataclass
class Assignment(Node):
    col: ColName
    expr: ExprNode


@dataclass
class InsertStmt(StmtNode):
    table: TableSource = None
    columns: list = field(default_factory=list)       # [str]
    values: list = field(default_factory=list)        # [[ExprNode]]
    select: Optional[SelectStmt] = None
    on_duplicate: list = field(default_factory=list)  # [Assignment]
    is_replace: bool = False
    ignore: bool = False


@dataclass
class UpdateStmt(StmtNode):
    table: Node = None                                # TableSource or Join
    assignments: list = field(default_factory=list)   # [Assignment]
    where: Optional[ExprNode] = None
    order_by: list = field(default_factory=list)
    limit: Optional[int] = None


@dataclass
class DeleteStmt(StmtNode):
    table: TableSource = None
    where: Optional[ExprNode] = None
    order_by: list = field(default_factory=list)
    limit: Optional[int] = None
    # multi-table form (ref: ast/dml.go DeleteStmt.IsMultiTable):
    # DELETE t1, t2 FROM <refs> / DELETE FROM t1, t2 USING <refs>
    targets: list = field(default_factory=list)   # [TableSource]
    refs: Optional[Node] = None                   # join tree


# ---------------------------------------------------------------------------
# DDL

@dataclass
class ColumnDef(Node):
    name: str
    ft: FieldType
    default: Optional[ExprNode] = None
    has_default: bool = False
    comment: str = ""
    is_primary: bool = False          # inline PRIMARY KEY
    is_unique: bool = False           # inline UNIQUE
    auto_increment: bool = False
    # an explicit column COLLATE wins over the table default, even when
    # it names the default collation (utf8mb4_bin)
    explicit_collation: bool = False


@dataclass
class IndexDef(Node):
    name: str
    columns: list = field(default_factory=list)       # [str]
    unique: bool = False
    primary: bool = False


@dataclass
class CreateTableStmt(StmtNode):
    table: TableSource = None
    columns: list = field(default_factory=list)       # [ColumnDef]
    indexes: list = field(default_factory=list)       # [IndexDef]
    if_not_exists: bool = False
    options: dict = field(default_factory=dict)       # engine/charset/comment
    like_table: Optional[TableSource] = None          # CREATE TABLE a LIKE b


@dataclass
class CreateDatabaseStmt(StmtNode):
    name: str = ""
    if_not_exists: bool = False


@dataclass
class CreateIndexStmt(StmtNode):
    index_name: str = ""
    table: TableSource = None
    columns: list = field(default_factory=list)
    unique: bool = False


@dataclass
class DropTableStmt(StmtNode):
    tables: list = field(default_factory=list)        # [TableSource]
    if_exists: bool = False


@dataclass
class DropDatabaseStmt(StmtNode):
    name: str = ""
    if_exists: bool = False


@dataclass
class DropIndexStmt(StmtNode):
    index_name: str = ""
    table: TableSource = None
    if_exists: bool = False


@dataclass
class AlterSpec(Node):
    tp: str                  # add_column(s)/drop_column/add_index/
    #                          drop_index/modify_column/change_column/
    #                          rename/set_default/drop_default/noop
    column: Optional[ColumnDef] = None
    columns: Optional[list] = None     # ADD COLUMN (a ..., b ...)
    index: Optional[IndexDef] = None
    name: str = ""           # drop target / rename target
    position: str = ""       # FIRST / AFTER <col>
    after_col: str = ""
    default: Optional[ExprNode] = None  # SET DEFAULT value
    new_db: str = ""         # RENAME to another database


@dataclass
class AlterTableStmt(StmtNode):
    table: TableSource = None
    specs: list = field(default_factory=list)


@dataclass
class TruncateTableStmt(StmtNode):
    table: TableSource = None


@dataclass
class RenameTableStmt(StmtNode):
    pairs: list = field(default_factory=list)         # [(old TS, new TS)]


# ---------------------------------------------------------------------------
# Session / admin

@dataclass
class UseStmt(StmtNode):
    db: str = ""


@dataclass
class BeginStmt(StmtNode):
    pass


@dataclass
class CommitStmt(StmtNode):
    pass


@dataclass
class RollbackStmt(StmtNode):
    pass


@dataclass
class VarAssignment(Node):
    name: str
    value: ExprNode = None
    is_global: bool = False
    is_system: bool = False


@dataclass
class SetStmt(StmtNode):
    assignments: list = field(default_factory=list)


@dataclass
class ShowStmt(StmtNode):
    tp: str = ""             # databases/tables/columns/variables/create_table
    table: Optional[TableSource] = None
    db: str = ""
    pattern: Optional[str] = None    # LIKE '...'
    where: Optional[ExprNode] = None
    is_global: bool = False
    full: bool = False       # SHOW FULL PROCESSLIST: untruncated Info


@dataclass
class ExplainStmt(StmtNode):
    stmt: StmtNode = None
    analyze: bool = False    # EXPLAIN ANALYZE: execute + actual stats


@dataclass
class TraceStmt(StmtNode):
    """TRACE [FORMAT='row'|'json'] <stmt>: execute the inner statement
    with forced trace retention and return its span tree (ref: the
    reference's TRACE statement over its per-statement trace trees)."""
    stmt: StmtNode = None
    format: str = "row"      # 'row' (indented tree rows) or 'json'


@dataclass
class AnalyzeStmt(StmtNode):
    tables: list = field(default_factory=list)
    index_names: Optional[list] = None   # ANALYZE ... INDEX [names]


@dataclass
class PrepareStmt(StmtNode):
    name: str = ""
    sql: str = ""                  # the statement text to prepare
    from_var: str | None = None    # PREPARE s FROM @v


@dataclass
class ExecuteStmt(StmtNode):
    name: str = ""
    using: list = field(default_factory=list)   # user variable names


@dataclass
class DeallocateStmt(StmtNode):
    name: str = ""


@dataclass
class AdminStmt(StmtNode):
    tp: str = ""             # show_ddl / check_table / cancel_ddl_jobs
    tables: list = field(default_factory=list)
    job_ids: list = field(default_factory=list)


@dataclass
class LoadDataStmt(StmtNode):
    """LOAD DATA [LOCAL] INFILE (ref: ast/dml.go LoadDataStmt,
    executor/write.go:1373 LoadData)."""
    path: str = ""
    local: bool = False
    table: TableSource = None
    columns: list = field(default_factory=list)   # [str]; empty = all
    fields_terminated: str = "\t"
    fields_enclosed: str = ""                     # "" = none
    fields_escaped: str = "\\"
    lines_starting: str = ""
    lines_terminated: str = "\n"
    ignore_lines: int = 0
    dup_mode: str = "error"                       # error / ignore / replace


@dataclass
class DoStmt(StmtNode):
    """DO expr[, ...]: evaluate and discard (ref: ast/misc.go DoStmt;
    executor/simple.go)."""
    exprs: list = field(default_factory=list)


@dataclass
class FlushStmt(StmtNode):
    """FLUSH PRIVILEGES|STATUS|TABLES (ref: ast/misc.go FlushStmt;
    executor/simple.go:311 executeFlush)."""
    tp: str = ""


@dataclass
class KillStmt(StmtNode):
    """KILL [TIDB] [CONNECTION | QUERY] id (ref: ast/misc.go:341
    KillStmt — query_only leaves the connection intact)."""
    conn_id: int = 0
    query_only: bool = False


@dataclass
class SplitTableStmt(StmtNode):
    """SPLIT TABLE t AT (v)[,(v)...] | SPLIT TABLE t REGIONS n
    (ref: store/tikv/split_region.go:29 SplitRegion RPC; mocktikv
    cluster.go:276 Split/SplitTable)."""
    table: TableSource = None
    at_values: list = field(default_factory=list)   # [ExprNode literals]
    regions: int = 0                                # REGIONS n form


# -- account management (ref: ast/misc.go CreateUserStmt/GrantStmt) ----------

@dataclass
class UserSpec:
    user: str = ""
    host: str = "%"
    password: str | None = None    # IDENTIFIED BY (plaintext at parse time)


@dataclass
class CreateUserStmt(StmtNode):
    users: list = field(default_factory=list)      # [UserSpec]
    if_not_exists: bool = False


@dataclass
class CreateViewStmt(StmtNode):
    """Parsed for parity with ast/ddl.go CreateViewStmt; execution
    rejects it (the reference's planner does too: no view support)."""

    view: TableSource = None
    columns: list = field(default_factory=list)
    select: Optional[SelectStmt] = None
    or_replace: bool = False


@dataclass
class DropViewStmt(StmtNode):
    """Views are unimplemented; DROP VIEW IF EXISTS no-ops (migration
    scripts), otherwise errors."""

    tables: list = field(default_factory=list)
    if_exists: bool = False


@dataclass
class DropStatsStmt(StmtNode):
    """DROP STATS t (ref: parser.y DropStatsStmt)."""

    table: TableSource = None


@dataclass
class SetPasswordStmt(StmtNode):
    """SET PASSWORD [FOR user] = 'pw' (ref: parser.y SetPwdStmt)."""

    user: Optional["UserSpec"] = None   # None = the current user
    password: str = ""


@dataclass
class DropUserStmt(StmtNode):
    users: list = field(default_factory=list)      # [UserSpec]
    if_exists: bool = False


@dataclass
class GrantStmt(StmtNode):
    privs: list = field(default_factory=list)      # upper priv names / "ALL"
    db: str = "*"                                  # "*" = global
    table: str = "*"                               # "*" = whole db
    users: list = field(default_factory=list)      # [UserSpec]


@dataclass
class RevokeStmt(StmtNode):
    privs: list = field(default_factory=list)
    db: str = "*"
    table: str = "*"
    users: list = field(default_factory=list)
