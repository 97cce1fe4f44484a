"""Serializable schema model.

Reference: TiDB's model/model.go — DBInfo/TableInfo/ColumnInfo/
IndexInfo and the F1 online-schema-change states (model.go:27-37). JSON
(de)serialization so metadata lives in the KV meta plane exactly like the
reference's json-marshaled infos.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional

from tidb_tpu_torch.sqltypes import FieldType, TypeCode

__all__ = ["SchemaState", "ColumnInfo", "IndexInfo", "TableInfo", "DBInfo"]


class SchemaState(IntEnum):
    """F1 schema-change states (model/model.go:27-37)."""

    NONE = 0
    DELETE_ONLY = 1
    WRITE_ONLY = 2
    WRITE_REORG = 3
    DELETE_REORG = 4
    PUBLIC = 5


@dataclass
class ColumnInfo:
    id: int
    name: str
    offset: int
    ft: FieldType
    default: Optional[object] = None
    has_default: bool = False
    auto_increment: bool = False
    state: SchemaState = SchemaState.PUBLIC
    comment: str = ""

    def to_json(self) -> dict:
        return {
            "id": self.id, "name": self.name, "offset": self.offset,
            "tp": int(self.ft.tp), "flags": self.ft.flags,
            "elems": list(self.ft.elems),
            "flen": self.ft.flen, "frac": self.ft.frac,
            "collation": self.ft.collation,
            "default": _jsonable(self.default),
            "has_default": self.has_default,
            "auto_increment": self.auto_increment,
            "state": int(self.state), "comment": self.comment,
        }

    @staticmethod
    def from_json(d: dict) -> "ColumnInfo":
        return ColumnInfo(
            id=d["id"], name=d["name"], offset=d["offset"],
            ft=FieldType(TypeCode(d["tp"]), d["flags"], d["flen"],
                         d["frac"], elems=tuple(d.get("elems") or ()),
                         collation=d.get("collation", "utf8mb4_bin")),
            default=_unjsonable(d.get("default")),
            has_default=d.get("has_default", False),
            auto_increment=d.get("auto_increment", False),
            state=SchemaState(d.get("state", SchemaState.PUBLIC)),
            comment=d.get("comment", ""),
        )


@dataclass
class IndexInfo:
    id: int
    name: str
    columns: list[str]
    unique: bool = False
    primary: bool = False
    state: SchemaState = SchemaState.PUBLIC

    def to_json(self) -> dict:
        return {"id": self.id, "name": self.name, "columns": self.columns,
                "unique": self.unique, "primary": self.primary,
                "state": int(self.state)}

    @staticmethod
    def from_json(d: dict) -> "IndexInfo":
        return IndexInfo(id=d["id"], name=d["name"], columns=d["columns"],
                         unique=d.get("unique", False),
                         primary=d.get("primary", False),
                         state=SchemaState(d.get("state", SchemaState.PUBLIC)))


@dataclass
class TableInfo:
    id: int
    name: str
    columns: list[ColumnInfo] = field(default_factory=list)
    indexes: list[IndexInfo] = field(default_factory=list)
    pk_is_handle: bool = False     # int PK stored as the row handle
    pk_col_name: str = ""
    auto_inc_id: int = 0           # next auto-increment base (meta-managed)
    state: SchemaState = SchemaState.PUBLIC
    comment: str = ""
    # Monotonic id allocators (ref: model.TableInfo MaxColumnID/MaxIndexID):
    # ids are never reused, so data of dropped columns/indexes awaiting GC
    # can never alias a new object's.
    max_column_id: int = 0
    max_index_id: int = 0

    def alloc_column_id(self) -> int:
        self.max_column_id = max(self.max_column_id,
                                 max((c.id for c in self.columns),
                                     default=0)) + 1
        return self.max_column_id

    def alloc_index_id(self) -> int:
        self.max_index_id = max(self.max_index_id,
                                max((i.id for i in self.indexes),
                                    default=0)) + 1
        return self.max_index_id

    def col_by_name(self, name: str) -> Optional[ColumnInfo]:
        lname = name.lower()
        for c in self.columns:
            if c.name.lower() == lname:
                return c
        return None

    def index_by_name(self, name: str) -> Optional[IndexInfo]:
        lname = name.lower()
        for i in self.indexes:
            if i.name.lower() == lname:
                return i
        return None

    def public_columns(self) -> list[ColumnInfo]:
        return [c for c in self.columns if c.state == SchemaState.PUBLIC]

    def writable_columns(self) -> list[ColumnInfo]:
        """Columns DML must fill (WRITE_ONLY and up — but NOT DELETE_REORG,
        which sorts above WRITE_ONLY in the enum yet means the column is on
        its way out). Ref: table/table.go:89 WritableCols excludes both
        DeleteOnly and DeleteReorganization."""
        return [c for c in self.columns
                if c.state >= SchemaState.WRITE_ONLY
                and c.state != SchemaState.DELETE_REORG]

    def writable_indexes(self) -> list[IndexInfo]:
        return [i for i in self.indexes
                if i.state >= SchemaState.WRITE_ONLY
                and i.state != SchemaState.DELETE_REORG]

    def deletable_indexes(self) -> list[IndexInfo]:
        """Indexes that must see deletions (DELETE_ONLY+).
        Ref: table/table.go:100 DeletableIndices."""
        return [i for i in self.indexes
                if i.state >= SchemaState.DELETE_ONLY]

    def to_json(self) -> dict:
        return {
            "id": self.id, "name": self.name,
            "columns": [c.to_json() for c in self.columns],
            "indexes": [i.to_json() for i in self.indexes],
            "pk_is_handle": self.pk_is_handle,
            "pk_col_name": self.pk_col_name,
            "state": int(self.state), "comment": self.comment,
            "max_column_id": self.max_column_id,
            "max_index_id": self.max_index_id,
        }

    @staticmethod
    def from_json(d: dict) -> "TableInfo":
        return TableInfo(
            id=d["id"], name=d["name"],
            columns=[ColumnInfo.from_json(c) for c in d["columns"]],
            indexes=[IndexInfo.from_json(i) for i in d.get("indexes", [])],
            pk_is_handle=d.get("pk_is_handle", False),
            pk_col_name=d.get("pk_col_name", ""),
            state=SchemaState(d.get("state", SchemaState.PUBLIC)),
            comment=d.get("comment", ""),
            max_column_id=d.get("max_column_id", 0),
            max_index_id=d.get("max_index_id", 0),
        )

    def dumps(self) -> bytes:
        return json.dumps(self.to_json()).encode()

    @staticmethod
    def loads(b: bytes) -> "TableInfo":
        return TableInfo.from_json(json.loads(b))


@dataclass
class DBInfo:
    id: int
    name: str
    state: SchemaState = SchemaState.PUBLIC

    def to_json(self) -> dict:
        return {"id": self.id, "name": self.name, "state": int(self.state)}

    @staticmethod
    def from_json(d: dict) -> "DBInfo":
        return DBInfo(id=d["id"], name=d["name"],
                      state=SchemaState(d.get("state", SchemaState.PUBLIC)))

    def dumps(self) -> bytes:
        return json.dumps(self.to_json()).encode()

    @staticmethod
    def loads(b: bytes) -> "DBInfo":
        return DBInfo.from_json(json.loads(b))


def _jsonable(v):
    import decimal
    if isinstance(v, decimal.Decimal):
        return {"__dec__": str(v)}
    if isinstance(v, bytes):
        return {"__b__": v.decode("latin1")}
    return v


def _unjsonable(v):
    import decimal
    if isinstance(v, dict):
        if "__dec__" in v:
            return decimal.Decimal(v["__dec__"])
        if "__b__" in v:
            return v["__b__"].encode("latin1")
    return v
