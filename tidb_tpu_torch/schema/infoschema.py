"""Immutable in-memory schema snapshot keyed by version.

Reference: TiDB's infoschema/infoschema.go:63-76 — name -> DB/Table
maps built from a meta snapshot; sessions hold one consistent snapshot per
statement/txn.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:   # avoid meta <-> schema circular import at runtime
    from tidb_tpu_torch.meta import Meta
from tidb_tpu_torch.schema.model import DBInfo, TableInfo

__all__ = ["InfoSchema", "SchemaError"]


class SchemaError(Exception):
    pass


class InfoSchema:
    def __init__(self, version: int, dbs: dict[str, DBInfo],
                 tables: dict[str, dict[str, TableInfo]],
                 db_ids: dict[str, int]):
        self.version = version
        self._dbs = dbs               # lower name -> DBInfo
        self._tables = tables         # lower db name -> lower tbl -> info
        self._db_ids = db_ids
        self._by_id = {t.id: (dbn, t) for dbn, ts in tables.items()
                       for t in ts.values()}

    @staticmethod
    def load(meta: Meta) -> "InfoSchema":
        """Full load from a meta snapshot (ref: domain loadInfoSchema)."""
        dbs, tables, db_ids = {}, {}, {}
        for db in meta.list_databases():
            key = db.name.lower()
            dbs[key] = db
            db_ids[key] = db.id
            tables[key] = {t.name.lower(): t for t in meta.list_tables(db.id)}
        return InfoSchema(meta.schema_version(), dbs, tables, db_ids)

    def db_names(self) -> list[str]:
        return sorted(d.name for d in self._dbs.values())

    def has_db(self, name: str) -> bool:
        return name.lower() in self._dbs

    def db_id(self, name: str) -> int:
        try:
            return self._db_ids[name.lower()]
        except KeyError:
            raise SchemaError(f"Unknown database '{name}'") from None

    def table_names(self, db: str) -> list[str]:
        ts = self._tables.get(db.lower())
        if ts is None:
            raise SchemaError(f"Unknown database '{db}'")
        return sorted(t.name for t in ts.values())

    def table(self, db: str, name: str) -> TableInfo:
        ts = self._tables.get(db.lower())
        if ts is None:
            raise SchemaError(f"Unknown database '{db}'")
        t = ts.get(name.lower())
        if t is None:
            raise SchemaError(f"Table '{db}.{name}' doesn't exist")
        return t

    def has_table(self, db: str, name: str) -> bool:
        ts = self._tables.get(db.lower())
        return ts is not None and name.lower() in ts

    def table_by_id(self, tid: int) -> tuple[str, TableInfo] | None:
        return self._by_id.get(tid)
