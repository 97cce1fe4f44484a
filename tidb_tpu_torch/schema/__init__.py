"""Schema metadata: the port's copy of the JAX package's schema/model.py
(TableInfo, ColumnInfo, IndexInfo). The info schema and DDL are not
ported yet."""

from tidb_tpu_torch.schema.model import (ColumnInfo, DBInfo, IndexInfo,
                                               SchemaState, TableInfo)

__all__ = ["ColumnInfo", "DBInfo", "IndexInfo", "SchemaState", "TableInfo"]
