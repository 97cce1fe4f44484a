from tidb_tpu_torch.expression.core import (
    Expression, ColumnRef, Constant, ScalarFunc, Op,
    col, const, func, and_all,
)
from tidb_tpu_torch.expression.agg import AggFunc, AggDesc

__all__ = [
    "Expression", "ColumnRef", "Constant", "ScalarFunc", "Op",
    "col", "const", "func", "and_all", "AggFunc", "AggDesc",
]
