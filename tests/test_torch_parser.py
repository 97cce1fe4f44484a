"""The port's SQL parser (tidb_tpu_torch/parser/, a copy of the JAX
package's) against the JAX package's: every statement of a corpus parses
to the same AST in both packages, compared through one structural dump
(class names, field names and values; FieldTypes by their fields; enums
by name), and a malformed statement raises each package's ParseError.

The corpus: the TPC-H DDL and Q1/Q3/Q5 of benchmarks/tpch.py, the Q4,
Q6 and Q12 texts of tests/tpch.py (the SQL tests/test_tpch.py runs), and
the statements the port's session serves or refuses by name.
"""

import dataclasses
import enum

import pytest

import tpch as ttpch
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.parser import ParseError as JParseError
from tidb_tpu.parser import parse as jparse
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.parser import ParseError as PParseError
from tidb_tpu_torch.parser import parse as pparse

_DDL = [s.strip() for s in ptpch.DDL.split(";") if s.strip()]

CORPUS = {
    **{f"ddl_{i}": s for i, s in enumerate(_DDL)},
    "q1": ptpch.Q1, "q3": ptpch.Q3, "q5": ptpch.Q5,
    "q4": ttpch.Q4, "q6": ttpch.Q6, "q12": ttpch.Q12,
    "create_db": "CREATE DATABASE IF NOT EXISTS tpch",
    "drop_db": "DROP DATABASE IF EXISTS tpch",
    "use": "USE tpch",
    "set": "SET @@tidb_tpu_device = 0, @a = 1 + 2",
    "set_global": "SET GLOBAL tidb_tpu_superchunk_rows = 4096",
    "insert": "INSERT INTO t (a, b) VALUES (1, 'x'), (2, DEFAULT)",
    "insert_select": "INSERT INTO t SELECT a + 1, b FROM t WHERE a < 3",
    "explain": "EXPLAIN SELECT a FROM t WHERE b = 'x' ORDER BY a LIMIT 3",
    "analyze": "ANALYZE TABLE lineitem, orders",
    "drop_table": "DROP TABLE IF EXISTS t, u",
    "begin": "BEGIN",
    "show": "SHOW TABLES",
    "update": "UPDATE t SET a = a + 1 WHERE b IS NULL",
    "delete": "DELETE FROM t WHERE a BETWEEN 1 AND 2",
    "index": "CREATE UNIQUE INDEX ia ON t (a)",
}


def dump(x):
    """A package-neutral structure of a parsed statement."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, dump(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, (list, tuple)):
        return tuple(dump(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, dump(v)) for k, v in x.items()))
    return x


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_same_ast_in_both_packages(name):
    sql = CORPUS[name]
    got = [dump(s) for s in pparse(sql)]
    want = [dump(s) for s in jparse(sql)]
    assert got and got == want


def test_dump_tells_statements_apart():
    assert dump(pparse(ptpch.Q3)) != dump(pparse(ptpch.Q5))


@pytest.mark.parametrize("sql", ["SELEC 1", "SELECT FROM WHERE",
                                 "CREATE TABLE (a BIGINT)"])
def test_malformed_raises_parse_error(sql):
    with pytest.raises(JParseError):
        jparse(sql)
    with pytest.raises(PParseError):
        pparse(sql)


def test_tpch_texts_are_the_reference_texts():
    assert (ptpch.DDL, ptpch.Q1, ptpch.Q3, ptpch.Q5) == \
        (jtpch.DDL, jtpch.Q1, jtpch.Q3, jtpch.Q5)
