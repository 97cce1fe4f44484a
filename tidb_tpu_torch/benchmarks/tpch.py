"""Scaled TPC-H for the port's Q1, Q3, Q5 and Q18-inner paths.

The numpy generator is a copy of the JAX package's
benchmarks/tpch.ScaledTpch with the same draw order, so one `seed` gives
the same tables in both packages. Row counts follow the TPC-H spec's
cardinalities (sf=1 ~ 6M lineitem rows).

The SQL path is the JAX package's: `load(session, storage, d)` runs
`DDL` through the session (CREATE TABLE through the DDL and meta layers)
and bulk-ingests the tables into the store, and `Q1`/`Q3`/`Q5` are the
query texts a `Session.query` plans and runs. Beside it stay the
hand-built paths of the earlier slices: each table's scan chunks built
directly in the DDL's column order (`table_chunks`), the TableInfos the
DDL makes (`table_infos`, `load_store`), and the plans that the JAX
planner builds: for Q1 the partial aggregation it pushes to the
coprocessor, for Q3 and Q5 the left-deep join trees (build side = right
child) under one HashAgg, with their host tails (TopN, Sort) as plain
functions, and for Q18's inner block the StreamAgg the planner picks
after ANALYZE.

Overflow: Q1's sum_charge lane is scaled by 10^6; at sf 10 one group's
sum comes to about 1.5e18, under int64's 9.2e18. At sf 100 it would
overflow, in both packages.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np

from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.sqltypes import (EvalType, FieldType, TypeCode,
                                     date_to_micros, new_datetime_field,
                                     new_decimal_field, new_int_field,
                                     parse_datetime)

__all__ = ["ScaledTpch", "DDL", "load", "as_session_rows", "Q1", "Q3",
           "Q5", "QUERIES", "TABLE_COLUMNS",
           "TABLE_IDS",
           "table_infos", "load_store", "q1_cop_plan", "q1_truth_of",
           "WriteBatch", "write_batch", "commit_batch", "Q1Mirror",
           "LINEITEM_COLUMNS", "QUERY_TABLES", "PLANS", "table_chunks",
           "lineitem_chunks", "q1_plan", "q1_truth", "q3_plan", "q3_finish",
           "q3_truth", "q3_groups_truth", "q5_plan", "q5_finish",
           "q3_store_plan", "q5_store_plan", "STORE_PLANS",
           "q5_truth", "Q18_INNER", "q18_inner_plan", "q18_inner_truth",
           "q18_groups_truth", "table_column", "analyze_columns"]

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [  # (name, region_idx) — the 25 spec nations
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
FLAGS = ["A", "N", "R"]
STATUSES = ["F", "O"]

_EPOCH_DATE = datetime.date(1992, 1, 1)
_DAY_US = 86_400_000_000


def _epoch_us() -> int:
    # match sqltypes.parse_datetime's epoch convention exactly
    return parse_datetime("1992-01-01")


def _days_us(days: np.ndarray) -> np.ndarray:
    """TPC-H day offsets -> epoch-microsecond DATE datums."""
    return _epoch_us() + days.astype(np.int64) * _DAY_US


class ScaledTpch:
    """Numpy TPC-H tables at scale factor `sf` (sf=1 ~ 6M lineitem)."""

    def __init__(self, sf: float = 1.0, seed: int = 42):
        rng = np.random.default_rng(seed)
        self.sf = sf
        customers = max(int(150_000 * sf), 50)
        orders = max(int(1_500_000 * sf), 200)
        lineitems = max(int(6_001_215 * sf), 800)
        suppliers = max(int(10_000 * sf), 20)
        self.counts = {"region": len(REGIONS), "nation": len(NATIONS),
                       "customer": customers, "supplier": suppliers,
                       "orders": orders, "lineitem": lineitems}
        n_nation = len(NATIONS)
        self.c_custkey = np.arange(customers, dtype=np.int64)
        self.c_nationkey = rng.integers(0, n_nation, customers)
        self.c_mktsegment = rng.integers(0, len(SEGMENTS), customers)
        self.s_suppkey = np.arange(suppliers, dtype=np.int64)
        self.s_nationkey = rng.integers(0, n_nation, suppliers)
        self.o_orderkey = np.arange(orders, dtype=np.int64)
        self.o_custkey = rng.integers(0, customers, orders)
        self.o_orderdate = rng.integers(0, 2405, orders)  # days since epoch
        self.o_shippriority = np.zeros(orders, dtype=np.int64)
        self.o_orderpriority = rng.integers(0, len(PRIORITIES), orders)
        self.l_orderkey = rng.integers(0, orders, lineitems)
        self.l_suppkey = rng.integers(0, suppliers, lineitems)
        self.l_quantity = rng.integers(1, 51, lineitems)       # whole units
        self.l_extendedprice = rng.integers(90000, 10500000, lineitems)
        self.l_discount = rng.integers(0, 11, lineitems)       # percent
        self.l_tax = rng.integers(0, 9, lineitems)             # percent
        self.l_returnflag = rng.integers(0, 3, lineitems)
        self.l_linestatus = rng.integers(0, 2, lineitems)
        base = self.o_orderdate[self.l_orderkey]
        self.l_shipdate = base + rng.integers(1, 122, lineitems)
        self.l_commitdate = base + rng.integers(30, 92, lineitems)
        self.l_receiptdate = self.l_shipdate + rng.integers(1, 31, lineitems)


DDL = """
CREATE TABLE region (r_regionkey BIGINT PRIMARY KEY, r_name VARCHAR(25));
CREATE TABLE nation (n_nationkey BIGINT PRIMARY KEY, n_name VARCHAR(25),
                     n_regionkey BIGINT);
CREATE TABLE customer (c_custkey BIGINT PRIMARY KEY,
                       c_nationkey BIGINT, c_mktsegment VARCHAR(10));
CREATE TABLE supplier (s_suppkey BIGINT PRIMARY KEY, s_nationkey BIGINT);
CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, o_custkey BIGINT,
                     o_orderdate DATE, o_shippriority BIGINT,
                     o_orderpriority VARCHAR(15));
CREATE TABLE lineitem (l_id BIGINT PRIMARY KEY, l_orderkey BIGINT,
                       l_suppkey BIGINT,
                       l_quantity DECIMAL(15,2),
                       l_extendedprice DECIMAL(15,2),
                       l_discount DECIMAL(15,2), l_tax DECIMAL(15,2),
                       l_returnflag CHAR(1), l_linestatus CHAR(1),
                       l_shipdate DATE, l_commitdate DATE,
                       l_receiptdate DATE);
"""


def load(session, storage, d: "ScaledTpch",
         regions_per_table: int = 4) -> int:
    """The JAX package's tpch.load: `DDL` through `session` (in its
    current database), bulk ingest of the six tables into `storage`,
    then the region pre-split of lineitem and orders. -> total rows
    loaded."""
    from tidb_tpu_torch.table import Table, bulkload
    for stmt in DDL.strip().split(";"):
        if stmt.strip():
            session.execute(stmt)
    ischema = session.domain.info_schema()
    db = session.current_db
    infos = {name: ischema.table(db, name) for name in _LOAD_ORDER}
    total = 0
    for name in _LOAD_ORDER:
        total += bulkload.bulk_load(storage, Table(infos[name], storage),
                                    _load_columns(d, name))
    cluster = storage.cluster
    for name in ("lineitem", "orders"):
        cluster.split_table(infos[name].id, regions_per_table,
                            max_handle=d.counts[name])
    return total


Q1 = """
SELECT l_returnflag, l_linestatus,
       SUM(l_quantity) AS sum_qty,
       SUM(l_extendedprice) AS sum_base_price,
       SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       AVG(l_quantity) AS avg_qty,
       AVG(l_extendedprice) AS avg_price,
       AVG(l_discount) AS avg_disc,
       COUNT(*) AS count_order
FROM lineitem
WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""


Q3 = """
SELECT l_orderkey,
       SUM(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING'
  AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey
  AND o_orderdate < DATE '1995-03-15'
  AND l_shipdate > DATE '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate
LIMIT 10
"""

Q5 = """
SELECT n_name,
       SUM(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer, orders, lineitem, supplier, nation, region
WHERE c_custkey = o_custkey
  AND l_orderkey = o_orderkey
  AND l_suppkey = s_suppkey
  AND c_nationkey = s_nationkey
  AND s_nationkey = n_nationkey
  AND n_regionkey = r_regionkey
  AND r_name = 'ASIA'
  AND o_orderdate >= DATE '1994-01-01'
  AND o_orderdate < DATE '1994-01-01' + INTERVAL '1' YEAR
GROUP BY n_name
ORDER BY revenue DESC
"""

# the bench legs' three queries by name (the JAX package's tpch.QUERIES)
QUERIES = {"q1": Q1, "q3": Q3, "q5": Q5}

# TPC-H Q18 adapted to the DDL above (it has no c_name or o_totalprice):
# the IN subquery with GROUP BY ... HAVING cannot be decorrelated, so it
# plans to an uncorrelated Apply over the three-way join
Q18 = """
SELECT c_custkey, o_orderkey, o_orderdate, SUM(l_quantity)
FROM customer, orders, lineitem
WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem GROUP BY l_orderkey
                     HAVING SUM(l_quantity) > 300)
  AND c_custkey = o_custkey
  AND o_orderkey = l_orderkey
GROUP BY c_custkey, o_orderkey, o_orderdate
ORDER BY o_orderdate, o_orderkey
LIMIT 100
"""

# TPC-H Q4: the correlated EXISTS decorrelates into a semi join
Q4 = """
SELECT o_orderpriority, COUNT(*) AS order_count
FROM orders
WHERE o_orderdate >= DATE '1993-07-01'
  AND o_orderdate < DATE '1993-07-01' + INTERVAL '3' MONTH
  AND EXISTS (SELECT * FROM lineitem WHERE l_orderkey = o_orderkey
              AND l_commitdate < l_receiptdate)
GROUP BY o_orderpriority
ORDER BY o_orderpriority
"""

# NOT IN always plans to an uncorrelated Apply (three-valued NULL logic)
NOT_IN = ("SELECT COUNT(*) FROM customer WHERE c_custkey NOT IN "
          "(SELECT o_custkey FROM orders)")

# a correlated scalar subquery: one inner run per nation
SCALAR_SUBQUERY = ("SELECT n_name, (SELECT COUNT(*) FROM customer "
                   "WHERE c_nationkey = n_nationkey) FROM nation "
                   "ORDER BY n_name")

# UNION [ALL] of two partial aggregates pushed to the coprocessor
UNION_BRANCHES = ("SELECT l_returnflag, COUNT(*) FROM lineitem "
                  "GROUP BY l_returnflag",
                  "SELECT o_orderpriority, COUNT(*) FROM orders "
                  "GROUP BY o_orderpriority")
UNION_ALL = " UNION ALL ".join(UNION_BRANCHES)
UNION = " UNION ".join(UNION_BRANCHES)

# a comma join with no key: region x customer, aggregated
CROSS_JOIN = ("SELECT r_name, COUNT(*), SUM(c_nationkey) FROM region, "
              "customer GROUP BY r_name")

# per-query input-row accounting (the tables each query scans)
QUERY_TABLES = {
    "q1": ["lineitem"],
    "q3": ["lineitem", "orders", "customer"],
    "q5": ["lineitem", "orders", "customer", "supplier", "nation",
           "region"],
}

_DEC = new_decimal_field(flen=15, frac=2)
_CHAR1 = FieldType(TypeCode.STRING, flen=1)
_BIGINT = FieldType(TypeCode.LONGLONG)     # the DDL's BIGINT
_DATE = FieldType(TypeCode.DATE)


def _varchar(n: int) -> FieldType:
    return FieldType(TypeCode.VARCHAR, flen=n)


# every table's columns in the JAX package's DDL order (benchmarks/tpch.DDL),
# as its scan decodes them; the plans refer to columns by these positions
TABLE_COLUMNS = {
    "region": [("r_regionkey", _BIGINT), ("r_name", _varchar(25))],
    "nation": [("n_nationkey", _BIGINT), ("n_name", _varchar(25)),
               ("n_regionkey", _BIGINT)],
    "customer": [("c_custkey", _BIGINT), ("c_nationkey", _BIGINT),
                 ("c_mktsegment", _varchar(10))],
    "supplier": [("s_suppkey", _BIGINT), ("s_nationkey", _BIGINT)],
    "orders": [("o_orderkey", _BIGINT), ("o_custkey", _BIGINT),
               ("o_orderdate", _DATE), ("o_shippriority", _BIGINT),
               ("o_orderpriority", _varchar(15))],
    "lineitem": [
        ("l_id", _BIGINT), ("l_orderkey", _BIGINT), ("l_suppkey", _BIGINT),
        ("l_quantity", _DEC), ("l_extendedprice", _DEC),
        ("l_discount", _DEC), ("l_tax", _DEC), ("l_returnflag", _CHAR1),
        ("l_linestatus", _CHAR1), ("l_shipdate", _DATE),
        ("l_commitdate", _DATE), ("l_receiptdate", _DATE)],
}
LINEITEM_COLUMNS = TABLE_COLUMNS["lineitem"]


def _table_lanes(d: ScaledTpch, table: str):
    """-> ([int64 lane or (index lane, dictionary) per column], rows)."""
    if table == "region":
        return [np.arange(len(REGIONS)), (np.arange(len(REGIONS)),
                                          REGIONS)], len(REGIONS)
    if table == "nation":
        n = len(NATIONS)
        return [np.arange(n), (np.arange(n), [nm for nm, _r in NATIONS]),
                np.array([r for _nm, r in NATIONS])], n
    if table == "customer":
        return [d.c_custkey, d.c_nationkey,
                (d.c_mktsegment, SEGMENTS)], d.counts["customer"]
    if table == "supplier":
        return [d.s_suppkey, d.s_nationkey], d.counts["supplier"]
    if table == "orders":
        return [d.o_orderkey, d.o_custkey, _days_us(d.o_orderdate),
                d.o_shippriority, (d.o_orderpriority, PRIORITIES)], \
            d.counts["orders"]
    n = d.counts["lineitem"]
    return [np.arange(n), d.l_orderkey, d.l_suppkey, d.l_quantity * 100,
            d.l_extendedprice, d.l_discount, d.l_tax,
            (d.l_returnflag, FLAGS), (d.l_linestatus, STATUSES),
            _days_us(d.l_shipdate), _days_us(d.l_commitdate),
            _days_us(d.l_receiptdate)], n


def _chunks_of(table: str, lanes, n: int, rows: int) -> list[Chunk]:
    """Integer columns are views of the generator's arrays; decimals are
    scaled ints (frac 2) and dates epoch micros, as the JAX package loads
    them. String columns carry their dictionary encoding from the
    generator's index arrays, set as each column's dict_encode memo, so
    no per-row encode pass runs."""
    ones = np.ones(n, dtype=bool)
    cols_meta = []
    for (_name, ft), lane in zip(TABLE_COLUMNS[table], lanes):
        if isinstance(lane, tuple):
            idx, values = lane
            idx = np.asarray(idx, dtype=np.int64)
            cols_meta.append((ft, idx, np.array(values, dtype=object),
                              list(values)))
        else:
            cols_meta.append((ft, np.asarray(lane, dtype=np.int64), None,
                              None))
    out = []
    for s in range(0, n, max(int(rows), 1)):
        e = min(n, s + rows)
        cols = []
        for ft, a, strs, values in cols_meta:
            if strs is None:
                cols.append(Column(ft, a[s:e], ones[s:e]))
            else:
                c = Column(ft, strs[a[s:e]], ones[s:e])
                c._enc = (a[s:e], values)
                cols.append(c)
        out.append(Chunk(cols))
    return out


def table_chunks(d: ScaledTpch, tables, rows: int = 1 << 18) -> dict:
    """{table: [Chunk]} for each named table, in chunks of `rows` rows
    (the last one shorter), with the columns of TABLE_COLUMNS."""
    return {t: _chunks_of(t, *_table_lanes(d, t), rows) for t in tables}


def lineitem_chunks(d: ScaledTpch, rows: int = 1 << 18) -> list[Chunk]:
    """lineitem as Chunks of `rows` rows with the columns of
    LINEITEM_COLUMNS (Q1 reads positions 3-9)."""
    return table_chunks(d, ["lineitem"], rows)["lineitem"]


def q1_plan():
    """-> (filter, group_exprs, aggs): the partial aggregation the JAX
    planner pushes to the coprocessor for Q1 over LINEITEM_COLUMNS (the
    same plan_fingerprint)."""
    from tidb_tpu_torch.expression import (AggDesc, AggFunc, Constant, Op,
                                           col, func)
    c = {name: col(j, ft, name)
         for j, (name, ft) in enumerate(LINEITEM_COLUMNS)}
    cutoff = date_to_micros(datetime.date(1998, 12, 1) -
                            datetime.timedelta(days=90))
    flt = func(Op.LE, c["l_shipdate"],
               Constant(cutoff, new_datetime_field()))
    one = Constant(1, new_int_field())
    disc_price = func(Op.MUL, c["l_extendedprice"],
                      func(Op.MINUS, one, c["l_discount"]))
    charge = func(Op.MUL, disc_price, func(Op.PLUS, one, c["l_tax"]))
    aggs = [AggDesc(AggFunc.SUM, c["l_quantity"], name="sum_qty"),
            AggDesc(AggFunc.SUM, c["l_extendedprice"],
                    name="sum_base_price"),
            AggDesc(AggFunc.SUM, disc_price, name="sum_disc_price"),
            AggDesc(AggFunc.SUM, charge, name="sum_charge"),
            AggDesc(AggFunc.AVG, c["l_quantity"], name="avg_qty"),
            AggDesc(AggFunc.AVG, c["l_extendedprice"], name="avg_price"),
            AggDesc(AggFunc.AVG, c["l_discount"], name="avg_disc"),
            AggDesc(AggFunc.COUNT, None, name="count_order")]
    return flt, [c["l_returnflag"], c["l_linestatus"]], aggs


def q1_truth(d: ScaledTpch) -> list[tuple]:
    """Q1's final rows computed straight from the generator's arrays in
    exact int64 numpy (no float ever), in the layout of run_q1's rows:
    (returnflag, linestatus, sum_qty, sum_base_price, sum_disc_price,
    sum_charge, avg_qty, avg_price, avg_disc, count_order), decimals as
    scaled ints (sums at frac 2, 2, 4, 6; averages at frac 6, rounded
    half up)."""
    return q1_truth_of(d.l_returnflag, d.l_linestatus, d.l_quantity * 100,
                       d.l_extendedprice, d.l_discount, d.l_tax,
                       _days_us(d.l_shipdate))


def q1_truth_of(flag, status, qty, price, disc, tax, shipdate,
                flag_names=FLAGS, status_names=STATUSES) -> list[tuple]:
    """q1_truth over lineitem lanes as the store holds them: `flag` and
    `status` index `flag_names` / `status_names`, `qty` .. `tax` are
    scaled decimals (frac 2), `shipdate` epoch micros. Groups come out
    in (returnflag, linestatus) order, as Q1's ORDER BY gives them."""
    cutoff = date_to_micros(datetime.date(1998, 12, 1) -
                            datetime.timedelta(days=90))
    live = np.asarray(shipdate) <= cutoff
    flag = np.asarray(flag, dtype=np.int64)
    status = np.asarray(status, dtype=np.int64)
    qty = np.asarray(qty, dtype=np.int64)
    price = np.asarray(price, dtype=np.int64)
    disc = np.asarray(disc, dtype=np.int64)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + np.asarray(tax, dtype=np.int64))

    def avg(total: int, count: int) -> int:    # frac 2 -> 6, half up
        q, r = divmod(abs(total) * 10 ** 4, count)
        q += 2 * r >= count
        return q if total >= 0 else -q

    rows = []
    for f in sorted(range(len(flag_names)), key=lambda i: flag_names[i]):
        for s in sorted(range(len(status_names)),
                        key=lambda i: status_names[i]):
            m = live & (flag == f) & (status == s)
            count = int(np.count_nonzero(m))
            if not count:
                continue
            sq, sp, sd, sc, sdisc = (
                int(np.sum(a, where=m, dtype=np.int64))
                for a in (qty, price, disc_price, charge, disc))
            rows.append((flag_names[f], status_names[s], sq, sp, sd, sc,
                         avg(sq, count), avg(sp, count), avg(sdisc, count),
                         count))
    return rows


def _date_const(day: datetime.date, ft: FieldType = _DATE):
    from tidb_tpu_torch.expression import Constant
    return Constant(date_to_micros(day), ft)


def _revenue_sum(price, disc):
    """SUM(l_extendedprice * (1 - l_discount))."""
    from tidb_tpu_torch.expression import (AggDesc, AggFunc, Constant, Op,
                                           func)
    one = Constant(1, new_int_field())
    return AggDesc(AggFunc.SUM,
                   func(Op.MUL, price, func(Op.MINUS, one, disc)))


def _ref(schema, name: str):
    """A ColumnRef to the column `name` of an operator's schema."""
    from tidb_tpu_torch.expression import ColumnRef
    j = next(i for i, c in enumerate(schema) if c.name == name)
    return ColumnRef(j, schema[j].ft, name)


Q3_CUTOFF = datetime.date(1995, 3, 15)
Q5_FROM, Q5_TO = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)


def _leaf_col(table: str, name: str):
    """A ColumnRef to column `name` of `table`'s scan schema (its DDL
    columns, in DDL order: a TableScan's and a TableReader's alike)."""
    from tidb_tpu_torch.expression import ColumnRef
    cols = TABLE_COLUMNS[table]
    j = next(i for i, (n, _ft) in enumerate(cols) if n == name)
    return ColumnRef(j, cols[j][1], name)


def _q3_filters() -> dict:
    """{table: (filter, host_filter)} of Q3's leaves as the JAX planner
    splits them: the string conjunct on the host, the date ranges pushed."""
    from tidb_tpu_torch.expression import Constant, Op, func
    from tidb_tpu_torch.sqltypes import new_string_field
    return {
        "customer": (None, func(Op.EQ, _leaf_col("customer", "c_mktsegment"),
                                Constant("BUILDING", new_string_field()))),
        "orders": (func(Op.LT, _leaf_col("orders", "o_orderdate"),
                        _date_const(Q3_CUTOFF)), None),
        "lineitem": (func(Op.GT, _leaf_col("lineitem", "l_shipdate"),
                          _date_const(Q3_CUTOFF)), None)}


def _q3_tree(leaves: dict):
    """Q3's HashJoin/HashAgg tree over `leaves` ({table: leaf})."""
    from tidb_tpu_torch.executor.agg import HashAgg
    from tidb_tpu_torch.executor.join import HashJoin
    customer, orders, lineitem = (leaves[t] for t in
                                  ("customer", "orders", "lineitem"))
    co = HashJoin(customer, orders, [customer.col("c_custkey")],
                  [orders.col("o_custkey")])
    col = HashJoin(co, lineitem, [_ref(co.schema, "o_orderkey")],
                   [lineitem.col("l_orderkey")])
    s = col.schema
    return HashAgg(col, [_ref(s, "l_orderkey"), _ref(s, "o_orderdate"),
                         _ref(s, "o_shippriority")],
                   [_revenue_sum(_ref(s, "l_extendedprice"),
                                   _ref(s, "l_discount"))])


def _scans(filters: dict) -> dict:
    """{table: TableScan} over each table's chunks in hand."""
    from tidb_tpu_torch.executor.scan import TableScan
    return {t: TableScan(t, TABLE_COLUMNS[t], flt, host)
            for t, (flt, host) in filters.items()}


def _readers(infos: dict, filters: dict) -> dict:
    """{table: TableReader} over selection CopPlans on the store: every
    DDL column scanned (the JAX planner prunes none of these tables'),
    `filter` pushed, `host_filter` the string conjunct."""
    from tidb_tpu_torch.executor.reader import TableReader
    from tidb_tpu_torch.plan.physical import CopPlan
    return {t: TableReader(CopPlan(table=infos[t],
                                   cols=list(infos[t].columns),
                                   filter=flt, host_filter=host))
            for t, (flt, host) in filters.items()}


def q3_plan():
    """Q3's plan as the JAX planner builds it: HashAgg over
    (customer [host filter c_mktsegment = 'BUILDING'] JOIN orders [pushed
    o_orderdate < 1995-03-15] ON c_custkey = o_custkey) JOIN lineitem
    [pushed l_shipdate > 1995-03-15] ON o_orderkey = l_orderkey, grouped
    by (l_orderkey, o_orderdate, o_shippriority), over TableScans."""
    return _q3_tree(_scans(_q3_filters()))


def q3_store_plan(infos: dict):
    """q3_plan's tree with TableReader leaves over the store: one
    selection CopPlan per table of `infos` ({table: TableInfo},
    `table_infos()`), with the same filters."""
    return _q3_tree(_readers(infos, _q3_filters()))


def q3_finish(rows):
    """Q3's host tail over the HashAgg rows (l_orderkey, o_orderdate,
    o_shippriority, revenue): TopN 10 by revenue DESC, o_orderdate, then
    the projection (l_orderkey, revenue, o_orderdate, o_shippriority).
    Ties keep the HashAgg's key order."""
    top = sorted(rows, key=lambda r: (-r[3], r[1]))[:10]
    return [(k, rev, od, sp) for k, od, sp, rev in top]


def _q3_groups(d: ScaledTpch):
    """Every Q3 group from the generator's arrays in exact int64 numpy:
    -> (l_orderkey ascending, revenue at frac 4, o_orderdate in epoch
    micros per order)."""
    cutoff = date_to_micros(Q3_CUTOFF)
    building = d.c_mktsegment == SEGMENTS.index("BUILDING")
    o_date = _days_us(d.o_orderdate)
    o_ok = (o_date < cutoff) & building[d.o_custkey]
    l_ok = (_days_us(d.l_shipdate) > cutoff) & o_ok[d.l_orderkey]
    keys = d.l_orderkey[l_ok]
    rev = (d.l_extendedprice[l_ok].astype(np.int64) *
           (100 - d.l_discount[l_ok].astype(np.int64)))
    order = np.argsort(keys, kind="stable")
    keys, rev = keys[order], rev[order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    uk = keys[starts]
    sums = np.add.reduceat(rev, starts) if keys.size else rev
    return uk, sums, o_date


def q3_groups_truth(d: ScaledTpch) -> list[tuple]:
    """Q3's HashAgg output before its TopN, every group in the HashAgg's
    layout (l_orderkey, o_orderdate in epoch micros, o_shippriority,
    revenue at frac 4), sorted."""
    uk, sums, o_date = _q3_groups(d)
    return list(zip(uk.tolist(), o_date[uk].tolist(),
                    d.o_shippriority[uk].tolist(), sums.tolist()))


def q3_truth(d: ScaledTpch) -> list[tuple]:
    """Q3's rows straight from the generator's arrays in exact int64
    numpy, in run_q3's layout: (l_orderkey, revenue at frac 4,
    o_orderdate in epoch micros, o_shippriority)."""
    uk, sums, o_date = _q3_groups(d)
    top = np.lexsort((uk, o_date[uk], -sums))[:10]
    return [(int(uk[i]), int(sums[i]), int(o_date[uk[i]]),
             int(d.o_shippriority[uk[i]])) for i in top]


Q5_TABLES = ("customer", "orders", "lineitem", "supplier", "nation",
             "region")


def _q5_filters() -> dict:
    """{table: (filter, host_filter)} of Q5's leaves: the o_orderdate
    range pushed, r_name = 'ASIA' on the host."""
    from tidb_tpu_torch.expression import Constant, Op, func
    from tidb_tpu_torch.sqltypes import new_string_field
    out = {t: (None, None) for t in Q5_TABLES}
    od = _leaf_col("orders", "o_orderdate")
    out["orders"] = (func(
        Op.AND, func(Op.GE, od, _date_const(Q5_FROM)),
        # DATE '1994-01-01' + INTERVAL '1' YEAR folds to a DATETIME
        func(Op.LT, od, _date_const(Q5_TO, new_datetime_field()))), None)
    out["region"] = (None, func(Op.EQ, _leaf_col("region", "r_name"),
                                Constant("ASIA", new_string_field())))
    return out


def _q5_tree(leaves: dict):
    """Q5's left-deep HashJoin tree under a HashAgg over `leaves`."""
    from tidb_tpu_torch.executor.agg import HashAgg
    from tidb_tpu_torch.executor.join import HashJoin
    tree = leaves["customer"]
    for right, lkeys, rkeys in (
            ("orders", ["c_custkey"], ["o_custkey"]),
            ("lineitem", ["o_orderkey"], ["l_orderkey"]),
            ("supplier", ["l_suppkey", "c_nationkey"],
             ["s_suppkey", "s_nationkey"]),
            ("nation", ["s_nationkey"], ["n_nationkey"]),
            ("region", ["n_regionkey"], ["r_regionkey"])):
        leaf = leaves[right]
        tree = HashJoin(tree, leaf, [_ref(tree.schema, k) for k in lkeys],
                        [leaf.col(k) for k in rkeys])
    s = tree.schema
    return HashAgg(tree, [_ref(s, "n_name")],
                   [_revenue_sum(_ref(s, "l_extendedprice"),
                                   _ref(s, "l_discount"))])


def q5_plan():
    """Q5's plan as the JAX planner builds it: the FROM-order left-deep
    tree customer JOIN orders [pushed 1994-01-01 <= o_orderdate <
    1995-01-01] ON c_custkey = o_custkey, JOIN lineitem ON o_orderkey =
    l_orderkey, JOIN supplier ON (l_suppkey, c_nationkey) = (s_suppkey,
    s_nationkey), JOIN nation ON s_nationkey = n_nationkey, JOIN region
    [host filter r_name = 'ASIA'] ON n_regionkey = r_regionkey, under a
    HashAgg grouped by n_name, over TableScans."""
    return _q5_tree(_scans(_q5_filters()))


def q5_store_plan(infos: dict):
    """q5_plan's tree with TableReader leaves over the store (see
    q3_store_plan)."""
    return _q5_tree(_readers(infos, _q5_filters()))


def q5_finish(rows):
    """Q5's host tail: Sort by revenue DESC (ties keep n_name order)."""
    return sorted(rows, key=lambda r: -r[1])


def q5_truth(d: ScaledTpch) -> list[tuple]:
    """Q5's rows straight from the generator's arrays in exact int64
    numpy, in run_q5's layout: (n_name, revenue at frac 4)."""
    o_date = _days_us(d.o_orderdate)
    o_ok = (o_date >= date_to_micros(Q5_FROM)) & \
        (o_date < date_to_micros(Q5_TO))
    s_nat = d.s_nationkey[d.l_suppkey]
    c_nat = d.c_nationkey[d.o_custkey[d.l_orderkey]]
    asia = np.array([r == REGIONS.index("ASIA") for _n, r in NATIONS])
    m = o_ok[d.l_orderkey] & (s_nat == c_nat) & asia[s_nat]
    rev = d.l_extendedprice[m].astype(np.int64) * \
        (100 - d.l_discount[m].astype(np.int64))
    nat = s_nat[m]
    rows = []
    for k in sorted(range(len(NATIONS)), key=lambda k: NATIONS[k][0]):
        sel = nat == k
        if sel.any():
            rows.append((NATIONS[k][0], int(rev[sel].sum(dtype=np.int64))))
    return q5_finish(rows)


# per query, how each column of a truth row is formatted the way a
# Session returns it: a decimal's frac, "date" for epoch micros, None
# for a value as it is
_SQL_FORMATS = {"q1": (None, None, 2, 2, 4, 6, 6, 6, 6, None),
                "q3": (None, 4, "date", None),
                "q5": (None, 4)}


def as_session_rows(name: str, rows) -> list[tuple]:
    """Truth rows of query `name` (q1_truth, q3_truth, q5_truth: scaled
    decimals, epoch-micro dates) as `Session.query(...).rows` gives
    them: decimals as Decimal, dates as 'YYYY-MM-DD' strings."""
    from tidb_tpu_torch.sqltypes import format_datetime, scaled_to_decimal

    def one(v, fmt):
        if fmt is None:
            return v
        if fmt == "date":
            return format_datetime(int(v), TypeCode.DATE)
        return scaled_to_decimal(int(v), fmt)

    return [tuple(one(v, f) for v, f in zip(r, _SQL_FORMATS[name]))
            for r in rows]


# query -> (plan builder, host tail) for executor/agg.run_q3 / run_q5
PLANS = {"q3": (q3_plan, q3_finish), "q5": (q5_plan, q5_finish)}
# query -> (the store plan over TableInfos, host tail) for
# executor/agg.run_q3_store / run_q5_store
STORE_PLANS = {"q3": (q3_store_plan, q3_finish),
               "q5": (q5_store_plan, q5_finish)}


Q18_INNER = """
SELECT l_orderkey
FROM lineitem
GROUP BY l_orderkey
HAVING SUM(l_quantity) > 300
"""


def q18_inner_plan():
    """Q18's inner block as the JAX planner builds it after ANALYZE
    (l_orderkey's NDV over the stream-agg threshold): StreamAgg
    (sorted_input=False) grouped by l_orderkey computing SUM(l_quantity)
    over TableScan(lineitem), whose reader keeps every column, with the
    HAVING as a host selection above it. -> (StreamAgg, HAVING predicate
    over the StreamAgg's output (l_orderkey, SUM))."""
    from tidb_tpu_torch.executor.agg import StreamAgg
    from tidb_tpu_torch.executor.scan import TableScan
    from tidb_tpu_torch.expression import (AggDesc, AggFunc, ColumnRef,
                                           Constant, Op, func)
    scan = TableScan("lineitem", LINEITEM_COLUMNS)
    agg = StreamAgg(scan, [scan.col("l_orderkey")],
                    [AggDesc(AggFunc.SUM, scan.col("l_quantity"))],
                    sorted_input=False)
    having = func(Op.GT, ColumnRef(1, agg.aggs[0].result_ft),
                  Constant(300, new_int_field()))
    return agg, having


def q18_groups_truth(d: ScaledTpch) -> tuple[np.ndarray, np.ndarray]:
    """Every group of Q18's inner aggregation from the generator's arrays
    (np.bincount): -> (l_orderkey ascending, SUM(l_quantity) as a scaled
    int at frac 2), both int64."""
    orders = d.counts["orders"]
    cnt = np.bincount(d.l_orderkey, minlength=orders)
    # float64 weights sum small whole quantities exactly
    qty = np.bincount(d.l_orderkey, weights=d.l_quantity, minlength=orders)
    keys = np.flatnonzero(cnt).astype(np.int64)
    return keys, np.rint(qty[keys]).astype(np.int64) * 100


def q18_inner_truth(d: ScaledTpch) -> np.ndarray:
    """Q18's inner block's rows: the l_orderkeys (ascending, int64) whose
    SUM(l_quantity) exceeds 300."""
    keys, sums = q18_groups_truth(d)
    return keys[sums > 300 * 100]


def table_column(chunks, table: str, name: str) -> Column:
    """Column `name` of `table` over all of its chunks, as one Column."""
    j = [n for n, _ft in TABLE_COLUMNS[table]].index(name)
    cols = [c.columns[j] for c in chunks]
    return Column(cols[0].ft, np.concatenate([c.data for c in cols]),
                  np.concatenate([c.valid for c in cols]))


def analyze_columns(d: ScaledTpch | None, names, device=None,
                    chunks=None, table: str = "lineitem") -> dict:
    """ANALYZE of the columns `names` of `table`: {name: ColumnStats}
    built by statistics.build_column_stats on `device` (a column of 2^17
    rows or more sorts there). The table's `chunks` are built from `d`
    unless given."""
    from tidb_tpu_torch.statistics import build_column_stats
    if chunks is None:
        chunks = table_chunks(d, [table])[table]
    return {name: build_column_stats(table_column(chunks, table, name),
                                     device=device)
            for name in names}


# -- the storage path: TPC-H in the mock TiKV store ---------------------------

# table ids the JAX package's DDL (benchmarks/tpch.DDL run in a fresh
# session after CREATE DATABASE tpch) gives each table: with them and the
# column ids below, the port's KV bytes equal the reference's
TABLE_IDS = {"region": 3, "nation": 5, "customer": 7, "supplier": 9,
             "orders": 11, "lineitem": 13}

# what `load` ingests: the generator's arrays per DDL column
_LOAD_ORDER = ("region", "nation", "customer", "supplier", "orders",
               "lineitem")


def table_infos() -> dict:
    """{table: TableInfo} as the JAX DDL builds them (held equal to the
    reference's by tests/test_torch_codec.py): column ids 1.. in DDL
    order, the BIGINT PRIMARY KEY as the row handle (NOT NULL, PRI_KEY
    flags), every other column nullable with a NULL default."""
    from tidb_tpu_torch.schema.model import ColumnInfo, TableInfo
    from tidb_tpu_torch.sqltypes import Flag
    out = {}
    for name, cols in TABLE_COLUMNS.items():
        infos = []
        for j, (cname, ft) in enumerate(cols):
            if j == 0:
                ft = ft.with_flags(int(Flag.NOT_NULL) | int(Flag.PRI_KEY))
            infos.append(ColumnInfo(id=j + 1, name=cname, offset=j, ft=ft,
                                    has_default=j != 0))
        out[name] = TableInfo(id=TABLE_IDS[name], name=name, columns=infos,
                              pk_is_handle=True, pk_col_name=cols[0][0],
                              max_column_id=len(cols))
    return out


def _load_columns(d: ScaledTpch, table: str) -> dict:
    """{column name: array} that `bulkload.bulk_load` ingests for
    `table`: the JAX package's tpch.load arrays (strings as object
    arrays, decimals scaled, dates epoch micros)."""
    lanes, _n = _table_lanes(d, table)
    out = {}
    for (name, _ft), lane in zip(TABLE_COLUMNS[table], lanes):
        if isinstance(lane, tuple):
            idx, values = lane
            lane = np.array(values, dtype=object)[np.asarray(idx)]
        out[name] = np.asarray(lane)
    return out


def write_tsv(d: ScaledTpch, table: str, path) -> int:
    """Write `table` as the tab-separated text LOAD DATA reads by default
    (no enclosure, `\\` escapes): one line per row, the columns in DDL
    order, decimals with their two fraction digits, dates as YYYY-MM-DD.
    -> rows written."""
    lanes, n = _table_lanes(d, table)
    cols = []
    for (_name, ft), lane in zip(TABLE_COLUMNS[table], lanes):
        if isinstance(lane, tuple):
            idx, values = lane
            col = np.array(values, dtype=str)[np.asarray(idx)]
        elif ft.tp == TypeCode.DATE:
            days = np.asarray(lane, dtype=np.int64) // 86_400_000_000
            col = (np.datetime64("1970-01-01", "D") +
                   days.astype("timedelta64[D]")).astype(str)
        elif ft.tp == TypeCode.NEWDECIMAL:
            v = np.asarray(lane, dtype=np.int64)
            col = np.char.add(np.char.add((v // 100).astype(str), "."),
                              np.char.zfill((v % 100).astype(str), 2))
        else:
            col = np.asarray(lane, dtype=np.int64).astype(str)
        cols.append(col)
    line = cols[0]
    for col in cols[1:]:
        line = np.char.add(np.char.add(line, "\t"), col)
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write("\n".join(line.tolist()))
        f.write("\n")
    return n


def load_store(storage, d: ScaledTpch, regions_per_table: int = 4,
               infos: dict | None = None) -> int:
    """Bulk ingest of the six tables into `storage` (the port of the JAX
    package's tpch.load, without the DDL: the TableInfos come from
    `table_infos`), then the region pre-split of lineitem and orders.
    No auto-id rebase: every table's primary key is its handle, and the
    port has no meta layer. -> total rows loaded."""
    from tidb_tpu_torch.table import Table, bulkload
    infos = infos or table_infos()
    total = 0
    for name in _LOAD_ORDER:
        total += bulkload.bulk_load(storage, Table(infos[name], storage),
                                    _load_columns(d, name),
                                    rebase_autoid=False)
    cluster = storage.cluster
    for name in ("lineitem", "orders"):
        cluster.split_table(infos[name].id, regions_per_table,
                            max_handle=d.counts[name])
    return total


def q1_cop_plan(info):
    """The CopPlan the JAX planner pushes for Q1 over lineitem's
    TableInfo `info`: every column scanned, the q1_plan filter, group-by
    and aggregates over them."""
    from tidb_tpu_torch.plan.physical import CopPlan
    flt, group_exprs, aggs = q1_plan()
    return CopPlan(table=info, cols=list(info.columns), filter=flt,
                   group_exprs=group_exprs, aggs=aggs)


@dataclass
class WriteBatch:
    """One OLTP write batch on lineitem: `updates` (handles) get new
    `upd_qty` (scaled, frac 2) and `upd_flag` (l_returnflag strings),
    `deletes` (handles) go, `inserts` ({column: array}, l_id the handle)
    come in."""

    updates: np.ndarray
    upd_qty: np.ndarray
    upd_flag: np.ndarray
    deletes: np.ndarray
    inserts: dict


def write_batch(d: ScaledTpch, candidates: np.ndarray, seed: int,
                updates: int, inserts: int = 0, deletes: int = 0,
                next_handle: int = 0, new_flag: str | None = None
                ) -> WriteBatch:
    """A seeded batch over the live lineitem handles `candidates`:
    distinct handles to update and delete, inserts at handles from
    `next_handle` with the generator's value ranges (their orders drawn
    from d's), the first insert's l_returnflag `new_flag` where given."""
    rng = np.random.default_rng(seed)
    picks = rng.choice(candidates, updates + deletes, replace=False)
    flags = np.array(FLAGS, dtype=object)
    ins = {}
    if inserts:
        ok = rng.integers(0, d.counts["orders"], inserts)
        ship = d.o_orderdate[ok] + rng.integers(1, 122, inserts)
        ins = {"l_id": next_handle + np.arange(inserts, dtype=np.int64),
               "l_orderkey": ok,
               "l_suppkey": rng.integers(0, d.counts["supplier"], inserts),
               "l_quantity": rng.integers(1, 51, inserts) * 100,
               "l_extendedprice": rng.integers(90000, 10500000, inserts),
               "l_discount": rng.integers(0, 11, inserts),
               "l_tax": rng.integers(0, 9, inserts),
               "l_returnflag": flags[rng.integers(0, 3, inserts)],
               "l_linestatus": np.array(STATUSES, dtype=object)[
                   rng.integers(0, 2, inserts)],
               "l_shipdate": _days_us(ship),
               "l_commitdate": _days_us(d.o_orderdate[ok] +
                                        rng.integers(30, 92, inserts)),
               "l_receiptdate": _days_us(ship +
                                         rng.integers(1, 31, inserts))}
        if new_flag is not None:
            ins["l_returnflag"][0] = new_flag
    return WriteBatch(updates=np.sort(picks[:updates]),
                      upd_qty=rng.integers(1, 51, updates) * 100,
                      upd_flag=flags[rng.integers(0, 3, updates)],
                      deletes=np.sort(picks[updates:]), inserts=ins)


def commit_batch(storage, b: WriteBatch, info=None) -> int:
    """`b` as one transaction: storage.begin(), Table.update_record /
    remove_record over each row's stored datums, Table.add_record per
    insert, commit. -> rows written."""
    from tidb_tpu_torch import tablecodec
    from tidb_tpu_torch.table import Table
    info = info or table_infos()["lineitem"]
    table = Table(info, storage)
    txn = storage.begin()
    try:
        def old(h):
            return tablecodec.decode_row(
                txn.get(tablecodec.record_key(info.id, int(h))))
        for h, q, f in zip(b.updates, b.upd_qty, b.upd_flag):
            table.update_record(txn, int(h), old(h),
                                {"l_quantity": (2, int(q)),
                                 "l_returnflag": f})
        for h in b.deletes:
            table.remove_record(txn, int(h), old(h))
        names = list(b.inserts)
        for i in range(len(b.inserts.get("l_id", ()))):
            vals = {}
            for name in names:
                v = b.inserts[name][i]
                ft = info.col_by_name(name).ft
                vals[name] = (2, int(v)) if ft.frac == 2 else \
                    (v if isinstance(v, str) else int(v))
            table.add_record(txn, vals)
        txn.commit()
    except Exception:
        txn.rollback()
        raise
    return len(b.updates) + len(b.deletes) + len(b.inserts.get("l_id", ()))


def _scaled2(v: int) -> str:
    """A frac-2 scaled integer as a DECIMAL literal."""
    v = int(v)
    sign = "-" if v < 0 else ""
    return f"{sign}{abs(v) // 100}.{abs(v) % 100:02d}"


def _date_literal(us: int) -> str:
    """An epoch-microsecond DATE datum as a 'YYYY-MM-DD' literal."""
    day = _EPOCH_DATE + datetime.timedelta(
        microseconds=int(us) - _epoch_us())
    return f"'{day.isoformat()}'"


def sql_batch(b: WriteBatch) -> list[str]:
    """`b` as SQL statements, in commit_batch's order: one single-row
    UPDATE per updated handle (l_quantity as a frac-2 DECIMAL literal,
    so the stored datum is commit_batch's), DELETE ... WHERE l_id IN
    (...) of the deleted handles, at most ranger.MAX_RANGES a statement
    (so each reads its rows by point ranges, not by a table scan), one
    multi-row INSERT of the inserts (DATE columns as date literals)."""
    from tidb_tpu_torch.ranger import MAX_RANGES
    out = [f"UPDATE lineitem SET l_quantity = {_scaled2(q)}, "
           f"l_returnflag = '{f}' WHERE l_id = {int(h)}"
           for h, q, f in zip(b.updates, b.upd_qty, b.upd_flag)]
    for i in range(0, len(b.deletes), MAX_RANGES):
        out.append("DELETE FROM lineitem WHERE l_id IN (" + ", ".join(
            str(int(h)) for h in b.deletes[i:i + MAX_RANGES]) + ")")
    n = len(b.inserts.get("l_id", ()))
    if n:
        names = list(b.inserts)
        ets = dict(LINEITEM_COLUMNS)
        fmt = [{EvalType.DECIMAL: _scaled2,
                EvalType.DATETIME: _date_literal,
                EvalType.STRING: lambda v: f"'{v}'"}.get(
                    ets[name].eval_type, lambda v: str(int(v)))
               for name in names]
        rows = ["(" + ", ".join(f(b.inserts[name][i])
                                for f, name in zip(fmt, names)) + ")"
                for i in range(n)]
        out.append(f"INSERT INTO lineitem ({', '.join(names)}) VALUES " +
                   ", ".join(rows))
    return out


class Q1Mirror:
    """Q1's lanes of lineitem as numpy arrays, kept in step with the
    write batches committed to the store, for an exact truth after each
    (q1_truth_of over the live rows)."""

    def __init__(self, d: ScaledTpch):
        self.flag_names = list(FLAGS)
        self.cols = {"flag": d.l_returnflag.astype(np.int64),
                     "status": d.l_linestatus.astype(np.int64),
                     "qty": d.l_quantity * 100,
                     "price": d.l_extendedprice.astype(np.int64),
                     "disc": d.l_discount.astype(np.int64),
                     "tax": d.l_tax.astype(np.int64),
                     "ship": _days_us(d.l_shipdate)}
        self.alive = np.ones(d.counts["lineitem"], dtype=bool)

    def _codes(self, names) -> np.ndarray:
        for f in names:
            if f not in self.flag_names:
                self.flag_names.append(f)
        return np.array([self.flag_names.index(f) for f in names],
                        dtype=np.int64)

    def apply(self, b: WriteBatch) -> None:
        c = self.cols
        c["qty"][b.updates] = b.upd_qty
        c["flag"][b.updates] = self._codes(b.upd_flag)
        self.alive[b.deletes] = False
        if b.inserts:
            ins = b.inserts
            n = len(ins["l_id"])
            assert ins["l_id"][0] == len(self.alive), "inserts append"
            new = {"flag": self._codes(ins["l_returnflag"]),
                   "status": np.array([STATUSES.index(x)
                                       for x in ins["l_linestatus"]]),
                   "qty": ins["l_quantity"],
                   "price": ins["l_extendedprice"],
                   "disc": ins["l_discount"], "tax": ins["l_tax"],
                   "ship": ins["l_shipdate"]}
            for k in c:
                c[k] = np.concatenate([c[k], np.asarray(new[k],
                                                        dtype=np.int64)])
            self.alive = np.concatenate([self.alive,
                                         np.ones(n, dtype=bool)])

    def truth(self) -> list[tuple]:
        c, m = self.cols, self.alive
        return q1_truth_of(c["flag"][m], c["status"][m], c["qty"][m],
                           c["price"][m], c["disc"][m], c["tax"][m],
                           c["ship"][m], flag_names=self.flag_names)
