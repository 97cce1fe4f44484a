"""Scaled TPC-H lineitem for the port's Q1 path.

The numpy generator is a copy of the JAX package's
benchmarks/tpch.ScaledTpch with the same draw order, so one `seed` gives
the same tables in both packages. Row counts follow the TPC-H spec's
cardinalities (sf=1 ~ 6M lineitem rows). Where the JAX package ingests
the tables through its storage layer and SQL front end, the port (which
has neither yet) builds the lineitem scan chunks directly and carries
the plan that the JAX planner pushes to the coprocessor for Q1.

Overflow: Q1's sum_charge lane is scaled by 10^6; at sf 10 one group's
sum comes to about 1.5e18, under int64's 9.2e18. At sf 100 it would
overflow, in both packages.
"""

from __future__ import annotations

import datetime

import numpy as np

from tidb_tpu_torch.chunk import Chunk, Column
from tidb_tpu_torch.sqltypes import (FieldType, TypeCode, date_to_micros,
                                     new_datetime_field, new_decimal_field,
                                     new_int_field, parse_datetime)

__all__ = ["ScaledTpch", "Q1", "LINEITEM_COLUMNS", "lineitem_chunks",
           "q1_plan", "q1_truth"]

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


_DEC = new_decimal_field(flen=15, frac=2)
_CHAR1 = FieldType(TypeCode.STRING, flen=1)
_BIGINT = new_int_field()

# lineitem's leading columns in DDL order, as the scan decodes them: Q1
# reads positions 3-9, and its plan refers to them by these positions
LINEITEM_COLUMNS = [
    ("l_id", _BIGINT), ("l_orderkey", _BIGINT), ("l_suppkey", _BIGINT),
    ("l_quantity", _DEC), ("l_extendedprice", _DEC), ("l_discount", _DEC),
    ("l_tax", _DEC), ("l_returnflag", _CHAR1), ("l_linestatus", _CHAR1),
    ("l_shipdate", FieldType(TypeCode.DATE)),
]


def lineitem_chunks(d: ScaledTpch, rows: int = 1 << 18) -> list[Chunk]:
    """lineitem as Chunks of `rows` rows (the last one shorter), with the
    columns of LINEITEM_COLUMNS. Integer columns are views of the
    generator's arrays; decimals are scaled ints (frac 2) and dates epoch
    micros, as the JAX package loads them. The two CHAR(1) columns carry
    their dictionary encoding from the generator's index arrays, set as
    each column's dict_encode memo, so no per-row encode pass runs."""
    n = d.counts["lineitem"]
    ones = np.ones(n, dtype=bool)
    lanes = [np.arange(n, dtype=np.int64), d.l_orderkey, d.l_suppkey,
             d.l_quantity * 100, d.l_extendedprice, d.l_discount, d.l_tax,
             d.l_returnflag, d.l_linestatus, _days_us(d.l_shipdate)]
    lanes = [np.asarray(a, dtype=np.int64) for a in lanes]
    dicts = {7: (np.array(FLAGS, dtype=object), FLAGS),
             8: (np.array(STATUSES, dtype=object), STATUSES)}
    out = []
    for s in range(0, n, max(int(rows), 1)):
        e = min(n, s + rows)
        cols = []
        for j, (_name, ft) in enumerate(LINEITEM_COLUMNS):
            a = lanes[j][s:e]
            if j in dicts:
                strs, values = dicts[j]
                c = Column(ft, strs[a], ones[s:e])
                c._enc = (a, list(values))
            else:
                c = Column(ft, a, ones[s:e])
            cols.append(c)
        out.append(Chunk(cols))
    return out


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
    cutoff = date_to_micros(datetime.date(1998, 12, 1) -
                            datetime.timedelta(days=90))
    live = _days_us(d.l_shipdate) <= cutoff
    gid = d.l_returnflag.astype(np.int64) * len(STATUSES) + d.l_linestatus
    qty = d.l_quantity.astype(np.int64) * 100
    price = d.l_extendedprice.astype(np.int64)
    disc = d.l_discount.astype(np.int64)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + d.l_tax.astype(np.int64))

    def avg(total: int, count: int) -> int:    # frac 2 -> 6, half up
        q, r = divmod(abs(total) * 10 ** 4, count)
        q += 2 * r >= count
        return q if total >= 0 else -q

    rows = []
    for f, flag in enumerate(FLAGS):
        for s, status in enumerate(STATUSES):
            m = live & (gid == f * len(STATUSES) + s)
            count = int(np.count_nonzero(m))
            if not count:
                continue
            sq, sp, sd, sc, sdisc = (
                int(np.sum(a, where=m, dtype=np.int64))
                for a in (qty, price, disc_price, charge, disc))
            rows.append((flag, status, sq, sp, sd, sc, avg(sq, count),
                         avg(sp, count), avg(sdisc, count), count))
    return rows
