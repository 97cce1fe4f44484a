"""The plain reference for TPC-H Q1 (clause 2.4.1, queries/tpch/q1.sql):
its rows over the generated lineitem columns with numpy, as the text the
MySQL wire sends.

It imports nothing of the program and takes nothing the program made:
the columns come from the benchmark's generator (datasets/tpch.py).
Exact sums are Python integers; `precision="float64"` sums in float64
instead, the control that must come out wrong.
"""

from __future__ import annotations

import datetime

import numpy as np

from benchmark.datasets import tpch as data

# the table whose rows the statement scans: its input rows
BASE_TABLE = "lineitem"
# l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY, as a day offset
CUTOFF = (datetime.date(1998, 12, 1) - datetime.timedelta(days=90)
          - data.EPOCH).days
# group g = returnflag * 2 + linestatus; A < N < R and F < O, so groups
# in g order are Q1's ORDER BY order
GROUPS = [(f, s) for f in range(len(data.FLAGS))
          for s in range(len(data.STATUSES))]


def sums(li: dict, precision: str = "exact") -> list:
    """Q1's sums per group over lineitem columns `li`: [count, qty,
    price, disc_price, charge, disc] for each of GROUPS."""
    ship_ok = np.asarray(li["l_shipdate"]) <= CUTOFF
    g = np.asarray(li["l_returnflag"]) * 2 + np.asarray(li["l_linestatus"])
    ty = np.float64 if precision == "float64" else np.int64
    price = np.asarray(li["l_extendedprice"]).astype(ty)
    disc = np.asarray(li["l_discount"]).astype(ty)
    qty = np.asarray(li["l_quantity"]).astype(ty)
    tax = np.asarray(li["l_tax"]).astype(ty)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    out = []
    for gi in range(len(GROUPS)):
        m = ship_ok & (g == gi)
        row = [int(np.count_nonzero(m))]
        for a in (qty, price, disc_price, charge, disc):
            s = np.sum(a[m])
            row.append(s.item() if precision == "float64" else int(s))
        out.append(row)
    return out


def _avg(total, count: int, precision: str) -> int:
    """AVG of a frac-2 decimal at frac 6, rounded half up."""
    if precision == "float64":
        return int(np.round(float(total) * 1e4 / count))
    q, r = divmod(abs(int(total)) * 10 ** 4, count)
    q += 2 * r >= count
    return q if total >= 0 else -q


def answer(t, precision: str = "exact") -> list:
    """Q1's rows over the loaded lineitem table, as text."""
    as_int = (lambda v: int(round(v))) if precision == "float64" else int
    rows = []
    for (f, s), (n, qty, price, dprice, charge, disc) in zip(
            GROUPS, sums(t.cols, precision)):
        if not n:
            continue
        rows.append((data.FLAGS[f], data.STATUSES[s],
                     data.dec_text(as_int(qty), 2),
                     data.dec_text(as_int(price), 2),
                     data.dec_text(as_int(dprice), 4),
                     data.dec_text(as_int(charge), 6),
                     data.dec_text(_avg(qty, n, precision), 6),
                     data.dec_text(_avg(price, n, precision), 6),
                     data.dec_text(_avg(disc, n, precision), 6),
                     str(n)))
    return rows
