"""The generator follows TPC-H clause 4.2.3, and the plain reference
matches a straightforward computation at a tiny size: Q1 with Python
decimals, row by row."""

import datetime
from decimal import ROUND_HALF_UP, Decimal

import numpy as np
import pytest

from benchmark import catalog
from benchmark.datasets import tpch as tpch_data

CUTOFF = datetime.date(1998, 9, 2)
CURRENT = datetime.date(1995, 6, 17)


@pytest.fixture(scope="module")
def tables():
    return tpch_data.generate({"scale_factor": 0.002}, 2**31 + 77)


def _q1_plain(t):
    """Q1 over lineitem's rows with Python Decimals, as MySQL defines it."""
    c = t.cols
    groups = {}
    for i in range(t.counts["lineitem"]):
        ship = tpch_data.EPOCH + datetime.timedelta(days=int(c["l_shipdate"][i]))
        if ship > CUTOFF:
            continue
        key = (tpch_data.FLAGS[c["l_returnflag"][i]],
               tpch_data.STATUSES[c["l_linestatus"][i]])
        g = groups.setdefault(key, [0, Decimal(0), Decimal(0), Decimal(0),
                                    Decimal(0), Decimal(0)])
        qty = Decimal(int(c["l_quantity"][i])) / 100
        price = Decimal(int(c["l_extendedprice"][i])) / 100
        disc = Decimal(int(c["l_discount"][i])) / 100
        tax = Decimal(int(c["l_tax"][i])) / 100
        g[0] += 1
        g[1] += qty
        g[2] += price
        g[3] += price * (1 - disc)
        g[4] += price * (1 - disc) * (1 + tax)
        g[5] += disc
    out = []
    six = Decimal("0.000001")
    for key in sorted(groups):
        n, qty, price, dp, ch, disc = groups[key]
        out.append((key[0], key[1], f"{qty:.2f}", f"{price:.2f}", f"{dp:.4f}",
                    f"{ch:.6f}",
                    str((qty / n).quantize(six, ROUND_HALF_UP)),
                    str((price / n).quantize(six, ROUND_HALF_UP)),
                    str((disc / n).quantize(six, ROUND_HALF_UP)), str(n)))
    return out


def _q1():
    return catalog.Cell(catalog.spec()["workloads"][0]["name"]).reference("q1")


def test_q1_matches_plain_decimals(tables):
    rows = _q1().answer(tables)
    assert rows == _q1_plain(tables)
    # clause 4.2.3's flags and statuses give Q1 its four groups
    assert [r[:2] for r in rows] == [("A", "F"), ("N", "F"), ("N", "O"),
                                     ("R", "F")]


def test_lineitems_follow_clause_4_2_3(tables):
    c, n_orders = tables.cols, tables.counts["orders"]
    per_order = np.bincount(np.searchsorted(c["o_orderkey"], c["l_orderkey"]),
                            minlength=n_orders)
    assert per_order.min() == 1 and per_order.max() == 7
    assert tables.counts["lineitem"] == per_order.sum()
    # sparse keys: the first 8 of every 32
    assert np.all((c["o_orderkey"] % 32) < 8)
    assert np.all(np.diff(c["o_orderkey"]) > 0)
    assert c["o_orderkey"][0] == 1 and c["o_orderkey"][8] == 33
    assert np.all(c["o_custkey"] % 3 != 0)
    first = np.concatenate([[True], np.diff(c["l_orderkey"]) != 0])
    assert np.all(c["l_linenumber"][first] == 1)
    pk = c["l_partkey"]
    assert np.array_equal(c["l_extendedprice"],
                          c["l_quantity"] // 100 * tpch_data.retail_price(pk))
    s = max(int(10_000 * 0.002), 20)
    ok = [(pk + i * (s // 4 + (pk - 1) // s)) % s + 1 for i in range(4)]
    assert np.all(np.any([c["l_suppkey"] == o for o in ok], axis=0))
    cur = (CURRENT - tpch_data.EPOCH).days
    flag = np.array(tpch_data.FLAGS)[c["l_returnflag"]]
    late = c["l_receiptdate"] > cur
    assert np.all(flag[late] == "N") and set(flag[~late]) == {"A", "R"}
    status = np.array(tpch_data.STATUSES)[c["l_linestatus"]]
    assert np.array_equal(status == "O", c["l_shipdate"] > cur)
    lens = np.array([len(x) for x in c["l_comment"]])
    assert lens.min() >= 10 and lens.max() <= 43
    assert len(set(c["l_comment"])) > 0.9 * len(lens)


def test_orders_follow_their_lineitems(tables):
    c = tables.cols
    order_of = np.searchsorted(c["o_orderkey"], c["l_orderkey"])
    charge = (c["l_extendedprice"] * (100 - c["l_discount"]) // 100
              * (100 + c["l_tax"]) // 100)
    for o in range(0, tables.counts["orders"], 97):
        mine = order_of == o
        assert c["o_totalprice"][o] == charge[mine].sum()
        st = set(c["l_linestatus"][mine].tolist())
        want = "F" if st == {0} else "O" if st == {1} else "P"
        assert tpch_data.ORDER_STATUSES[c["o_orderstatus"][o]] == want
    assert c["o_orderdate"].min() >= 0
    assert c["o_orderdate"].max() <= tpch_data.LAST_ORDER


def test_orders_and_lineitem_load_and_read_back():
    import torch

    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    t = tpch_data.generate({"scale_factor": 0.0002}, 2**40 + 9)
    storage = new_mock_storage(device=torch.device("cpu"))
    sess = Session(storage)
    cfg = {"database": "tpch", "regions": {"orders": 4, "lineitem": 4}}
    loaded = tpch_data.load(sess, storage, t, cfg, ["orders", "lineitem"])
    assert loaded == t.counts
    c = t.cols
    i = t.counts["orders"] // 2
    rows = sess.execute(f"SELECT o_orderkey, o_orderstatus, o_totalprice, "
                        f"o_clerk FROM orders WHERE o_orderkey = "
                        f"{c['o_orderkey'][i]}")[0].rows
    assert [tuple(map(str, r)) for r in rows] == [(
        str(c["o_orderkey"][i]),
        tpch_data.ORDER_STATUSES[c["o_orderstatus"][i]],
        tpch_data.dec_text(c["o_totalprice"][i]), c["o_clerk"][i])]
    rows = sess.execute("SELECT COUNT(*), SUM(l_linenumber), "
                        "MAX(LENGTH(l_comment)) FROM lineitem")[0].rows
    assert [tuple(map(str, r)) for r in rows] == [(
        str(t.counts["lineitem"]), str(int(c["l_linenumber"].sum())),
        str(max(len(x) for x in c["l_comment"])))]


def test_same_seed_same_tables():
    a = tpch_data.generate({"scale_factor": 0.001}, 2**40 + 3)
    b = tpch_data.generate({"scale_factor": 0.001}, 2**40 + 3)
    for k in a.cols:
        assert np.array_equal(a.cols[k], b.cols[k]), k
