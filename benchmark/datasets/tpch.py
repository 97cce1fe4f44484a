"""TPC-H data for the benchmark: a generator of the published tables'
columns (TPC-H clause 1.4) with the distributions of clause 4.2.3, the
schema, and the load through the program's DDL and bulk load.

The generator is the benchmark's own, so that no change to the program
moves the benchmark's data. Orders and lineitem are drawn as clause
4.2.3 draws them: sparse order keys, 1 to 7 lineitems an order, the
retail price of the part, the supplier from the part, and the return
flag and line status from the dates against CURRENTDATE (1995-06-17).
Text columns are substrings of a pseudo-text built from clause
4.2.2.10's word lists. Dates are day offsets from 1992-01-01; decimals
are integers scaled by 100 (l_discount and l_tax are whole percents, so
0.05 is 5); a column of a fixed list of strings holds its index into the
list; a text column holds Python strings.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np

FLAGS = ["A", "N", "R"]
STATUSES = ["F", "O"]
ORDER_STATUSES = ["F", "O", "P"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]

EPOCH = datetime.date(1992, 1, 1)
# microseconds from 1970-01-01 to 1992-01-01 (UTC), the DATE datum's base
EPOCH_US = (EPOCH - datetime.date(1970, 1, 1)).days * 86_400_000_000
DAY_US = 86_400_000_000
# clause 4.2.3: CURRENTDATE, and the last order date (ENDDATE - 151 days)
CURRENT = (datetime.date(1995, 6, 17) - EPOCH).days
LAST_ORDER = (datetime.date(1998, 12, 31) - datetime.timedelta(days=151)
              - EPOCH).days

# clause 1.4.1's columns; clause 1.4.2 makes constraints optional, and
# the program's bulk load writes no index, so lineitem's compound key
# is not declared (rows get the hidden row handle, as TiDB gives them)
DDL = {
    "orders": "CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, "
              "o_custkey BIGINT, o_orderstatus CHAR(1), "
              "o_totalprice DECIMAL(15,2), o_orderdate DATE, "
              "o_orderpriority CHAR(15), o_clerk CHAR(15), "
              "o_shippriority INTEGER, o_comment VARCHAR(79))",
    "lineitem": "CREATE TABLE lineitem (l_orderkey BIGINT, "
                "l_partkey BIGINT, l_suppkey BIGINT, l_linenumber INTEGER, "
                "l_quantity DECIMAL(15,2), l_extendedprice DECIMAL(15,2), "
                "l_discount DECIMAL(15,2), l_tax DECIMAL(15,2), "
                "l_returnflag CHAR(1), l_linestatus CHAR(1), "
                "l_shipdate DATE, l_commitdate DATE, l_receiptdate DATE, "
                "l_shipinstruct CHAR(25), l_shipmode CHAR(10), "
                "l_comment VARCHAR(44))",
}
# each table's columns in DDL order, with how a value is stored: "int",
# "dec" (scaled by 100), "date" (day offset), "text" (str), or a list of
# strings that the stored index selects from
COLUMNS = {
    "orders": [("o_orderkey", "int"), ("o_custkey", "int"),
               ("o_orderstatus", ORDER_STATUSES), ("o_totalprice", "dec"),
               ("o_orderdate", "date"), ("o_orderpriority", PRIORITIES),
               ("o_clerk", "text"), ("o_shippriority", "int"),
               ("o_comment", "text")],
    "lineitem": [("l_orderkey", "int"), ("l_partkey", "int"),
                 ("l_suppkey", "int"), ("l_linenumber", "int"),
                 ("l_quantity", "dec"), ("l_extendedprice", "dec"),
                 ("l_discount", "dec"), ("l_tax", "dec"),
                 ("l_returnflag", FLAGS), ("l_linestatus", STATUSES),
                 ("l_shipdate", "date"), ("l_commitdate", "date"),
                 ("l_receiptdate", "date"),
                 ("l_shipinstruct", INSTRUCTIONS), ("l_shipmode", MODES),
                 ("l_comment", "text")],
}
LOAD_ORDER = ("orders", "lineitem")
# rows a bulk load takes at once: the program's bulk load encodes a
# string column's distinct values one by one over the whole batch, so a
# column of distinct comments costs it batch x distinct
LOAD_BATCH = 512

# clause 4.2.2.10's word lists
_NOUNS = ("foxes ideas theodolites pinto_beans instructions dependencies "
          "excuses platelets asymptotes courts dolphins multipliers "
          "sauternes warthogs frets dinos attainments somas Tiresias' "
          "patterns forges braids hockey_players frays warhorses dugouts "
          "notornis epitaphs pearls tithes waters orbits gifts sheaves "
          "depths sentiments decoys realms pains grouches escapades")
_VERBS = ("sleep wake are cajole haggle nag use boost affix detect "
          "integrate maintain nod was lose sublate solve thrash promise "
          "engage hinder print x-ray breach eat grow impress mold poach "
          "serve run dazzle snooze doze unwind kindle play hang believe "
          "doubt")
_ADJECTIVES = ("furious sly careful blithe quick fluffy slow quiet ruthless "
               "thin close dogged daring brave stealthy permanent enticing "
               "idle busy regular final ironic even bold silent")
_ADVERBS = ("sometimes always never furiously slyly carefully blithely "
            "quickly fluffily slowly quietly ruthlessly thinly closely "
            "doggedly daringly bravely stealthily permanently enticingly "
            "idly busily regularly finally ironically evenly boldly "
            "silently")
_PREPOSITIONS = ("about above according_to across after against along "
                 "alongside_of among around at atop before behind beneath "
                 "beside besides between beyond by despite during except "
                 "for from in_place_of inside instead_of into near of on "
                 "outside over past since through throughout to toward "
                 "under until up upon without with within")
_AUXILIARIES = ("do may might shall will would can could should ought_to "
                "must will_have_to shall_have_to could_have_to "
                "should_have_to must_have_to need_to try_to")
_TERMINATORS = (".", ";", ":", "?", "!", "--")
TEXT_POOL_CHARS = 1 << 20


def _words(s: str) -> list:
    return [w.replace("_", " ") for w in s.split()]


def text_pool(rng) -> str:
    """Pseudo-text of TEXT_POOL_CHARS characters: sentences of clause 4.2.2.10's
    grammar (noun phrase, verb phrase, an optional prepositional phrase,
    a terminator) over its word lists."""
    nouns, verbs = _words(_NOUNS), _words(_VERBS)
    adjs, advs = _words(_ADJECTIVES), _words(_ADVERBS)
    preps, auxs = _words(_PREPOSITIONS), _words(_AUXILIARIES)
    parts, n = [], 0
    while n < TEXT_POOL_CHARS:
        draw = rng.integers(0, 1 << 30, 9)

        def pick(words, i):
            return words[int(draw[i]) % len(words)]
        noun_phrase = [pick(nouns, 0)]
        if draw[1] % 2:
            noun_phrase.insert(0, pick(adjs, 2))
        verb_phrase = [pick(verbs, 3)]
        if draw[4] % 3 == 0:
            verb_phrase.insert(0, pick(auxs, 5))
        if draw[4] % 2:
            verb_phrase.append(pick(advs, 6))
        words = noun_phrase + verb_phrase
        if draw[7] % 2:
            words += [pick(preps, 8), "the", pick(nouns, 1)]
        s = " ".join(words) + _TERMINATORS[int(draw[2]) % 6] + " "
        parts.append(s)
        n += len(s)
    return "".join(parts)[:TEXT_POOL_CHARS]


def text_column(rng, pool: str, n: int, lo: int, hi: int) -> np.ndarray:
    """`n` text strings of lengths uniform in [lo, hi], each from a
    random offset of the pool (clause 4.2.2.10)."""
    lens = rng.integers(lo, hi + 1, n)
    offs = rng.integers(0, len(pool) - hi, n)
    out = np.empty(n, dtype=object)
    out[:] = [pool[o:o + ln] for o, ln in zip(offs.tolist(), lens.tolist())]
    return out


def sparse_keys(i: np.ndarray) -> np.ndarray:
    """Clause 4.2.3's sparse order keys: of every 32 keys the first 8 are
    used (dbgen's MK_SPARSE with its 3 kept and 2 gap bits)."""
    return (i >> 3) * 32 + (i & 7)


def retail_price(partkey: np.ndarray) -> np.ndarray:
    """P_RETAILPRICE in cents (clause 4.2.3)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


@dataclass
class Tables:
    """Every column of every table as a numpy array, with the row
    counts."""

    cols: dict
    counts: dict


def generate(cfg: dict, seed: int) -> Tables:
    """Orders and lineitem at cfg["scale_factor"] from `seed`."""
    sf = float(cfg["scale_factor"])
    rng = np.random.default_rng(seed)
    pool = text_pool(rng)
    n_orders = max(int(1_500_000 * sf), 200)
    customers = max(int(150_000 * sf), 50)
    parts = max(int(200_000 * sf), 80)
    suppliers = max(int(10_000 * sf), 20)
    clerks = max(int(1_000 * sf), 1)
    c = {}
    c["o_orderkey"] = sparse_keys(np.arange(1, n_orders + 1, dtype=np.int64))
    # O_CUSTKEY: uniform over the keys that are not a multiple of 3
    j = rng.integers(0, customers - customers // 3, n_orders)
    c["o_custkey"] = j + j // 2 + 1
    c["o_orderdate"] = rng.integers(0, LAST_ORDER + 1, n_orders)
    c["o_orderpriority"] = rng.integers(0, len(PRIORITIES), n_orders)
    c["o_clerk"] = np.array([f"Clerk#{k:09d}" for k in
                             rng.integers(1, clerks + 1, n_orders).tolist()],
                            dtype=object)
    c["o_shippriority"] = np.zeros(n_orders, dtype=np.int64)
    c["o_comment"] = text_column(rng, pool, n_orders, 19, 78)

    per_order = rng.integers(1, 8, n_orders)
    n = int(per_order.sum())
    order_of = np.repeat(np.arange(n_orders), per_order)
    first = np.concatenate([[0], np.cumsum(per_order)[:-1]])
    c["l_orderkey"] = c["o_orderkey"][order_of]
    c["l_linenumber"] = np.arange(n) - first[order_of] + 1
    partkey = rng.integers(1, parts + 1, n)
    c["l_partkey"] = partkey
    i = rng.integers(0, 4, n)
    c["l_suppkey"] = (partkey + i * (suppliers // 4 + (partkey - 1) //
                                     suppliers)) % suppliers + 1
    qty = rng.integers(1, 51, n)
    c["l_quantity"] = qty * 100
    c["l_extendedprice"] = qty * retail_price(partkey)
    c["l_discount"] = rng.integers(0, 11, n)
    c["l_tax"] = rng.integers(0, 9, n)
    odate = c["o_orderdate"][order_of]
    c["l_shipdate"] = odate + rng.integers(1, 122, n)
    c["l_commitdate"] = odate + rng.integers(30, 91, n)
    c["l_receiptdate"] = c["l_shipdate"] + rng.integers(1, 31, n)
    returned = np.where(rng.integers(0, 2, n) == 1, 2, 0)   # R or A
    c["l_returnflag"] = np.where(c["l_receiptdate"] <= CURRENT, returned, 1)
    c["l_linestatus"] = (c["l_shipdate"] > CURRENT).astype(np.int64)
    c["l_shipinstruct"] = rng.integers(0, len(INSTRUCTIONS), n)
    c["l_shipmode"] = rng.integers(0, len(MODES), n)
    c["l_comment"] = text_column(rng, pool, n, 10, 43)

    # O_ORDERSTATUS and O_TOTALPRICE follow from the lineitems
    charge = (c["l_extendedprice"] * (100 - c["l_discount"]) // 100
              * (100 + c["l_tax"]) // 100)
    c["o_totalprice"] = np.bincount(order_of, weights=charge,
                                    minlength=n_orders).astype(np.int64)
    open_lines = np.bincount(order_of, weights=c["l_linestatus"],
                             minlength=n_orders).astype(np.int64)
    c["o_orderstatus"] = np.where(open_lines == 0, 0,
                                  np.where(open_lines == per_order, 1, 2))
    return Tables(c, {"orders": n_orders, "lineitem": n})


def _bulk_columns(t: Tables, table: str, rows: slice) -> dict:
    """{column: array} of `rows` as the program's bulk load takes them:
    integers and scaled decimals as int64, dates as epoch microseconds,
    strings as object arrays."""
    out = {}
    for name, kind in COLUMNS[table]:
        a = t.cols[name][rows]
        if kind == "date":
            a = EPOCH_US + a.astype(np.int64) * DAY_US
        elif isinstance(kind, list):
            a = np.array(kind, dtype=object)[a]
        elif kind != "text":
            a = np.asarray(a, dtype=np.int64)
        out[name] = a
    return out


def load(session, storage, t: Tables, cfg: dict, tables) -> dict:
    """CREATE DATABASE and the schema's tables through `session` (the
    program's DDL), the bulk load of `tables` (the program's
    bulkload.bulk_load, LOAD_BATCH rows at a time; lineitem's rows get
    handles 1..n in generated order), then SPLIT TABLE ... AT the evenly
    spaced handles of cfg["regions"]. -> {table: rows loaded}."""
    from tidb_tpu_torch.table import Table, bulkload
    session.execute(f"CREATE DATABASE {cfg['database']}")
    session.execute(f"USE {cfg['database']}")
    for name in LOAD_ORDER:
        session.execute(DDL[name])
    ischema = session.domain.info_schema()
    loaded = {}
    for name in LOAD_ORDER:
        if name not in tables:
            continue
        table = Table(ischema.table(cfg["database"], name), storage)
        n = t.counts[name]
        keyed = table.info.pk_is_handle
        loaded[name] = 0
        for lo in range(0, n, LOAD_BATCH):
            rows = slice(lo, min(lo + LOAD_BATCH, n))
            handles = None if keyed else \
                np.arange(rows.start + 1, rows.stop + 1, dtype=np.int64)
            loaded[name] += bulkload.bulk_load(
                storage, table, _bulk_columns(t, name, rows), handles,
                rebase_autoid=rows.stop == n)
    for name, n in cfg.get("regions", {}).items():
        if name in tables and n > 1:
            keys = t.cols["o_orderkey"] if name == "orders" else \
                np.arange(1, t.counts[name] + 1)
            step = len(keys) // n
            at = ", ".join(f"({int(keys[step * i])})" for i in range(1, n))
            session.execute(f"SPLIT TABLE {name} AT {at}")
    return loaded


# -- text as the server sends it ----------------------------------------------

def dec_text(v: int, frac: int = 2) -> str:
    """A scaled integer as DECIMAL text with `frac` fraction digits."""
    v = int(v)
    sign = "-" if v < 0 else ""
    q, r = divmod(abs(v), 10 ** frac)
    return f"{sign}{q}.{r:0{frac}d}" if frac else f"{sign}{q}"
