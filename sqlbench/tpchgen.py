"""A frozen copy of the port's counter-based TPC-H generator, with a seed.

Every value is a pure function of (table, column, row index, seed)
through splitmix64, as in ``trino_tpu_torch/connectors/tpch.py``, whose
formulas this file copies: schema, cardinalities and value distributions
follow TPC-H v3.0.1 clause 4.2. The seed is mixed into every column's
stream (``seed * SEED_MIX`` added to the column's tag), so each seed is
a different database with the same distributions, and seed 0 gives the
port's own rows.

Plain NumPy, with no import of the engine: the benchmark generates the
tables once, hands the same arrays to the engine's memory connector and
to the plain reference, and later changes to the port's generator do
not move the benchmark's data. A string column comes back as
``(codes, pool)``: int32 codes into a list of strings.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Sequence, Tuple

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
#: the seed's multiplier: an odd constant, so distinct seeds move every
#: column's stream apart and seed 0 leaves it as the port's
SEED_MIX = 0xD1B54A32D192ED03


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = (x + _GOLDEN).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _tag(name: str) -> int:
    h = 1469598103934665603
    for ch in name.encode():
        h = ((h ^ ch) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


class Streams:
    """The column streams of one seed."""

    def __init__(self, seed: int):
        self.mix = (int(seed) * SEED_MIX) & 0xFFFFFFFFFFFFFFFF

    def h64(self, rows: np.ndarray, tag: str) -> np.ndarray:
        key = np.uint64((_tag(tag) + self.mix) & 0xFFFFFFFFFFFFFFFF)
        with np.errstate(over="ignore"):
            return _splitmix64(rows.astype(np.uint64) * _GOLDEN + key)

    def hmod(self, rows: np.ndarray, tag: str, n: int) -> np.ndarray:
        return (self.h64(rows, tag) % np.uint64(n)).astype(np.int64)


# ---------------------------------------------------------------------------
# spec word lists (TPC-H v3.0.1 clause 4.2.2.13)

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIP_INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN"]
SHIP_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod", "green",
    "grey", "honeydew", "hot", "indian", "ivory", "khaki", "lace", "lavender",
    "lawn", "lemon", "light", "lime", "linen", "magenta", "maroon", "medium",
    "metallic", "midnight", "mint", "misty", "moccasin", "navajo", "navy",
    "olive", "orange", "orchid", "pale", "papaya", "peach", "peru", "pink",
    "plum", "powder", "puff", "purple", "red", "rose", "rosy", "royal",
    "saddle", "salmon", "sandy", "seashell", "sienna", "sky", "slate",
    "smoke", "snow", "spring", "steel", "tan", "thistle", "tomato",
    "turquoise", "violet", "wheat", "white", "yellow",
]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("RUSSIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_TEXT_WORDS = [
    "packages", "requests", "accounts", "deposits", "foxes", "ideas",
    "theodolites", "instructions", "dependencies", "excuses", "platelets",
    "asymptotes", "courts", "dolphins", "multipliers", "sauternes",
    "warthogs", "frets", "dinos", "attainments", "somas", "braids",
    "frays", "warhorses", "dugouts", "notornis", "epitaphs", "pearls",
    "tithes", "waters", "orbits", "gifts", "sheaves", "patterns", "forges",
    "realms", "pains", "pinto", "beans", "hockey", "players", "about",
    "carefully", "quickly", "furiously", "slyly", "blithely", "daringly",
    "fluffily", "express", "regular", "special", "pending", "ironic",
    "final", "bold", "unusual", "even", "silent", "against", "along",
    "among", "around", "believe", "detect", "integrate", "sleep", "nag",
    "use", "wake", "above", "after", "boost", "cajole", "haggle", "the",
]


def days(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01: how a DATE is stored."""
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


START = days(1992, 1, 1)
END = days(1998, 12, 31)
CURRENT = days(1995, 6, 17)
ORDER_DATE_SPAN = END - START - 151

SCHEMAS = {"micro": 0.001, "tiny": 0.01, "sf1": 1.0, "sf10": 10.0}


def counts(sf: float) -> Dict[str, int]:
    return {
        "region": 5,
        "nation": 25,
        "supplier": max(1, int(10_000 * sf)),
        "customer": max(1, int(150_000 * sf)),
        "part": max(1, int(200_000 * sf)),
        "partsupp": max(1, int(200_000 * sf)) * 4,
        "orders": max(1, int(1_500_000 * sf)),
    }


# ---------------------------------------------------------------------------
# helpers


def _pooled(values: List[str]) -> Tuple[np.ndarray, List[str]]:
    """A list of strings as (codes, pool), one pool entry per distinct
    value in order of first appearance."""
    index: Dict[str, int] = {}
    codes = np.fromiter((index.setdefault(v, len(index)) for v in values),
                        dtype=np.int32, count=len(values))
    return codes, list(index)


#: rows of a comment column built at a time (bounds the byte matrix)
_COMMENT_CHUNK = 1 << 20


def _comment(s: Streams, rows, tag: str, max_words: int = 8) -> List[str]:
    """3 to ``max_words`` words of ``_TEXT_WORDS`` joined by spaces: the
    port's formula, built as one byte matrix a chunk of rows at a time
    (each word slot a separator and the word, padded with zero bytes)
    and split into strings once."""
    words = [w.encode() for w in _TEXT_WORDS]
    width = 1 + max(len(w) for w in words)
    table = np.zeros((len(words), width), dtype=np.uint8)
    for i, w in enumerate(words):
        table[i, 1:1 + len(w)] = np.frombuffer(w, dtype=np.uint8)
    table[:, 0] = ord(" ")
    out: List[str] = []
    for lo in range(0, len(rows), _COMMENT_CHUNK):
        part = rows[lo:lo + _COMMENT_CHUNK]
        nw = 3 + s.hmod(part, tag + ".n", max_words - 2)
        picks = np.stack([s.hmod(part, f"{tag}.{i}", len(_TEXT_WORDS))
                          for i in range(max_words)], axis=1)
        chars = table[picks]
        chars[np.arange(max_words)[None, :] >= nw[:, None]] = 0
        chars[:, 0, 0] = ord("\n")
        flat = chars.reshape(-1)
        out.extend(flat[flat != 0].tobytes().decode("ascii").split("\n")[1:])
    return out


def _alnum(s: Streams, rows, tag: str, lo: int, hi: int) -> List[str]:
    alphabet = np.asarray(list(
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789 ,"),
        dtype=object)
    ln = lo + s.hmod(rows, tag + ".len", hi - lo + 1)
    chars = [alphabet[s.hmod(rows, f"{tag}.{i}", len(alphabet))]
             for i in range(hi)]
    return ["".join(chars[j][i] for j in range(ln[i]))
            for i in range(len(rows))]


def _phone(s: Streams, nationkey, rows, tag: str) -> List[str]:
    a = nationkey + 10
    b = s.hmod(rows, tag + ".b", 900) + 100
    c = s.hmod(rows, tag + ".c", 900) + 100
    d = s.hmod(rows, tag + ".d", 9000) + 1000
    return [f"{a[i]}-{b[i]}-{c[i]}-{d[i]}" for i in range(len(rows))]


def _acctbal(s: Streams, rows, tag: str) -> np.ndarray:
    return s.hmod(rows, tag, 999_99 + 999_999 + 1) - 999_99


def _nonzero_mod3_key(idx: np.ndarray) -> np.ndarray:
    return 3 * (idx // 2) + 1 + (idx % 2)


def retail_price(partkey: np.ndarray) -> np.ndarray:
    return 90_000 + ((partkey // 10) % 20_001) + 100 * (partkey % 1_000)


def supp_for_part(partkey, i, scount: int) -> np.ndarray:
    sc = np.int64(scount)
    return ((partkey + i * (sc // 4 + (partkey - 1) // sc)) % sc) + 1


def lines_per_order(s: Streams, order_idx: np.ndarray) -> np.ndarray:
    return 1 + s.hmod(np.asarray(order_idx, dtype=np.int64), "o.nlines", 7)


def _ranges(cnt: np.ndarray) -> np.ndarray:
    total = int(cnt.sum())
    idx = np.arange(total, dtype=np.int64)
    return idx - np.repeat(np.cumsum(cnt) - cnt, cnt)


def _order_rollup(s: Streams, order_idx, od, sf: float):
    pcount = counts(sf)["part"]
    n = len(order_idx)
    nlines = lines_per_order(s, order_idx)
    all_f = np.ones(n, dtype=bool)
    all_o = np.ones(n, dtype=bool)
    total = np.zeros(n, dtype=np.int64)
    for line in range(7):
        has = nlines > line
        g = order_idx * np.int64(8) + line
        ship = od + 1 + s.hmod(g, "l.ship", 121)
        is_o = ship > CURRENT
        all_f &= ~has | ~is_o
        all_o &= ~has | is_o
        qty = 1 + s.hmod(g, "l.qty", 50)
        p = 1 + s.hmod(g, "l.part", pcount)
        ext = qty * retail_price(p)
        disc = s.hmod(g, "l.disc", 11)
        tax = s.hmod(g, "l.tax", 9)
        prod = ext * (100 + tax) * (100 - disc)
        total += np.where(has, (prod + 5_000) // 10_000, 0)
    status = np.where(all_f, 0, np.where(all_o, 1, 2))
    return status, total


# ---------------------------------------------------------------------------
# tables


def _gen_region(s, sf, rows, cols):
    return {"r_regionkey": rows,
            "r_name": [REGIONS[i] for i in rows],
            "r_comment": (lambda: _comment(s, rows, "r.comment"))}


def _gen_nation(s, sf, rows, cols):
    return {"n_nationkey": rows,
            "n_name": [NATIONS[i][0] for i in rows],
            "n_regionkey": np.asarray([NATIONS[i][1] for i in rows]),
            "n_comment": (lambda: _comment(s, rows, "n.comment"))}


def _gen_supplier(s, sf, rows, cols):
    key = rows + 1
    nat = s.hmod(rows, "s.nation", 25)

    def comment():
        out = _comment(s, rows, "s.comment")
        flag = s.h64(rows, "s.cmplnt") % np.uint64(2000)
        for i in np.nonzero(flag == 0)[0]:
            out[i] = out[i] + " Customer Complaints"
        for i in np.nonzero(flag == 1)[0]:
            out[i] = out[i] + " Customer Recommends"
        return out

    return {"s_suppkey": key,
            "s_name": lambda: [f"Supplier#{k:09d}" for k in key],
            "s_address": lambda: _alnum(s, rows, "s.addr", 10, 40),
            "s_nationkey": nat,
            "s_phone": lambda: _phone(s, nat, rows, "s.phone"),
            "s_acctbal": lambda: _acctbal(s, rows, "s.acctbal"),
            "s_comment": comment}


def _gen_customer(s, sf, rows, cols):
    key = rows + 1
    nat = s.hmod(rows, "c.nation", 25)
    return {"c_custkey": key,
            "c_name": lambda: [f"Customer#{k:09d}" for k in key],
            "c_address": lambda: _alnum(s, rows, "c.addr", 10, 40),
            "c_nationkey": nat,
            "c_phone": lambda: _phone(s, nat, rows, "c.phone"),
            "c_acctbal": lambda: _acctbal(s, rows, "c.acctbal"),
            "c_mktsegment": lambda: (s.hmod(rows, "c.segment", 5), SEGMENTS),
            "c_comment": lambda: _comment(s, rows, "c.comment", 10)}


def _gen_part(s, sf, rows, cols):
    key = rows + 1
    m = 1 + s.hmod(rows, "p.mfgr", 5)

    def name():
        picks = [s.hmod(rows, f"p.name.{i}", len(COLORS)) for i in range(5)]
        return [" ".join(COLORS[picks[j][i]] for j in range(5))
                for i in range(len(rows))]

    def brand():
        n = 1 + s.hmod(rows, "p.brand", 5)
        pool = [f"Brand#{a}{b}" for a in range(1, 6) for b in range(1, 6)]
        return (m - 1) * 5 + (n - 1), pool

    def type_():
        t1 = s.hmod(rows, "p.type1", 6)
        t2 = s.hmod(rows, "p.type2", 5)
        t3 = s.hmod(rows, "p.type3", 5)
        pool = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
                for c in TYPE_S3]
        return t1 * 25 + t2 * 5 + t3, pool

    def container():
        c1 = s.hmod(rows, "p.cont1", 5)
        c2 = s.hmod(rows, "p.cont2", 8)
        pool = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
        return c1 * 8 + c2, pool

    return {"p_partkey": key, "p_name": name,
            "p_mfgr": lambda: (m - 1,
                               [f"Manufacturer#{v}" for v in range(1, 6)]),
            "p_brand": brand, "p_type": type_,
            "p_size": lambda: 1 + s.hmod(rows, "p.size", 50),
            "p_container": container,
            "p_retailprice": lambda: retail_price(key),
            "p_comment": lambda: _comment(s, rows, "p.comment", 5)}


def _gen_partsupp(s, sf, rows, cols):
    p = rows // 4 + 1
    return {"ps_partkey": p,
            "ps_suppkey": supp_for_part(p, rows % 4,
                                        counts(sf)["supplier"]),
            "ps_availqty": lambda: 1 + s.hmod(rows, "ps.avail", 9999),
            "ps_supplycost": lambda: 100 + s.hmod(rows, "ps.cost", 99_901),
            "ps_comment": lambda: _comment(s, rows, "ps.comment", 12)}


def _gen_orders(s, sf, rows, cols):
    ccount = counts(sf)["customer"]
    od = START + s.hmod(rows, "o.date", ORDER_DATE_SPAN)
    rollup = {}

    def rolled(i):
        if not rollup:
            rollup["v"] = _order_rollup(s, rows, od, sf)
        return rollup["v"][i]

    def custkey():
        idx = s.hmod(rows, "o.cust", max(1, ccount // 3 * 2))
        return np.minimum(_nonzero_mod3_key(idx), ccount)

    def clerk():
        ck = 1 + s.hmod(rows, "o.clerk", max(1, int(1000 * sf)))
        return [f"Clerk#{v:09d}" for v in ck]

    def comment():
        out = _comment(s, rows, "o.comment", 10)
        flag = s.h64(rows, "o.spreq") % np.uint64(100)
        for i in np.nonzero(flag == 0)[0]:
            out[i] = out[i] + " special requests"
        return out

    return {"o_orderkey": rows + 1, "o_custkey": custkey,
            "o_orderdate": od.astype(np.int32),
            "o_orderstatus": lambda: (rolled(0), ["F", "O", "P"]),
            "o_totalprice": lambda: rolled(1),
            "o_orderpriority": lambda: (s.hmod(rows, "o.prio", 5),
                                        PRIORITIES),
            "o_clerk": clerk,
            "o_shippriority": lambda: np.zeros(len(rows), dtype=np.int64),
            "o_comment": comment}


def _gen_lineitem(s, sf, rows, cols):
    # ``rows`` are ORDER indices; the lines of each order follow it
    nlines = lines_per_order(s, rows)
    o = np.repeat(rows, nlines)
    ln = _ranges(nlines)
    g = o * np.int64(8) + ln
    pcount = counts(sf)["part"]
    scount = counts(sf)["supplier"]
    part = {}

    def p():
        if not part:
            part["p"] = 1 + s.hmod(g, "l.part", pcount)
        return part["p"]

    qty = 1 + s.hmod(g, "l.qty", 50)
    od = START + s.hmod(o, "o.date", ORDER_DATE_SPAN)
    ship = od + 1 + s.hmod(g, "l.ship", 121)
    receipt = {}

    def rcpt():
        if not receipt:
            receipt["r"] = ship + 1 + s.hmod(g, "l.rcpt", 30)
        return receipt["r"]

    def returnflag():
        r = s.hmod(g, "l.rflag", 2)
        return np.where(rcpt() <= CURRENT, np.where(r == 0, 0, 1), 2), \
            ["R", "A", "N"]

    return {"l_orderkey": o + 1, "l_partkey": p,
            "l_suppkey": lambda: supp_for_part(
                p(), s.hmod(g, "l.supp", 4), scount),
            "l_linenumber": ln + 1, "l_quantity": qty * 100,
            "l_extendedprice": lambda: qty * retail_price(p()),
            "l_discount": lambda: s.hmod(g, "l.disc", 11),
            "l_tax": lambda: s.hmod(g, "l.tax", 9),
            "l_returnflag": returnflag,
            "l_linestatus": lambda: (np.where(ship > CURRENT, 0, 1),
                                     ["O", "F"]),
            "l_shipdate": ship.astype(np.int32),
            "l_commitdate": lambda: (od + 30 + s.hmod(g, "l.commit", 61)
                                     ).astype(np.int32),
            "l_receiptdate": lambda: rcpt().astype(np.int32),
            "l_shipinstruct": lambda: (s.hmod(g, "l.instr", 4),
                                       SHIP_INSTRUCT),
            "l_shipmode": lambda: (s.hmod(g, "l.mode", 7), SHIP_MODES),
            "l_comment": lambda: _comment(s, g, "l.comment", 6)}


#: the load order
TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")

_GENERATORS = {"region": _gen_region, "nation": _gen_nation,
               "supplier": _gen_supplier, "customer": _gen_customer,
               "part": _gen_part, "partsupp": _gen_partsupp,
               "orders": _gen_orders, "lineitem": _gen_lineitem}


def source_rows(table: str, sf: float) -> int:
    """Rows the table's generator ranges over: orders for lineitem."""
    return counts(sf)["orders" if table == "lineitem" else table]


def generate(table: str, sf: float, columns: Sequence[str], seed: int,
             start: int = 0, end: int = -1) -> Dict[str, object]:
    """The columns of ``table`` over source rows [start, end) (orders for
    lineitem): a numeric column as an ndarray, a string column as
    ``(codes, pool)``."""
    end = source_rows(table, sf) if end < 0 else end
    rows = np.arange(start, end, dtype=np.int64)
    made = _GENERATORS[table](Streams(seed), sf, rows, set(columns))
    out = {}
    for c in columns:
        v = made[c]
        v = v() if callable(v) else v
        if isinstance(v, list):
            v = _pooled(v)
        elif isinstance(v, tuple):
            v = (np.asarray(v[0], dtype=np.int32), list(v[1]))
        out[c] = v
    return out


def line_counts(sf: float, seed: int, start: int = 0,
                end: int = -1) -> np.ndarray:
    """Lines of each order in [start, end)."""
    end = counts(sf)["orders"] if end < 0 else end
    return lines_per_order(Streams(seed), np.arange(start, end,
                                                    dtype=np.int64))


def split_pages(n: int, desired_splits: int,
                page_rows: int) -> List[Tuple[int, int]]:
    """Source-row ranges of the pages a scan of the port's TPC-H
    connector makes: ``desired_splits`` splits over n rows (at most one
    per 1,024 rows), each read ``page_rows`` rows at a time."""
    k = max(1, min(desired_splits, (n + 1023) // 1024))
    bounds = np.linspace(0, n, k + 1).astype(int)
    out = []
    for i in range(k):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        for a in range(lo, hi, page_rows):
            out.append((a, min(a + page_rows, hi)))
    return out


def page_bounds(table: str, sf: float, seed: int, desired_splits: int,
                page_rows: int) -> List[Tuple[int, int]]:
    """(first row, end row) of each page of ``table``: ``split_pages``
    over its source rows, a lineitem page holding the lines of its
    orders."""
    bounds = split_pages(source_rows(table, sf), desired_splits, page_rows)
    if table == "lineitem":
        ends = np.concatenate(
            [[0], np.cumsum(line_counts(sf, seed))])
        bounds = [(int(ends[a]), int(ends[b])) for a, b in bounds]
    return bounds
