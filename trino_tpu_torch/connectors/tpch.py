"""TPC-H synthetic data connector.

Reference analog: ``plugin/trino-tpch`` (TpchConnectorFactory, TpchMetadata,
TpchRecordSetProvider — itself wrapping an airlift port of dbgen).

This is a from-scratch, vectorized, *counter-based* generator: every value
is a pure function of (table, column, row index) through splitmix64, so a
split can generate any row range independently — deterministic regardless
of split count or worker placement. Schema, cardinalities and value
distributions follow the TPC-H specification (v3.0 §4.2); the RNG streams
are NOT dbgen's, so rows differ from dbgen output while matching its
distributions. Correctness testing cross-checks queries against a sqlite
oracle loaded with THIS generator's data (SURVEY.md §4's H2QueryRunner
analog), so bit-parity with dbgen is not required.

Schemas: tiny (SF 0.01), sf1, sf10, sf100, sf1000.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import types as T
from ..block import Block, Dictionary, Page
from ..expr.functions import days_from_civil_host
from .spi import (ColumnHandle, Connector, ConnectorMetadata,
                  ConnectorPageSource, ConnectorSplit, ConnectorSplitManager,
                  ColumnStatistics, TableHandle, TableStatistics)

# ---------------------------------------------------------------------------
# counter-based RNG: splitmix64, vectorized

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = (x + _GOLDEN).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _tag(name: str) -> np.uint64:
    h = np.uint64(1469598103934665603)
    for ch in name.encode():
        with np.errstate(over="ignore"):
            h = (h ^ np.uint64(ch)) * np.uint64(1099511628211)
    return h


def h64(rows: np.ndarray, tag: str) -> np.ndarray:
    """Deterministic uint64 stream for a column over row indices."""
    with np.errstate(over="ignore"):
        return _splitmix64(rows.astype(np.uint64) * _GOLDEN + _tag(tag))


def hmod(rows: np.ndarray, tag: str, n: int) -> np.ndarray:
    return (h64(rows, tag) % np.uint64(n)).astype(np.int64)


# ---------------------------------------------------------------------------
# spec word lists (TPC-H v3.0 §4.2.2.13)

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

_START = days_from_civil_host(1992, 1, 1)
_END = days_from_civil_host(1998, 12, 31)
_CURRENT = days_from_civil_host(1995, 6, 17)
_ORDER_DATE_SPAN = _END - _START - 151

D12_2 = T.decimal_type(12, 2)

_SCHEMAS = {"micro": 0.001, "tiny": 0.01, "sf1": 1.0, "sf10": 10.0,
            "sf100": 100.0, "sf1000": 1000.0}


def _counts(sf: float) -> Dict[str, int]:
    return {
        "region": 5,
        "nation": 25,
        "supplier": max(1, int(10_000 * sf)),
        "customer": max(1, int(150_000 * sf)),
        "part": max(1, int(200_000 * sf)),
        "partsupp": max(1, int(200_000 * sf)) * 4,
        "orders": max(1, int(1_500_000 * sf)),
        # lineitem count is derived (avg ~4 lines/order)
    }


_TABLE_COLUMNS: Dict[str, List] = {
    "region": [("r_regionkey", T.BIGINT), ("r_name", T.varchar_type(25)),
               ("r_comment", T.varchar_type(152))],
    "nation": [("n_nationkey", T.BIGINT), ("n_name", T.varchar_type(25)),
               ("n_regionkey", T.BIGINT), ("n_comment", T.varchar_type(152))],
    "supplier": [("s_suppkey", T.BIGINT), ("s_name", T.varchar_type(25)),
                 ("s_address", T.varchar_type(40)),
                 ("s_nationkey", T.BIGINT), ("s_phone", T.varchar_type(15)),
                 ("s_acctbal", D12_2), ("s_comment", T.varchar_type(101))],
    "customer": [("c_custkey", T.BIGINT), ("c_name", T.varchar_type(25)),
                 ("c_address", T.varchar_type(40)),
                 ("c_nationkey", T.BIGINT), ("c_phone", T.varchar_type(15)),
                 ("c_acctbal", D12_2),
                 ("c_mktsegment", T.varchar_type(10)),
                 ("c_comment", T.varchar_type(117))],
    "part": [("p_partkey", T.BIGINT), ("p_name", T.varchar_type(55)),
             ("p_mfgr", T.varchar_type(25)), ("p_brand", T.varchar_type(10)),
             ("p_type", T.varchar_type(25)), ("p_size", T.BIGINT),
             ("p_container", T.varchar_type(10)), ("p_retailprice", D12_2),
             ("p_comment", T.varchar_type(23))],
    "partsupp": [("ps_partkey", T.BIGINT), ("ps_suppkey", T.BIGINT),
                 ("ps_availqty", T.BIGINT), ("ps_supplycost", D12_2),
                 ("ps_comment", T.varchar_type(199))],
    "orders": [("o_orderkey", T.BIGINT), ("o_custkey", T.BIGINT),
               ("o_orderstatus", T.varchar_type(1)), ("o_totalprice", D12_2),
               ("o_orderdate", T.DATE),
               ("o_orderpriority", T.varchar_type(15)),
               ("o_clerk", T.varchar_type(15)), ("o_shippriority", T.BIGINT),
               ("o_comment", T.varchar_type(79))],
    "lineitem": [("l_orderkey", T.BIGINT), ("l_partkey", T.BIGINT),
                 ("l_suppkey", T.BIGINT), ("l_linenumber", T.BIGINT),
                 ("l_quantity", D12_2), ("l_extendedprice", D12_2),
                 ("l_discount", D12_2), ("l_tax", D12_2),
                 ("l_returnflag", T.varchar_type(1)),
                 ("l_linestatus", T.varchar_type(1)),
                 ("l_shipdate", T.DATE), ("l_commitdate", T.DATE),
                 ("l_receiptdate", T.DATE),
                 ("l_shipinstruct", T.varchar_type(25)),
                 ("l_shipmode", T.varchar_type(10)),
                 ("l_comment", T.varchar_type(44))],
}


def _comment(rows: np.ndarray, tag: str, max_words: int = 8) -> List[str]:
    nw = 3 + hmod(rows, tag + ".n", max_words - 2)
    picks = [hmod(rows, f"{tag}.{i}", len(_TEXT_WORDS)) for i in range(max_words)]
    words = np.asarray(_TEXT_WORDS, dtype=object)
    cols = [words[p] for p in picks]
    return [" ".join(cols[j][i] for j in range(nw[i]))
            for i in range(len(rows))]


def _alnum(rows: np.ndarray, tag: str, lo: int, hi: int) -> List[str]:
    alphabet = np.asarray(list(
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789 ,"),
        dtype=object)
    ln = lo + hmod(rows, tag + ".len", hi - lo + 1)
    mx = hi
    chars = [alphabet[hmod(rows, f"{tag}.{i}", len(alphabet))]
             for i in range(mx)]
    return ["".join(chars[j][i] for j in range(ln[i]))
            for i in range(len(rows))]


def _phone(nationkey: np.ndarray, rows: np.ndarray, tag: str) -> List[str]:
    a = nationkey + 10
    b = hmod(rows, tag + ".b", 900) + 100
    c = hmod(rows, tag + ".c", 900) + 100
    d = hmod(rows, tag + ".d", 9000) + 1000
    return [f"{a[i]}-{b[i]}-{c[i]}-{d[i]}" for i in range(len(rows))]


def _acctbal(rows: np.ndarray, tag: str) -> np.ndarray:
    # [-999.99, 9999.99] as scaled int64
    return hmod(rows, tag, 999_99 + 999_999 + 1) - 999_99


def _nonzero_mod3_key(idx: np.ndarray) -> np.ndarray:
    """Map dense index -> the idx-th positive integer not divisible by 3
    (spec: a third of customers never place orders)."""
    return 3 * (idx // 2) + 1 + (idx % 2)


class _Table:
    """Generates column arrays for a row range. Dictionaries for string
    columns live on the connector so code spaces are stable across splits
    and pages (group-by/join correctness relies on this)."""

    def __init__(self, conn: "TpchConnector", name: str):
        self.conn = conn
        self.name = name
        self.columns = _TABLE_COLUMNS[name]
        self.dicts: Dict[str, Dictionary] = {}
        for cname, ctype in self.columns:
            if ctype.is_string:
                self.dicts[cname] = Dictionary()

    def row_count(self, sf: float) -> int:
        if self.name == "lineitem":
            orders = _counts(sf)["orders"]
            return int(_lines_per_order(np.arange(orders)).sum())
        return _counts(sf)[self.name]

    def generate(self, sf: float, start: int, end: int,
                 columns: Sequence[str]) -> Page:
        rows = np.arange(start, end, dtype=np.int64)
        gen = getattr(self, f"_gen_{self.name}")
        data = gen(sf, rows, set(columns))
        blocks = []
        for cname in columns:
            ctype = dict(self.columns)[cname]
            vals = data[cname]
            if ctype.is_string:
                d = self.dicts[cname]
                if isinstance(vals, tuple):
                    # fast path: (codes into pool, pool) — vectorized remap
                    codes_in, pool = vals
                    remap = d.encode(pool)
                    codes = remap[np.asarray(codes_in, dtype=np.int64)]
                else:
                    codes = d.encode(vals)
                blocks.append(Block(ctype, codes.astype(np.int32), None, d))
            else:
                blocks.append(Block(ctype, np.asarray(vals, dtype=ctype.storage)))
        n = len(blocks[0]) if blocks else end - start
        return Page(blocks, n)

    # -- per-table generators ------------------------------------------

    def _gen_region(self, sf, rows, cols):
        out = {}
        out["r_regionkey"] = rows
        out["r_name"] = [REGIONS[i] for i in rows]
        out["r_comment"] = _comment(rows, "r.comment")
        return out

    def _gen_nation(self, sf, rows, cols):
        out = {}
        out["n_nationkey"] = rows
        out["n_name"] = [NATIONS[i][0] for i in rows]
        out["n_regionkey"] = np.asarray([NATIONS[i][1] for i in rows])
        out["n_comment"] = _comment(rows, "n.comment")
        return out

    def _gen_supplier(self, sf, rows, cols):
        out = {}
        key = rows + 1
        out["s_suppkey"] = key
        if "s_name" in cols:
            out["s_name"] = [f"Supplier#{k:09d}" for k in key]
        if "s_address" in cols:
            out["s_address"] = _alnum(rows, "s.addr", 10, 40)
        nat = hmod(rows, "s.nation", 25)
        out["s_nationkey"] = nat
        if "s_phone" in cols:
            out["s_phone"] = _phone(nat, rows, "s.phone")
        if "s_acctbal" in cols:
            out["s_acctbal"] = _acctbal(rows, "s.acctbal")
        if "s_comment" in cols:
            comments = _comment(rows, "s.comment")
            # spec 4.2.3: ~5 per 10k suppliers get Customer...Complaints,
            # ~5 get Customer...Recommends
            flag = h64(rows, "s.cmplnt") % np.uint64(2000)
            for i in np.nonzero(flag == 0)[0]:
                comments[i] = comments[i] + " Customer Complaints"
            for i in np.nonzero(flag == 1)[0]:
                comments[i] = comments[i] + " Customer Recommends"
            out["s_comment"] = comments
        return out

    def _gen_customer(self, sf, rows, cols):
        out = {}
        key = rows + 1
        out["c_custkey"] = key
        if "c_name" in cols:
            out["c_name"] = [f"Customer#{k:09d}" for k in key]
        if "c_address" in cols:
            out["c_address"] = _alnum(rows, "c.addr", 10, 40)
        nat = hmod(rows, "c.nation", 25)
        out["c_nationkey"] = nat
        if "c_phone" in cols:
            out["c_phone"] = _phone(nat, rows, "c.phone")
        if "c_acctbal" in cols:
            out["c_acctbal"] = _acctbal(rows, "c.acctbal")
        if "c_mktsegment" in cols:
            out["c_mktsegment"] = (hmod(rows, "c.segment", 5), SEGMENTS)
        if "c_comment" in cols:
            out["c_comment"] = _comment(rows, "c.comment", 10)
        return out

    def _gen_part(self, sf, rows, cols):
        out = {}
        key = rows + 1
        out["p_partkey"] = key
        if "p_name" in cols:
            picks = [hmod(rows, f"p.name.{i}", len(COLORS)) for i in range(5)]
            out["p_name"] = [" ".join(COLORS[picks[j][i]] for j in range(5))
                             for i in range(len(rows))]
        m = 1 + hmod(rows, "p.mfgr", 5)
        if "p_mfgr" in cols:
            out["p_mfgr"] = (m - 1, [f"Manufacturer#{v}" for v in range(1, 6)])
        if "p_brand" in cols:
            n = 1 + hmod(rows, "p.brand", 5)
            pool = [f"Brand#{a}{b}" for a in range(1, 6) for b in range(1, 6)]
            out["p_brand"] = ((m - 1) * 5 + (n - 1), pool)
        if "p_type" in cols:
            t1 = hmod(rows, "p.type1", 6)
            t2 = hmod(rows, "p.type2", 5)
            t3 = hmod(rows, "p.type3", 5)
            pool = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
                    for c in TYPE_S3]
            out["p_type"] = (t1 * 25 + t2 * 5 + t3, pool)
        if "p_size" in cols:
            out["p_size"] = 1 + hmod(rows, "p.size", 50)
        if "p_container" in cols:
            c1 = hmod(rows, "p.cont1", 5)
            c2 = hmod(rows, "p.cont2", 8)
            pool = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
            out["p_container"] = (c1 * 8 + c2, pool)
        if "p_retailprice" in cols:
            out["p_retailprice"] = _retail_price(key)
        if "p_comment" in cols:
            out["p_comment"] = _comment(rows, "p.comment", 5)
        return out

    def _gen_partsupp(self, sf, rows, cols):
        out = {}
        scount = _counts(sf)["supplier"]
        p = rows // 4 + 1
        i = rows % 4
        out["ps_partkey"] = p
        out["ps_suppkey"] = _supp_for_part(p, i, scount)
        if "ps_availqty" in cols:
            out["ps_availqty"] = 1 + hmod(rows, "ps.avail", 9999)
        if "ps_supplycost" in cols:
            out["ps_supplycost"] = 100 + hmod(rows, "ps.cost", 99_901)
        if "ps_comment" in cols:
            out["ps_comment"] = _comment(rows, "ps.comment", 12)
        return out

    def _gen_orders(self, sf, rows, cols):
        out = {}
        ccount = _counts(sf)["customer"]
        key = rows + 1
        out["o_orderkey"] = key
        if "o_custkey" in cols:
            idx = hmod(rows, "o.cust", max(1, ccount // 3 * 2))
            out["o_custkey"] = np.minimum(_nonzero_mod3_key(idx), ccount)
        od = _START + hmod(rows, "o.date", _ORDER_DATE_SPAN)
        out["o_orderdate"] = od.astype(np.int32)
        if "o_orderstatus" in cols or "o_totalprice" in cols:
            status, total = _order_rollup(rows, od, sf)
            smap = {"F": 0, "O": 1, "P": 2}
            out["o_orderstatus"] = (
                np.asarray([smap[str(s)] for s in status]), ["F", "O", "P"])
            out["o_totalprice"] = total
        if "o_orderpriority" in cols:
            out["o_orderpriority"] = (hmod(rows, "o.prio", 5), PRIORITIES)
        if "o_clerk" in cols:
            nclerk = max(1, int(1000 * sf))
            ck = 1 + hmod(rows, "o.clerk", nclerk)
            out["o_clerk"] = [f"Clerk#{v:09d}" for v in ck]
        if "o_shippriority" in cols:
            out["o_shippriority"] = np.zeros(len(rows), dtype=np.int64)
        if "o_comment" in cols:
            comments = _comment(rows, "o.comment", 10)
            # q13 relies on '%special%requests%' appearing in ~1% of comments
            flag = h64(rows, "o.spreq") % np.uint64(100)
            for i in np.nonzero(flag == 0)[0]:
                comments[i] = comments[i] + " special requests"
            out["o_comment"] = comments
        return out

    def _gen_lineitem(self, sf, rows, cols):
        # `rows` here are ORDER indices; lines expand within
        order_idx = rows
        nlines = _lines_per_order(order_idx)
        o = np.repeat(order_idx, nlines)
        ln = _ranges(nlines)  # 0-based line number within order
        g = o * np.int64(8) + ln  # global line tag (order, line)
        out = {}
        out["l_orderkey"] = o + 1
        pcount = _counts(sf)["part"]
        scount = _counts(sf)["supplier"]
        p = 1 + hmod(g, "l.part", pcount)
        out["l_partkey"] = p
        out["l_suppkey"] = _supp_for_part(p, hmod(g, "l.supp", 4), scount)
        out["l_linenumber"] = ln + 1
        qty = 1 + hmod(g, "l.qty", 50)
        out["l_quantity"] = qty * 100
        out["l_extendedprice"] = qty * _retail_price(p)
        out["l_discount"] = hmod(g, "l.disc", 11)
        out["l_tax"] = hmod(g, "l.tax", 9)
        od = _START + hmod(o, "o.date", _ORDER_DATE_SPAN)
        ship = od + 1 + hmod(g, "l.ship", 121)
        commit = od + 30 + hmod(g, "l.commit", 61)
        receipt = ship + 1 + hmod(g, "l.rcpt", 30)
        out["l_shipdate"] = ship.astype(np.int32)
        out["l_commitdate"] = commit.astype(np.int32)
        out["l_receiptdate"] = receipt.astype(np.int32)
        if "l_returnflag" in cols:
            r = hmod(g, "l.rflag", 2)
            codes = np.where(receipt <= _CURRENT, np.where(r == 0, 0, 1), 2)
            out["l_returnflag"] = (codes, ["R", "A", "N"])
        if "l_linestatus" in cols:
            out["l_linestatus"] = (np.where(ship > _CURRENT, 0, 1),
                                   ["O", "F"])
        if "l_shipinstruct" in cols:
            out["l_shipinstruct"] = (hmod(g, "l.instr", 4), SHIP_INSTRUCT)
        if "l_shipmode" in cols:
            out["l_shipmode"] = (hmod(g, "l.mode", 7), SHIP_MODES)
        if "l_comment" in cols:
            out["l_comment"] = _comment(g, "l.comment", 6)
        return out


def _retail_price(partkey: np.ndarray) -> np.ndarray:
    """decimal(12,2) raw cents (spec 4.2.3: 90000+((pk/10)%20001)+100*(pk%1000))."""
    return (90_000 + ((partkey // 10) % 20_001) + 100 * (partkey % 1_000))


def _supp_for_part(partkey: np.ndarray, i: np.ndarray, scount: int) -> np.ndarray:
    """Spec 4.2.3 partsupp formula: the 4 suppliers of a part; lineitem uses
    the same so l_partkey/l_suppkey pairs exist in partsupp."""
    s = np.int64(scount)
    return ((partkey + i * (s // 4 + (partkey - 1) // s)) % s) + 1


def _lines_per_order(order_idx: np.ndarray) -> np.ndarray:
    return 1 + hmod(np.asarray(order_idx, dtype=np.int64), "o.nlines", 7)


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[0,1,..c0-1, 0,1,..c1-1, ...] for counts c."""
    total = int(counts.sum())
    idx = np.arange(total, dtype=np.int64)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return idx - starts


def _order_rollup(order_idx: np.ndarray, od: np.ndarray, sf: float):
    """Per-order status + total price, derived from its lineitems by
    recomputing each line's counter-based values with the same tags as
    ``_gen_lineitem`` (spec: status F if all lines F, O if all O, else P;
    total = sum of extprice*(1+tax)*(1-disc))."""
    pcount = _counts(sf)["part"]
    n = len(order_idx)
    nlines = _lines_per_order(order_idx)
    all_f = np.ones(n, dtype=bool)
    all_o = np.ones(n, dtype=bool)
    total = np.zeros(n, dtype=np.int64)
    for line in range(7):
        has = nlines > line
        g = order_idx * np.int64(8) + line
        ship = od + 1 + hmod(g, "l.ship", 121)
        is_o = ship > _CURRENT
        all_f &= ~has | ~is_o
        all_o &= ~has | is_o
        qty = 1 + hmod(g, "l.qty", 50)
        p = 1 + hmod(g, "l.part", pcount)
        ext = qty * _retail_price(p)          # cents
        disc = hmod(g, "l.disc", 11)          # hundredths
        tax = hmod(g, "l.tax", 9)
        # ext*(1+tax)*(1-disc) at scale 2: divide the scale-6 product
        prod = ext * (100 + tax) * (100 - disc)
        line_total = (prod + 5_000) // 10_000  # round half up (positive)
        total += np.where(has, line_total, 0)
    status = np.where(all_f, "F", np.where(all_o, "O", "P"))
    return status, total


class TpchPageSource(ConnectorPageSource):
    def __init__(self, table: _Table, sf: float, split: ConnectorSplit,
                 columns: Sequence[ColumnHandle], page_rows: int):
        self.table = table
        self.sf = sf
        self.columns = [c.name for c in columns]
        self.pos = split.row_start
        self.end = split.row_end
        self.page_rows = page_rows
        # pushed-down constraint: also generate the constrained columns
        # (they may have been pruned from the projection), mask, then
        # project back down
        from .spi import constrained_gen_columns

        self.constraint = split.table.constraint
        self.gen_columns = constrained_gen_columns(self.columns,
                                                   self.constraint)

    def get_next_page(self) -> Optional[Page]:
        if self.pos >= self.end:
            return None
        end = min(self.pos + self.page_rows, self.end)
        page = self.table.generate(self.sf, self.pos, end,
                                   self.gen_columns)
        self.pos = end
        if self.constraint is not None:
            from .spi import enforce_constraint_page

            page = enforce_constraint_page(
                page, self.gen_columns, self.constraint,
                project=range(len(self.columns)))
        return page

    def is_finished(self) -> bool:
        return self.pos >= self.end


class TpchMetadata(ConnectorMetadata):
    def __init__(self, conn: "TpchConnector"):
        self.conn = conn

    def list_schemas(self) -> List[str]:
        return list(_SCHEMAS)

    def list_tables(self, schema: str) -> List[str]:
        return list(_TABLE_COLUMNS)

    def get_table_handle(self, schema, table) -> Optional[TableHandle]:
        if schema in _SCHEMAS and table in _TABLE_COLUMNS:
            return TableHandle(self.conn.catalog_name, schema, table)
        return None

    def get_columns(self, table: TableHandle) -> List[ColumnHandle]:
        return [ColumnHandle(n, t, i) for i, (n, t)
                in enumerate(_TABLE_COLUMNS[table.table])]

    def apply_filter(self, table: TableHandle, constraint):
        """Accept any domain over real columns for FULL row-level
        enforcement at page generation (reference:
        plugin/trino-tpch/.../TpchMetadata.java applyFilter; there only
        orderstatus/type/container prune, here the generator masks any
        column)."""
        from .spi import negotiate_constraint

        return negotiate_constraint(
            table, constraint,
            (n for n, _ in _TABLE_COLUMNS[table.table]))

    def get_statistics(self, table: TableHandle) -> TableStatistics:
        """Row counts plus the per-column ndv / min-max the cost model
        feeds on (reference: TpchMetadata.getTableStatistics serving
        cost/ScanStatsRule). Values follow the generator's formulas."""
        sf = _SCHEMAS[table.schema]
        c = _counts(sf)
        t = self.conn.table(table.table)
        rows = t.row_count(sf)
        cols: Dict[str, ColumnStatistics] = {}

        def put(name, ndv=None, lo=None, hi=None):
            cols[name] = ColumnStatistics(distinct_count=ndv,
                                          min_value=lo, max_value=hi)

        tb = table.table
        if tb == "lineitem":
            put("l_orderkey", c["orders"], 1, c["orders"])
            put("l_partkey", c["part"], 1, c["part"])
            put("l_suppkey", c["supplier"], 1, c["supplier"])
            put("l_linenumber", 7, 1, 7)
            # decimal columns: raw scaled units (cents for scale 2 —
            # IR literals carry raw values)
            put("l_quantity", 50, 100, 5000)
            put("l_discount", 11, 0, 10)
            put("l_tax", 9, 0, 8)
            put("l_returnflag", 3)
            put("l_linestatus", 2)
            put("l_shipdate", 2526, _START + 1, _END)
            put("l_commitdate", 2466, _START + 30, _END)
            put("l_receiptdate", 2554, _START + 2, _END + 30)
            put("l_shipmode", 7)
            put("l_shipinstruct", 4)
        elif tb == "orders":
            put("o_orderkey", c["orders"], 1, c["orders"])
            put("o_custkey", c["customer"] * 2 // 3, 1, c["customer"])
            put("o_orderstatus", 3)
            put("o_orderdate", _ORDER_DATE_SPAN, _START,
                _START + _ORDER_DATE_SPAN)
            put("o_orderpriority", 5)
            put("o_shippriority", 1, 0, 0)
        elif tb == "customer":
            put("c_custkey", c["customer"], 1, c["customer"])
            put("c_nationkey", 25, 0, 24)
            put("c_mktsegment", 5)
            put("c_acctbal", rows * 0.9, -99_999, 999_999)
        elif tb == "supplier":
            put("s_suppkey", c["supplier"], 1, c["supplier"])
            put("s_nationkey", 25, 0, 24)
            put("s_acctbal", rows * 0.9, -99_999, 999_999)
        elif tb == "part":
            put("p_partkey", c["part"], 1, c["part"])
            put("p_size", 50, 1, 50)
            put("p_brand", 25)
            put("p_type", 150)
            put("p_container", 40)
        elif tb == "partsupp":
            put("ps_partkey", c["part"], 1, c["part"])
            put("ps_suppkey", c["supplier"], 1, c["supplier"])
            put("ps_availqty", 9999, 1, 9999)
        elif tb == "nation":
            put("n_nationkey", 25, 0, 24)
            put("n_regionkey", 5, 0, 4)
            put("n_name", 25)
        elif tb == "region":
            put("r_regionkey", 5, 0, 4)
            put("r_name", 5)
        return TableStatistics(row_count=float(rows), columns=cols)


class TpchSplitManager(ConnectorSplitManager):
    def __init__(self, conn: "TpchConnector"):
        self.conn = conn

    def get_splits(self, table: TableHandle,
                   desired_splits: int) -> List[ConnectorSplit]:
        sf = _SCHEMAS[table.schema]
        t = self.conn.table(table.table)
        # lineitem splits range over ORDERS (lines expand inside the split)
        n = _counts(sf)["orders"] if table.table == "lineitem" \
            else t.row_count(sf)
        k = max(1, min(desired_splits, (n + 1023) // 1024))
        bounds = np.linspace(0, n, k + 1).astype(int)
        return [ConnectorSplit(table, i, k, int(bounds[i]), int(bounds[i + 1]))
                for i in range(k) if bounds[i] < bounds[i + 1]]


class TpchConnector(Connector):
    name = "tpch"

    def data_version(self) -> int:
        return 0    # deterministic generator: data never changes

    def __init__(self, catalog_name: str = "tpch", page_rows: int = 65536):
        self.catalog_name = catalog_name
        self.page_rows = page_rows
        self._tables: Dict[str, _Table] = {}

    def table(self, name: str) -> _Table:
        t = self._tables.get(name)
        if t is None:
            t = _Table(self, name)
            self._tables[name] = t
        return t

    def metadata(self) -> ConnectorMetadata:
        return TpchMetadata(self)

    def split_manager(self) -> ConnectorSplitManager:
        return TpchSplitManager(self)

    def page_source(self, split: ConnectorSplit,
                    columns: Sequence[ColumnHandle]) -> ConnectorPageSource:
        sf = _SCHEMAS[split.table.schema]
        return TpchPageSource(self.table(split.table.table), sf, split,
                              columns, self.page_rows)
