"""TPC-H q3 (shipping priority), plain NumPy."""

import numpy as np

from ._common import code_of, days, dec, iso, totals_by, values

LIMIT = 10
#: output columns of the ORDER BY: revenue desc, o_orderdate
ORDER_KEY = (1, 2)


def answer(t, p, acc="exact"):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    day = days(p["DATE"])
    seg_codes, seg_pool = c["c_mktsegment"]
    cust_ok = np.zeros(int(c["c_custkey"].max()) + 1, dtype=bool)
    cust_ok[c["c_custkey"][seg_codes == code_of(seg_pool, p["SEGMENT"])]] \
        = True
    okey = o["o_orderkey"]
    order_ok = np.zeros(int(okey.max()) + 1, dtype=bool)
    order_ok[okey[cust_ok[o["o_custkey"]] & (o["o_orderdate"] < day)]] = True
    m = (li["l_shipdate"] > day) & order_ok[li["l_orderkey"]]
    keys = li["l_orderkey"][m]
    rev = values(li["l_extendedprice"][m], acc) * \
        values(100 - li["l_discount"][m], acc)
    revenue = totals_by(keys, rev, len(order_ok), acc)
    hit = np.unique(keys)
    at = np.zeros(len(order_ok), dtype=np.int64)
    at[okey] = np.arange(len(okey))
    rows = [(int(k), dec(revenue[k], 4), iso(o["o_orderdate"][at[k]]),
             int(o["o_shippriority"][at[k]])) for k in hit]
    rows.sort(key=lambda r: (-r[1], r[2]))
    return rows
