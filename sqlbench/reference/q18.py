"""TPC-H q18 (large volume customer), plain NumPy.

The quantity of every order is summed once per set of tables."""

import numpy as np

from ._common import dec, iso, memo, totals_by

LIMIT = 100
#: output columns of the ORDER BY: o_totalprice desc, o_orderdate
ORDER_KEY = (4, 3)


def answer(t, p, acc="exact"):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    okey = o["o_orderkey"]
    size = int(okey.max()) + 1
    qty = memo(t, ("q18", acc), lambda: totals_by(
        li["l_orderkey"], li["l_quantity"], size, acc))
    big = np.nonzero(qty > int(p["QUANTITY"]) * 100)[0]
    at = np.zeros(size, dtype=np.int64)
    at[okey] = np.arange(len(okey))
    cat = np.zeros(int(c["c_custkey"].max()) + 1, dtype=np.int64)
    cat[c["c_custkey"]] = np.arange(len(c["c_custkey"]))
    names, pool = c["c_name"]
    rows = []
    for k in big:
        i = at[k]
        cust = int(o["o_custkey"][i])
        rows.append((pool[names[cat[cust]]], cust, int(k),
                     iso(o["o_orderdate"][i]),
                     dec(o["o_totalprice"][i], 2), dec(qty[k], 2)))
    rows.sort(key=lambda r: (-r[4], r[3]))
    return rows
