"""TPC-H q1 (pricing summary report), plain NumPy.

Sums per (returnflag, linestatus, shipdate) are made once per set of
tables; a draw of DELTA adds those of the dates it keeps."""

import numpy as np

from ._common import avg_half_up, days, dec, memo, sums_by_runs, values

LIMIT = None
#: output columns of the ORDER BY
ORDER_KEY = (0, 1)


def _runs(t, acc):
    li = t["lineitem"]
    rf, rf_pool = li["l_returnflag"]
    ls, ls_pool = li["l_linestatus"]
    ext = values(li["l_extendedprice"], acc)
    disc_price = ext * values(100 - li["l_discount"], acc)
    charge = disc_price * values(100 + li["l_tax"], acc)
    keys, sums = sums_by_runs(
        (li["l_shipdate"], ls, rf),
        (li["l_quantity"], li["l_extendedprice"], disc_price, charge,
         li["l_discount"], np.ones(len(rf), dtype=np.int64)), acc)
    return keys, sums, rf_pool, ls_pool


def _int(x, acc):
    return int(x) if acc == "exact" else int(np.rint(x))


def answer(t, p, acc="exact"):
    (ship, ls, rf), sums, rf_pool, ls_pool = memo(t, ("q1", acc),
                                                  lambda: _runs(t, acc))
    keep = ship <= days("1998-12-01") - int(p["DELTA"])
    rows = []
    for a, b in sorted({(int(x), int(y)) for x, y in
                        zip(rf[keep], ls[keep])},
                       key=lambda g: (rf_pool[g[0]], ls_pool[g[1]])):
        m = keep & (rf == a) & (ls == b)
        qty, ext, disc_price, charge, disc, n = (
            _int(s[m].sum(), acc) for s in sums)
        rows.append((
            rf_pool[a], ls_pool[b], dec(qty, 2), dec(ext, 2),
            dec(disc_price, 4), dec(charge, 6),
            dec(avg_half_up(qty, n), 2), dec(avg_half_up(ext, n), 2),
            dec(avg_half_up(disc, n), 2), n))
    return rows
