"""TPC-H q6 (forecasting revenue change), plain NumPy."""

import datetime

from ._common import days, dec, total, values

LIMIT = None
ORDER_KEY = ()


def answer(t, p, acc="exact"):
    li = t["lineitem"]
    lo = datetime.date.fromisoformat(p["DATE"])
    hi = lo.replace(year=lo.year + 1)
    d = round(float(p["DISCOUNT"]) * 100)
    m = (li["l_shipdate"] >= days(lo.isoformat())) & \
        (li["l_shipdate"] < days(hi.isoformat())) & \
        (li["l_discount"] >= d - 1) & (li["l_discount"] <= d + 1) & \
        (li["l_quantity"] < int(p["QUANTITY"]) * 100)
    if not m.any():
        return [(None,)]
    rev = values(li["l_extendedprice"][m], acc) * \
        values(li["l_discount"][m], acc)
    return [(dec(total(rev, acc), 4),)]
