"""Whether what the served statements returned is correct.

Every statement of the window is held against its template's plain
reference (``reference/<template>.py``), computed once per distinct
parameter draw from the same generated tables. The rows are the ones the
client received over the protocol, so every layer of the served path is
judged. The comparison is exact: a decimal as a number, a date and a
string as text, an integer as an integer. Under ORDER BY ... LIMIT the
served rows must carry the first rows' sort keys in order, each be a row
the statement selects, and be as many as the limit allows; rows tied on
every sort key may come in either order.

Each number compared has the limit 0: ``mismatched`` statements whose
rows differ, ``failed`` statements that returned an error, and
``unanswered`` statements that never returned (the client gave up).
"""

from __future__ import annotations

import importlib
import json
from collections import Counter
from decimal import Decimal
from typing import Dict, List

LIMITS = {"mismatched": 0, "failed": 0, "unanswered": 0}


def reference(template: str):
    return importlib.import_module(f"sqlbench.reference.{template}")


def tables_of(db) -> Dict[str, dict]:
    return {name: t.arrays for name, t in db.tables.items()}


def _norm(value, sql_type: str):
    if value is None:
        return None
    if sql_type.startswith("decimal"):
        return Decimal(str(value))
    if sql_type in ("bigint", "integer", "smallint", "tinyint"):
        return int(value)
    return value


def same_rows(got: List[list], columns: List[dict], want: List[tuple],
              limit, order_key) -> bool:
    """Whether ``got`` (as served) is a correct answer, ``want`` being
    every selected row in ORDER BY order."""
    types = [c["type"] for c in columns or ()]
    got = [tuple(_norm(v, t) for v, t in zip(row, types)) for row in got]
    want = [tuple(_norm(v, t) for v, t in zip(row, types)) for row in want]
    expect = len(want) if limit is None else min(limit, len(want))
    if len(got) != expect or any(len(r) != len(types) for r in got):
        return False
    if not order_key:
        return Counter(got) == Counter(want)

    def keys(rows):
        return [tuple(r[i] for i in order_key) for r in rows]

    if keys(got) != keys(want[:expect]):
        return False
    pool = Counter(want)
    return all(pool[r] >= n for r, n in Counter(got).items())


def check(records: List[dict], db) -> Dict[str, int]:
    """The numbers compared over ``records`` (the streams' window
    records), each to be held to its limit in ``LIMITS``."""
    tables = tables_of(db)
    answers = {}
    out = {"compared": 0, "mismatched": 0, "failed": 0, "unanswered": 0,
           "distinct_draws": 0}
    for rec in records:
        if "error" in rec:
            out["unanswered" if rec["error"] == "client timeout"
                else "failed"] += 1
            continue
        key = (rec["template"], json.dumps(rec["params"], sort_keys=True))
        if key not in answers:
            answers[key] = reference(rec["template"]).answer(
                tables, rec["params"])
        ref = reference(rec["template"])
        out["compared"] += 1
        if not same_rows(rec["rows"], rec["columns"], answers[key],
                         ref.LIMIT, ref.ORDER_KEY):
            out["mismatched"] += 1
    out["distinct_draws"] = len(answers)
    return out


def control(records: List[dict], db, acc: str) -> Dict[str, int]:
    """The control: the reference computed in ``acc`` put in the
    program's place, its rows held against the exact reference. Returns
    the same numbers as ``check``."""
    tables = tables_of(db)
    served, exact = {}, {}
    out = {"compared": 0, "mismatched": 0}
    for rec in records:
        key = (rec["template"], json.dumps(rec["params"], sort_keys=True))
        ref = reference(rec["template"])
        if key not in served:
            served[key] = ref.answer(tables, rec["params"], acc)
            exact[key] = ref.answer(tables, rec["params"], "exact")
        limit = ref.LIMIT
        rows = served[key] if limit is None else served[key][:limit]
        out["compared"] += 1
        if not same_rows([list(r) for r in rows], rec["columns"],
                         exact[key], limit, ref.ORDER_KEY):
            out["mismatched"] += 1
    return out
