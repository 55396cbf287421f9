"""Query templates, their qgen draws, and the statements each stream of
a traffic mix sends.

A template is ``queries/<q>.sql`` with ``{NAME}`` placeholders and
``queries/<q>.json``, which gives each placeholder's qgen range (TPC-H
v3.0.1 clause 2.4; a ``list`` kind draws ``k`` distinct values, as
dsqgen's ``ulist`` does for TPC-DS, and renders them as literals for
``IN ({NAME})``; the reference receives them as a list). A traffic mix
is ``traffic/<name>.json``: the streams, their templates, the client's
poll interval, the warm-up and the traced part of the window. Everything
is drawn from the seed: the same seed gives the same statements in the
same order.
"""

from __future__ import annotations

import datetime
import json
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Template:
    name: str
    sql: str
    params: Dict[str, dict]

    def draw(self, rng: np.random.Generator) -> Dict[str, object]:
        """One qgen draw of every parameter."""
        out = {}
        for name, spec in self.params.items():
            kind = spec["kind"]
            if kind == "int":
                out[name] = int(rng.integers(spec["lo"], spec["hi"] + 1))
            elif kind == "choice":
                out[name] = spec["values"][int(rng.integers(
                    len(spec["values"])))]
            elif kind == "date":
                lo = datetime.date.fromisoformat(spec["lo"])
                hi = datetime.date.fromisoformat(spec["hi"])
                out[name] = (lo + datetime.timedelta(days=int(
                    rng.integers((hi - lo).days + 1)))).isoformat()
            elif kind == "decimal":
                step = 10 ** spec["scale"]
                lo = round(float(spec["lo"]) * step)
                hi = round(float(spec["hi"]) * step)
                v = int(rng.integers(lo, hi + 1))
                out[name] = f"{v // step}.{v % step:0{spec['scale']}d}"
            elif kind == "list":
                picks = rng.choice(len(spec["values"]), size=spec["k"],
                                   replace=False)
                out[name] = [spec["values"][int(i)] for i in picks]
            else:
                raise ValueError(f"template {self.name}: parameter "
                                 f"{name} has unknown kind {kind!r}")
        return out

    def render(self, params: Dict[str, object]) -> str:
        return self.sql.format(**{
            k: ", ".join(_literal(x) for x in v) if isinstance(v, list)
            else v for k, v in params.items()})


def _literal(value) -> str:
    """A value of a ``list`` draw as a SQL literal."""
    if isinstance(value, str):
        return "'" + value.replace("'", "''") + "'"
    return str(value)


def load_template(name: str, root: str = HERE) -> Template:
    with open(os.path.join(root, "queries", f"{name}.sql")) as f:
        sql = f.read()
    spec = read_json(os.path.join(root, "queries", f"{name}.json"))
    return Template(name, sql, spec["params"])


def load_traffic(name: str, root: str = HERE) -> dict:
    return read_json(os.path.join(root, "traffic", f"{name}.json"))


def plan(traffic: dict, seed: int, root: str = HERE,
         window_statements: int = 4096) -> dict:
    """The statements of a run: for each stream its warm-up, one list
    per template of ``warmup_max_per_template`` draws (the streams send
    at least ``warmup_per_template`` of each, and more until the
    template's plan stops changing), and the first
    ``window_statements`` of its window, which it sends in order for as
    long as the window lasts. The templates' order is permuted by the
    seed and rotated by one per stream, so the streams start on
    different templates; every parameter is a fresh qgen draw."""
    names = list(traffic["templates"])
    templates = {n: load_template(n, root) for n in names}
    base = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 0])
    order = [names[i] for i in base.permutation(len(names))]
    streams = []
    for s in range(int(traffic["streams"])):
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 1 + s])
        cycle = order[s % len(order):] + order[:s % len(order)]

        def make(seq, name):
            params = templates[name].draw(rng)
            return {"stream": s, "seq": seq, "template": name,
                    "params": params, "sql": templates[name].render(params)}

        least = int(traffic["warmup_per_template"])
        most = int(traffic.get("warmup_max_per_template", least))
        warm = [[make(-1 - j * most - i, n) for i in range(most)]
                for j, n in enumerate(cycle)]
        window = [make(i, cycle[i % len(cycle)])
                  for i in range(window_statements)]
        streams.append({"user": traffic["user"].format(stream=s),
                        "warmup": warm, "window": window})
    return {"poll_s": float(traffic["poll_ms"]) / 1e3,
            "warmup_least": least, "streams": streams}
