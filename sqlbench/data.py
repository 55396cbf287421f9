"""The tables of a configuration: generated once from the seed, loaded
into the engine's memory connector, and handed as the same arrays to the
plain reference.

A configuration file (``configs/<name>.json``) names, for each TPC-H
table, the columns it holds and their SQL types; a table with no columns
is not generated. Pages follow what a scan of the port's TPC-H connector
would write into a memory table: ``desired_splits`` splits over the
table's source rows (orders, for lineitem), each read ``page_rows``
source rows at a time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from . import tpchgen

TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp",
          "orders", "lineitem")


@dataclass
class Table:
    name: str
    #: (column, SQL type) in the table's order
    columns: List[Tuple[str, str]]
    #: column -> ndarray, or (codes, pool) for a string column
    arrays: Dict[str, object]
    #: (first row, end row) of each page
    pages: List[Tuple[int, int]]


@dataclass
class Database:
    sf: float
    seed: int
    tables: Dict[str, Table] = field(default_factory=dict)


def generate(config: dict, seed: int, sf: float = None) -> Database:
    """Every column the configuration lists, from ``seed``; ``sf``
    overrides the configuration's scale (tests run at a small one)."""
    sf = float(config["scale_factor"]) if sf is None else sf
    db = Database(sf=sf, seed=seed)
    for name in TABLES:
        columns = list(config.get(name, {}).items())
        if not columns:
            continue
        arrays = tpchgen.generate(name, sf, [c for c, _ in columns], seed)
        bounds = tpchgen.split_pages(tpchgen.source_rows(name, sf),
                                     int(config["desired_splits"]),
                                     int(config["page_rows"]))
        if name == "lineitem":
            ends = np.concatenate(
                [[0], np.cumsum(tpchgen.line_counts(sf, seed))])
            bounds = [(int(ends[a]), int(ends[b])) for a, b in bounds]
        db.tables[name] = Table(name, columns, arrays, bounds)
    return db


def load_memory(db: Database, connector) -> None:
    """Create each table in the memory connector's ``default`` schema and
    append its pages (host pages, as the connector keeps them).

    A new table's string pools are empty, and the sink re-encodes every
    page whose pool is not the table's own. So each string column's pool
    becomes the table's before the first page: its generated values are
    distinct, and its codes already index them."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.block import Block, Dictionary, Page
    from trino_tpu_torch.connectors.spi import ColumnHandle

    meta = connector.metadata()
    for table in db.tables.values():
        types = [T.parse_type(t) for _, t in table.columns]
        handles = [ColumnHandle(c, t, i) for i, ((c, _), t)
                   in enumerate(zip(table.columns, types))]
        handle = meta.create_table("default", table.name, handles)
        sink = connector.page_sink(handle, handles)
        stored = connector.tables[("default", table.name)]
        pools = {}
        for i, (c, t) in enumerate(zip(table.columns, types)):
            if t.is_string:
                pools[c[0]] = stored.dicts[i] = Dictionary(
                    table.arrays[c[0]][1])
        for lo, hi in table.pages:
            blocks = []
            for (c, _), t in zip(table.columns, types):
                v = table.arrays[c]
                if t.is_string:
                    blocks.append(Block(t, v[0][lo:hi], None, pools[c]))
                else:
                    blocks.append(Block(t, np.asarray(v[lo:hi],
                                                      dtype=t.storage)))
            sink.append_page(Page(blocks, hi - lo))
        sink.finish()
