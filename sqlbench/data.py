"""The tables of a configuration: generated once from the seed, loaded
into the engine's memory connector, and handed as the same arrays to the
plain reference.

A configuration file (``configs/<name>.json``) names its schema
(``"schema"``, default ``"tpch"``) and, for each table of it, the
columns it holds and their SQL types; a table with no columns is not
generated. The schema's generator is the module ``<schema>gen`` of this
package: ``TABLES`` (the load order), ``source_rows(table, sf)``,
``generate(table, sf, columns, seed)`` (an ndarray per column, a
``numpy.ma.MaskedArray`` where it has nulls, ``(codes, pool)`` for a
string column) and ``page_bounds(table, sf, seed, desired_splits,
page_rows)``: the pages a scan of the port's connector of that schema
would write into a memory table.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class Table:
    name: str
    #: (column, SQL type) in the table's order
    columns: List[Tuple[str, str]]
    #: column -> ndarray (masked where it has nulls), or (codes, pool)
    #: for a string column
    arrays: Dict[str, object]
    #: (first row, end row) of each page
    pages: List[Tuple[int, int]]


@dataclass
class Database:
    sf: float
    seed: int
    tables: Dict[str, Table] = field(default_factory=dict)


def generator(config: dict):
    """The generator module of the configuration's schema."""
    return importlib.import_module(
        f".{config.get('schema', 'tpch')}gen", __package__)


def generate(config: dict, seed: int, sf: float = None) -> Database:
    """Every column the configuration lists, from ``seed``; ``sf``
    overrides the configuration's scale (tests run at a small one)."""
    sf = float(config["scale_factor"]) if sf is None else sf
    gen = generator(config)
    db = Database(sf=sf, seed=seed)
    for name in gen.TABLES:
        columns = list(config.get(name, {}).items())
        if not columns:
            continue
        arrays = gen.generate(name, sf, [c for c, _ in columns], seed)
        bounds = gen.page_bounds(name, sf, seed,
                                 int(config["desired_splits"]),
                                 int(config["page_rows"]))
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
                    nulls = np.ma.getmask(v)
                    blocks.append(Block(
                        t, np.asarray(v[lo:hi], dtype=t.storage),
                        None if nulls is np.ma.nomask else nulls[lo:hi]))
            sink.append_page(Page(blocks, hi - lo))
        sink.finish()
