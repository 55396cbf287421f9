"""Connector SPI — the pluggable storage boundary.

Reference analog: ``core/trino-spi/src/main/java/io/trino/spi/connector/``
(~100 interfaces: ConnectorMetadata, ConnectorSplitManager,
ConnectorPageSource/Sink, ConnectorTableHandle, ...). Compressed to the
load-bearing surface: metadata CRUD, split enumeration, page sources with
column pruning + predicate pushdown hooks, page sinks for writes.

TPU-first notes: page sources yield host ``Page``s (numpy + dictionaries);
the scan operator moves them on device. Splits carry a deterministic
row-range so distributed scans are reproducible regardless of split count.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

from .. import types as T
from ..block import Page
from ..predicate import TupleDomain


@dataclass(frozen=True)
class ColumnHandle:
    name: str
    type: T.Type
    ordinal: int


@dataclass(frozen=True)
class TableHandle:
    catalog: str
    schema: str
    table: str
    #: the TupleDomain (over column NAMES) the connector agreed to
    #: enforce (apply_filter attaches it; page sources mask rows under
    #: it) — the typed analog of the reference's opaque
    #: ConnectorTableHandle carrying its enforced constraint
    constraint: Optional[TupleDomain] = None

    @property
    def qualified_name(self) -> str:
        return f"{self.catalog}.{self.schema}.{self.table}"


def negotiate_constraint(table: "TableHandle", constraint: TupleDomain,
                         names, enforceable=None
                         ) -> Optional[Tuple["TableHandle", TupleDomain]]:
    """The standard apply_filter body shared by the generator/memory
    connectors: accept the offered domains naming real columns the
    connector can enforce, intersect with any constraint already on the
    handle, and return the RESIDUAL TupleDomain the engine must keep
    filtering (reference: ConstraintApplicationResult.java with
    remainingFilter). ``enforceable`` limits acceptance to a column
    subset (None = every real column — full enforcement). Returns None
    when nothing new would be enforced (stops planner loops)."""
    from dataclasses import replace as _dc_replace

    if constraint.is_none or constraint.is_all:
        return None
    names = set(names)
    if enforceable is not None:
        names &= set(enforceable)
    offered = constraint.as_dict()
    accepted = {k: d for k, d in offered.items() if k in names}
    if not accepted:
        return None
    residual = TupleDomain.of({k: d for k, d in offered.items()
                               if k not in names})
    offer = TupleDomain.of(accepted)
    combined = table.constraint.intersect(offer) \
        if table.constraint is not None else offer
    if combined == table.constraint:
        return None
    return _dc_replace(table, constraint=combined), residual


def constrained_gen_columns(columns: Sequence[str],
                            constraint) -> List[str]:
    """Projected columns plus any constrained-but-pruned columns a
    generator must also produce so the row mask can be evaluated."""
    if constraint is None or constraint.is_all:
        return list(columns)
    have = set(columns)
    return list(columns) + [n for n, _ in (constraint.columns or ())
                            if n not in have]


def enforce_constraint_page(page: Page, names: Sequence[str], constraint,
                            project: Optional[Sequence[int]] = None
                            ) -> Page:
    """Shared row-level constraint enforcement for connectors: mask rows
    under a TupleDomain keyed by column NAME (evaluated positionally
    against ``names``), then optionally project to a channel subset.
    This is what an apply_filter acceptance promises the engine."""
    from ..block import Block
    from ..predicate import domain_mask

    if constraint is None or constraint.is_none:
        doms = {}
        empty = constraint is not None
    else:
        doms = constraint.as_dict()
        empty = False
    mask = None
    if empty:
        import numpy as np

        mask = np.zeros(page.num_rows, dtype=bool)
    else:
        for i, n in enumerate(names):
            d = doms.get(n)
            if d is None or d.is_all:
                continue
            b = page.block(i).numpy()
            m = domain_mask(b.data, b.nulls, b.dictionary, d)
            mask = m if mask is None else (mask & m)
    blocks = page.blocks if project is None \
        else [page.blocks[i] for i in project]
    if mask is None or mask.all():
        return page if project is None else Page(list(blocks),
                                                 page.num_rows)
    out = []
    for b in blocks:
        b = b.numpy()
        out.append(Block(b.type, b.data[mask],
                         b.nulls[mask] if b.nulls is not None else None,
                         b.dictionary))
    return Page(out, int(mask.sum()))


@dataclass(frozen=True)
class ConnectorSplit:
    """A unit of scan parallelism (reference: spi/connector/ConnectorSplit).
    ``row_start``/``row_end`` give deterministic slicing for generators;
    file-backed connectors may carry opaque ``info`` instead."""

    table: TableHandle
    split_id: int
    total_splits: int
    row_start: int = 0
    row_end: int = 0
    info: Optional[dict] = None


class ConnectorPageSource:
    """Pull-based page iterator for one split (reference:
    spi/connector/ConnectorPageSource.java)."""

    def get_next_page(self) -> Optional[Page]:
        raise NotImplementedError

    def is_finished(self) -> bool:
        raise NotImplementedError

    def close(self):
        pass


@dataclass
class TableStatistics:
    row_count: Optional[float] = None
    # per-column: distinct count, min, max, null fraction
    columns: dict = field(default_factory=dict)


@dataclass
class ColumnStatistics:
    distinct_count: Optional[float] = None
    null_fraction: float = 0.0
    min_value: Optional[object] = None
    max_value: Optional[object] = None


class ConnectorMetadata:
    """Schema browsing + table resolution (reference:
    spi/connector/ConnectorMetadata.java)."""

    def list_schemas(self) -> List[str]:
        raise NotImplementedError

    def list_tables(self, schema: str) -> List[str]:
        raise NotImplementedError

    def get_table_handle(self, schema: str, table: str) -> Optional[TableHandle]:
        raise NotImplementedError

    def get_columns(self, table: TableHandle) -> List[ColumnHandle]:
        raise NotImplementedError

    def get_statistics(self, table: TableHandle) -> TableStatistics:
        return TableStatistics()

    def apply_filter(self, table: TableHandle, constraint
                     ) -> Optional[Tuple[TableHandle, object]]:
        """Pushdown negotiation (reference:
        spi/connector/ConnectorMetadata.java applyFilter): offered a
        TupleDomain over column NAMES, return (new_handle,
        remaining_domain) — the handle carrying what the connector will
        enforce, and the part it cannot (TupleDomain.all_() when fully
        enforced) — or None to decline entirely."""
        return None

    # -- DDL (reference: ConnectorMetadata createTable/dropTable) ------

    def create_table(self, schema: str, table: str,
                     columns: List[ColumnHandle]) -> TableHandle:
        raise T.TrinoError("connector does not support CREATE TABLE",
                           "NOT_SUPPORTED")

    def drop_table(self, table: TableHandle):
        raise T.TrinoError("connector does not support DROP TABLE",
                           "NOT_SUPPORTED")


class ConnectorSplitManager:
    """Split enumeration (reference: spi/connector/ConnectorSplitManager)."""

    def get_splits(self, table: TableHandle,
                   desired_splits: int) -> List[ConnectorSplit]:
        raise NotImplementedError


class ConnectorPageSink:
    """Write path (reference: spi/connector/ConnectorPageSink.java)."""

    def append_page(self, page: Page):
        raise NotImplementedError

    def finish(self) -> dict:
        return {}

    def abort(self):
        pass


class Connector:
    """One catalog's storage engine (reference: spi/connector/Connector.java).

    Subclasses provide metadata/splits/page-sources; ``page_sink`` is
    optional (read-only connectors raise)."""

    name = "base"

    def data_version(self) -> Optional[int]:
        """Monotonic snapshot version of this catalog's data+metadata,
        or None when the connector cannot promise stability (live
        catalogs like ``system``).  The plan/result caches key on it:
        any DDL or write MUST move the version, and a None makes every
        statement touching the catalog uncacheable (reference analog:
        the connector ``getTableHandle`` snapshot id materialized-view
        staleness checks key on)."""
        return None

    def metadata(self) -> ConnectorMetadata:
        raise NotImplementedError

    def split_manager(self) -> ConnectorSplitManager:
        raise NotImplementedError

    def page_source(self, split: ConnectorSplit,
                    columns: Sequence[ColumnHandle]) -> ConnectorPageSource:
        raise NotImplementedError

    def page_sink(self, table: TableHandle,
                  columns: Sequence[ColumnHandle]) -> ConnectorPageSink:
        raise T.TrinoError(f"connector {self.name} does not support writes",
                           "NOT_SUPPORTED")


class FixedPageSource(ConnectorPageSource):
    """Page source over a prebuilt page list (test fixture; reference:
    spi/connector/FixedPageSource.java)."""

    def __init__(self, pages: Sequence[Page]):
        self._pages: Iterator[Page] = iter(pages)
        self._done = False
        self._next: Optional[Page] = None

    def get_next_page(self) -> Optional[Page]:
        try:
            return next(self._pages)
        except StopIteration:
            self._done = True
            return None

    def is_finished(self) -> bool:
        return self._done
