"""Columnar Page/Block data model.

Reference analog: ``core/trino-spi/src/main/java/io/trino/spi/Page.java`` and
the 69 block classes under ``spi/block/`` (ByteArrayBlock, LongArrayBlock,
VariableWidthBlock, DictionaryBlock, RunLengthEncodedBlock, ...).

TPU-first redesign: a Block is ONE flat array per column (the type's device
storage dtype) plus an optional null mask — no per-width block subclasses;
the dtype carries that. Strings are dictionary codes (int32) with the string
pool held host-side (``Dictionary``), so every device kernel sees only
fixed-width lanes. Host arrays are numpy; a ``DevicePage`` holds torch
tensors on one device, padded to power-of-two bucket sizes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

from . import types as T

Array = Union[np.ndarray, "torch.Tensor"]  # noqa: F821


def padded_size(n: int, minimum: int = 16) -> int:
    """Pad row counts to power-of-two buckets => bounded jit cache size."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


def storage_dtype(t: T.Type) -> "torch.dtype":  # noqa: F821
    """The torch dtype of a SQL type's device storage (``t.storage``)."""
    import torch

    return torch.from_numpy(np.empty(0, dtype=t.storage)).dtype


def _rank_sort_key(v):
    """Total-order key over pool entries: None sorts first at every
    nesting level, so nullable composite pools rank without TypeError."""
    if v is None:
        return (0, 0)
    if isinstance(v, tuple):
        return (1, tuple(_rank_sort_key(x) for x in v))
    return (1, v)


def null_pool_value(t) -> object:
    """The type-homogeneous pool placeholder for NULL lanes."""
    return () if (t.is_array or t.is_map
                  or getattr(t, "is_row", False)) else ""


#: process-unique Dictionary ids for host-side caches.  ``id()`` is NOT
#: a safe cache key across pool lifetimes: once PageProcessors outlive
#:  a query (a shared-processor cache), a freed pool's
#: address can be reused by a new same-length pool and a stale LUT
#: would silently apply to the wrong values — ``uid`` never aliases.
_dict_uids = __import__("itertools").count(1)


class Dictionary:
    """Host-side string pool. Identity (``id()``) defines code compatibility:
    two blocks share code semantics iff they share the Dictionary object.

    Reference analog: ``spi/block/DictionaryBlock.java`` +
    ``VariableWidthBlock.java`` — but here the pool is a first-class engine
    object because device kernels only ever see codes.
    """

    __slots__ = ("values", "_index", "_sort_rank", "_lock", "uid")

    def __init__(self, values: Sequence[str] = ()):
        import threading

        self.values: list = list(values)
        self._index = {v: i for i, v in enumerate(self.values)}
        self._sort_rank = None
        self._lock = threading.Lock()
        self.uid = next(_dict_uids)

    @classmethod
    def aligned(cls, values: Sequence[str]) -> "Dictionary":
        """Pool whose position i maps to values[i] even when values repeat
        (derived pools from string transforms must stay code-aligned with
        their source). Lookup maps to the first occurrence."""
        import threading

        d = cls.__new__(cls)
        d.values = list(values)
        d._index = {}
        for i, v in enumerate(d.values):
            d._index.setdefault(v, i)
        d._sort_rank = None
        d._lock = threading.Lock()
        d.uid = next(_dict_uids)
        return d

    def __len__(self) -> int:
        return len(self.values)

    def code(self, value: str) -> int:
        """Code for value, adding it to the pool if absent. Thread-safe:
        concurrent scan tasks of a distributed query grow shared
        connector pools (check-then-append must not interleave)."""
        c = self._index.get(value)
        if c is not None:
            return c
        with self._lock:
            c = self._index.get(value)
            if c is None:
                c = len(self.values)
                self.values.append(value)
                self._index[value] = c
                self._sort_rank = None
        return c

    def lookup(self, value: str) -> int:
        """Code for value or -1 if absent (no mutation)."""
        return self._index.get(value, -1)

    def encode(self, strings: Sequence[Optional[str]],
               null_value="") -> np.ndarray:
        """Encode values to codes. NULL lanes get code 0 — they carry an
        arbitrary valid code and MUST be masked by the block's null mask
        (kernels fold the null bit into key comparisons explicitly).
        ``null_value`` is the pool placeholder kept type-homogeneous
        ("" for strings, () for arrays) so rank sorting never compares
        across types."""
        out = np.empty(len(strings), dtype=np.int32)
        for i, s in enumerate(strings):
            if s is None:
                if not self.values:
                    self.code(null_value)  # keep code 0 decodable
                out[i] = 0
            else:
                out[i] = self.code(s)
        return out

    def decode(self, codes: np.ndarray) -> list:
        vals = self.values
        return [vals[c] for c in codes]

    def sort_rank(self) -> np.ndarray:
        """rank[code] = DENSE lexicographic rank of values[code]: equal
        strings get equal rank (aligned pools may repeat values), so device
        comparisons/grouping over ranks match string equality. Lets ORDER
        BY / GROUP BY on strings run on device via rank[codes]."""
        if self._sort_rank is None or len(self._sort_rank) != len(self.values):
            vals = list(self.values)
            if any(v is None or isinstance(v, tuple) for v in vals):
                # composite/nullable pools: python comparisons between
                # None and values (or nested Nones inside tuples) have
                # no order — rank through a None-totalizing key
                order = sorted(range(len(vals)),
                               key=lambda i: _rank_sort_key(vals[i]))
                ranks = np.empty(len(vals), dtype=np.int32)
                r = -1
                prev = object()
                for i in order:
                    k = _rank_sort_key(vals[i])
                    if k != prev:
                        r += 1
                        prev = k
                    ranks[i] = r
                self._sort_rank = ranks
            else:
                # np.asarray on equal-length tuples builds a 2-D array;
                # assigning into an empty object array keeps entries
                # intact
                arr = np.empty(len(vals), dtype=object)
                arr[:] = vals
                _, inverse = np.unique(arr, return_inverse=True)
                self._sort_rank = inverse.astype(np.int32)
        return self._sort_rank


@dataclass
class Block:
    """One column of a Page: flat storage array + optional null mask."""

    type: T.Type
    data: Array                      # shape (n,), dtype == type.storage
    nulls: Optional[Array] = None    # bool, True => NULL; None => no nulls
    dictionary: Optional[Dictionary] = None

    def __post_init__(self):
        if self.type.is_pooled and self.dictionary is None:
            raise ValueError("string block requires a dictionary")

    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def may_have_nulls(self) -> bool:
        return self.nulls is not None

    # -- host/device movement ------------------------------------------------

    def numpy(self) -> "Block":
        if isinstance(self.data, np.ndarray) and (
            self.nulls is None or isinstance(self.nulls, np.ndarray)
        ):
            return self
        nulls = None if self.nulls is None else np.asarray(self.nulls)
        return Block(self.type, np.asarray(self.data), nulls, self.dictionary)

    def nulls_array(self) -> np.ndarray:
        if self.nulls is None:
            return np.zeros(len(self), dtype=bool)
        return np.asarray(self.nulls)

    # -- positional ops (reference: Block.getRegion / copyPositions) ---------

    def region(self, offset: int, length: int) -> "Block":
        nulls = None if self.nulls is None else self.nulls[offset:offset + length]
        return Block(self.type, self.data[offset:offset + length], nulls,
                     self.dictionary)

    def take(self, positions) -> "Block":
        nulls = None if self.nulls is None else self.nulls[positions]
        return Block(self.type, self.data[positions], nulls, self.dictionary)

    def filter(self, keep_mask) -> "Block":
        mask = np.asarray(keep_mask)
        return self.numpy().take(np.nonzero(mask)[0])

    # -- python-value conversion --------------------------------------------

    def to_pylist(self) -> list:
        b = self.numpy()
        data, t = b.data, b.type
        nulls = b.nulls_array() if b.nulls is not None else None
        if t.is_pooled:
            raw = b.dictionary.decode(data)
            if t.is_array:
                # user-visible arrays are lists (pool entries are tuples)
                raw = [None if v is None else list(v) for v in raw]
            elif t.is_map:
                # pool entries are sorted (key, value) pair tuples
                raw = [None if v is None else dict(v) for v in raw]
        elif t.is_decimal:
            raw = [t.from_raw(v) for v in data.tolist()]
        elif t.is_timestamp_tz:
            # zone-aware datetimes: the user-visible form carries the
            # column's rendering zone (device raw is the UTC instant)
            import datetime as _dt

            from .expr.tz import parse_fixed_offset_micros

            fixed = parse_fixed_offset_micros(t.zone)
            if fixed is None:
                from zoneinfo import ZoneInfo

                tzinfo = ZoneInfo(t.zone)
            else:
                tzinfo = _dt.timezone(_dt.timedelta(microseconds=fixed))
            epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
            raw = [(epoch + _dt.timedelta(microseconds=int(v)))
                   .astimezone(tzinfo) for v in data.tolist()]
        elif t == T.BOOLEAN:
            raw = [bool(v) for v in data]
        elif t in (T.DOUBLE, T.REAL):
            raw = [float(v) for v in data]
        else:
            raw = [int(v) for v in data.tolist()]
        if nulls is None:
            return raw
        return [None if n else v for v, n in zip(raw, nulls)]

    @staticmethod
    def from_pylist(type_: T.Type, values: Sequence,
                    dictionary: Optional[Dictionary] = None) -> "Block":
        n = len(values)
        nulls = np.fromiter((v is None for v in values), dtype=bool, count=n)
        has_nulls = bool(nulls.any())
        if type_.is_pooled:
            d = dictionary if dictionary is not None else Dictionary()
            if type_.is_map:
                values = [v if v is None else
                          tuple(sorted(v.items())
                                if isinstance(v, dict) else v)
                          for v in values]
            data = d.encode(values, null_value=null_pool_value(type_))
            return Block(type_, data, nulls if has_nulls else None, d)
        data = np.empty(n, dtype=type_.storage)
        if type_.is_timestamp_tz:
            import datetime as _dt

            epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
            one_us = _dt.timedelta(microseconds=1)
        for i, v in enumerate(values):
            if v is None:
                data[i] = 0
            elif type_.is_decimal:
                data[i] = type_.to_raw(v)
            elif type_.is_timestamp_tz and hasattr(v, "timestamp"):
                data[i] = (v - epoch) // one_us
            else:
                data[i] = v
        return Block(type_, data, nulls if has_nulls else None)


@dataclass
class Page:
    """A batch of rows: one Block per channel (reference: ``spi/Page.java:32``)."""

    blocks: list
    num_rows: int

    def __post_init__(self):
        for b in self.blocks:
            assert len(b) == self.num_rows, \
                f"block length {len(b)} != page rows {self.num_rows}"

    @property
    def channel_count(self) -> int:
        return len(self.blocks)

    def block(self, channel: int) -> Block:
        return self.blocks[channel]

    def region(self, offset: int, length: int) -> "Page":
        return Page([b.region(offset, length) for b in self.blocks], length)

    def take(self, positions) -> "Page":
        positions = np.asarray(positions)
        return Page([b.take(positions) for b in self.blocks], len(positions))

    def filter(self, keep_mask) -> "Page":
        positions = np.nonzero(np.asarray(keep_mask))[0]
        return self.take(positions)

    def select_channels(self, channels: Sequence[int]) -> "Page":
        return Page([self.blocks[c] for c in channels], self.num_rows)

    def to_pydict(self, names: Sequence[str]) -> dict:
        return {n: b.to_pylist() for n, b in zip(names, self.blocks)}

    def to_rows(self) -> list:
        cols = [b.to_pylist() for b in self.blocks]
        return [tuple(c[i] for c in cols) for i in range(self.num_rows)]

    @staticmethod
    def from_pylists(types_: Sequence[T.Type], columns: Sequence[Sequence],
                     dictionaries: Optional[Sequence] = None) -> "Page":
        assert len(types_) == len(columns)
        n = len(columns[0]) if columns else 0
        blocks = []
        for i, (t, col) in enumerate(zip(types_, columns)):
            d = dictionaries[i] if dictionaries else None
            blocks.append(Block.from_pylist(t, col, d))
        return Page(blocks, n)

    @staticmethod
    def concat(pages: Sequence["Page"]) -> "Page":
        if not pages:
            raise ValueError(
                "Page.concat of zero pages: caller must use empty_page(types)")
        pages = [p for p in pages if p.num_rows > 0] or list(pages[:1])
        if len(pages) == 1:
            return pages[0]
        nch = pages[0].channel_count
        blocks = []
        for c in range(nch):
            parts = [p.block(c).numpy() for p in pages]
            t = parts[0].type
            dictionary = parts[0].dictionary
            if t.is_pooled:
                # Re-encode into the first block's dictionary when pools differ.
                unified = []
                for b in parts:
                    if b.dictionary is dictionary:
                        unified.append(b.data)
                    else:
                        remap = dictionary.encode(b.dictionary.values) if len(b.dictionary) else np.empty(0, np.int32)
                        unified.append(remap[b.data] if len(remap) else b.data)
                data = np.concatenate(unified)
            else:
                data = np.concatenate([b.data for b in parts])
            if any(b.nulls is not None for b in parts):
                nulls = np.concatenate([b.nulls_array() for b in parts])
            else:
                nulls = None
            blocks.append(Block(t, data, nulls, dictionary))
        return Page(blocks, sum(p.num_rows for p in pages))


@dataclass
class DevicePage:
    """A page resident on one torch device: padded columns + a live-row
    mask.

    Filtering flips lanes off in ``valid`` instead of gathering survivors,
    so filter+project+agg chains stay on the device with static shapes;
    compaction happens only at host boundaries (``to_page``) or when an
    operator chooses to densify.

    - ``cols[i]``: tensor, shape (capacity,), dtype of types[i].storage
    - ``nulls[i]``: bool tensor (True = SQL NULL) — always materialized
    - ``valid``: bool tensor — lane holds a live row (row-count mask
      AND any filters applied so far)
    """

    types: list
    cols: list
    nulls: list
    valid: "torch.Tensor"  # noqa: F821
    dictionaries: list  # Optional[Dictionary] per column

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self):
        return self.valid.device

    def count(self) -> int:
        """Live row count (device sync)."""
        return int(self.valid.sum())

    @staticmethod
    def from_page(page: Page, device, capacity: Optional[int] = None
                  ) -> "DevicePage":
        import torch

        n = page.num_rows
        cap = capacity if capacity is not None else padded_size(n)
        if cap < n:
            raise ValueError(
                f"DevicePage capacity {cap} < page rows {n}")
        cols, nulls, dicts = [], [], []
        for b in page.blocks:
            b = b.numpy()
            data = np.zeros(cap, dtype=b.type.storage)
            data[:n] = b.data
            nl = np.zeros(cap, dtype=bool)
            if b.nulls is not None:
                nl[:n] = b.nulls
            cols.append(torch.from_numpy(data).to(device))
            nulls.append(torch.from_numpy(nl).to(device))
            dicts.append(b.dictionary)
        valid = np.zeros(cap, dtype=bool)
        valid[:n] = True
        return DevicePage([b.type for b in page.blocks], cols, nulls,
                          torch.from_numpy(valid).to(device), dicts)

    def to_page(self) -> Page:
        """Compact live lanes back to a host Page."""
        keep = np.nonzero(self.valid.cpu().numpy())[0]
        blocks = []
        for t, c, nl, d in zip(self.types, self.cols, self.nulls,
                               self.dictionaries):
            data = c.cpu().numpy()[keep]
            nulls = nl.cpu().numpy()[keep]
            blocks.append(Block(t, data, nulls if nulls.any() else None, d))
        return Page(blocks, len(keep))


def unify_dictionaries(pages, n_channels: int):
    """The one dictionary-pool compatibility rule for co-flowing pages:
    all non-None pools of a channel must be the SAME object (exchange
    boundaries re-encode divergent pools; everything downstream relies
    on identity).  Returns the per-channel pools or raises."""
    dicts = [None] * n_channels
    for p in pages:
        for i, d in enumerate(p.dictionaries):
            if d is not None:
                if dicts[i] is None:
                    dicts[i] = d
                elif dicts[i] is not d:
                    raise T.TrinoError(
                        "dictionary pools differ across pages; exchange "
                        "must unify pools", "GENERIC_INTERNAL_ERROR")
    return dicts


def empty_page(types_: Sequence[T.Type],
               dictionaries: Optional[Sequence] = None) -> Page:
    blocks = []
    for i, t in enumerate(types_):
        d = (dictionaries[i] if dictionaries else None) or (Dictionary() if t.is_pooled else None)
        blocks.append(Block(t, np.empty(0, dtype=t.storage), None, d))
    return Page(blocks, 0)
