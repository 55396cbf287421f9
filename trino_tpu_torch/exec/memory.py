"""Memory accounting: the per-query pool that operators charge.

Reference analog: ``memory/MemoryPool.java`` (per-query reservations)
and ``lib/trino-memory-context`` (the memory-context tree charged by
operators). The scarce resource is device memory: operators reserve the
footprint of the device pages they retain, and a reservation over the
query's ``query_max_memory_bytes`` fails with EXCEEDED_LOCAL_MEMORY_LIMIT.

The JAX engine's spill tiers (device -> host RAM -> disk), revocation
(and with it the hybrid hash join's partitioned build) and the node-wide
pool are not ported yet: a session with ``spill_enabled`` raises
NOT_SUPPORTED.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from ..types import TrinoError


class MemoryExceededError(TrinoError):
    def __init__(self, requested: int, reserved: int, limit: int):
        super().__init__(
            f"Query exceeded per-query memory limit of {limit} bytes "
            f"(reserved {reserved}, requested {requested}); "
            "raise query_max_memory_bytes",
            "EXCEEDED_LOCAL_MEMORY_LIMIT")
        self.requested = requested
        self.reserved = reserved
        self.limit = limit


def default_node_memory_bytes(device, fallback: int = 16 << 30) -> int:
    """The device's own memory capacity (``torch.cuda.mem_get_info`` on a
    CUDA device), so a node pool tracks real device memory instead of a
    hardwired constant; ``fallback`` for a CPU device, which reports
    none."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total)
    return fallback


def device_page_bytes(page) -> int:
    """Accounted device footprint of a DevicePage: padded columns + null
    masks + the valid mask."""
    cap = page.capacity
    total = cap  # valid mask (bool = 1 byte)
    for c in page.cols:
        total += cap * c.element_size()
        total += cap  # null mask
    return total


def reserve_and_append(ctx: "OperatorMemoryContext", pages: List, page):
    """The add_input discipline of operators that retain their input:
    charge the page, then keep it."""
    ctx.reserve(device_page_bytes(page))
    pages.append(page)


def prepare_finish(ctx: "OperatorMemoryContext", pages: List) -> int:
    """The accounted bytes of the retained pages, which the operator's
    finish pass now owns; the caller reserves its finish transient (~2x
    this, for the concatenation and its result). The JAX engine parks
    the pages on the host first when that transient would not fit; with
    no spill tier here, the reservation fails instead."""
    return sum(device_page_bytes(p) for p in pages)


class OperatorMemoryContext:
    """One operator's slice of the query pool (reference:
    ``memory/context/LocalMemoryContext``)."""

    def __init__(self, pool: "QueryMemoryPool", name: str):
        self.pool = pool
        self.name = name
        self.reserved = 0
        self.peak = 0               # high-water mark (survives close())

    def reserve(self, nbytes: int):
        if nbytes <= 0:
            return
        self.pool._reserve(self, nbytes)

    def free(self, nbytes: int):
        if nbytes <= 0:
            return
        self.pool._free(self, nbytes)

    def close(self):
        if self.reserved:
            self.pool._free(self, self.reserved)


class QueryMemoryPool:
    """Per-query device-memory accounting (reference:
    ``memory/MemoryPool.java``'s per-query reservation +
    ``QueryContext``)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self.reserved = 0
        self.peak_bytes = 0
        self._lock = threading.Lock()
        self._contexts: List[OperatorMemoryContext] = []

    def create_context(self, name: str) -> OperatorMemoryContext:
        ctx = OperatorMemoryContext(self, name)
        with self._lock:
            self._contexts.append(ctx)
        return ctx

    def _reserve(self, ctx: OperatorMemoryContext, nbytes: int):
        with self._lock:
            if self.reserved + nbytes > self.max_bytes:
                raise MemoryExceededError(nbytes, self.reserved,
                                          self.max_bytes)
            self.reserved += nbytes
            ctx.reserved += nbytes
            ctx.peak = max(ctx.peak, ctx.reserved)
            self.peak_bytes = max(self.peak_bytes, self.reserved)

    def _free(self, ctx: OperatorMemoryContext, nbytes: int):
        with self._lock:
            nbytes = min(nbytes, ctx.reserved)
            self.reserved -= nbytes
            ctx.reserved -= nbytes

    def close(self):
        """Release every context's residue (end of the query's life)."""
        with self._lock:
            contexts = list(self._contexts)
        for c in contexts:
            c.close()

    def stats(self) -> Dict[str, int]:
        return {
            "reserved_bytes": self.reserved,
            "peak_bytes": self.peak_bytes,
            "max_bytes": self.max_bytes,
        }


def pool_from_session(session) -> QueryMemoryPool:
    from .. import session_properties as SP

    if SP.value(session, "spill_enabled") \
            or SP.value(session, "spill_to_disk_enabled"):
        raise TrinoError("spilling is not ported to the torch engine yet",
                         "NOT_SUPPORTED")
    return QueryMemoryPool(SP.value(session, "query_max_memory_bytes"))
