"""Memory governance: node-wide and per-query pools, and the host-RAM
and disk spill tiers.

Reference analog: ``memory/MemoryPool.java`` (one pool per node shared by
every query, with per-query reservations),
``lib/trino-memory-context`` (the memory-context tree charged by
operators), ``execution/MemoryRevokingScheduler.java:48`` (pool pressure
-> revoke the largest revocable operators) and
``spiller/FileSingleStreamSpiller.java`` (the disk spill target with its
checksummed page frames).

The design is the JAX engine's (``trino_tpu/exec/memory.py``). The scarce
resource is device memory: operators reserve the footprint of the device
pages they retain. Spill degrades in two tiers — device -> host (a
``DevicePage`` parked as numpy arrays in a ``SpilledPage``) and host ->
disk (a ``DiskSpilledPage`` holding a CRC-framed, atomically written
spill file; see ``serde.spill_frame``) — so a query under pressure
degrades instead of failing. Pool hierarchy:

  NodeMemoryPool            one per worker process, all queries charge it
    QueryMemoryPool         per (query, worker): query_max_memory_bytes
      OperatorMemoryContext per stateful operator (agg/join/sort)

A reservation that would exceed the query's ``query_max_memory_bytes``
first revokes the query's own revocable contexts largest-first (when
``spill_enabled``); one that would exceed the node cap revokes across
queries largest-first; still over => MemoryExceededError
(EXCEEDED_LOCAL_MEMORY_LIMIT) respectively NodeMemoryExceededError
(EXCEEDED_NODE_MEMORY) — both INSUFFICIENT_RESOURCES, so the
coordinator's memory-aware retry can re-admit with a grown budget.
Host-RAM residency of spilled state is tracked by a ``HostSpillLedger``
(node-wide when a node pool exists); crossing its limit
(``spill_host_memory_bytes``) demotes the largest parked pages to disk
when ``spill_to_disk_enabled``.

A parked page remembers the device it came from and goes back there, so a
runner on ``cuda:1`` reloads onto ``cuda:1``, not the default device. The
node-wide pool belongs to a worker process of the multi-process runner
(``parallel/worker.py``); the one-card distributed runner gives all tasks
of a query one pool. On CUDA several worker processes share one card,
and ``default_node_memory_bytes`` reports the whole card to each of them:
size ``node_max_memory_bytes`` to each process's share.

Locking: the pool lock and context locks are never held together —
revoke callbacks run under the victim context's lock only, and pool
bookkeeping for the freed bytes happens after the context lock is
released. The node pool's lock is likewise never held across a revoke
callback. Operators mutate spillable state only under their context lock.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Callable, Dict, List, Optional

import numpy as np

from ..types import TrinoError
from ..telemetry.device_reads import to_host


class MemoryExceededError(TrinoError):
    def __init__(self, requested: int, reserved: int, limit: int):
        super().__init__(
            f"Query exceeded per-query memory limit of {limit} bytes "
            f"(reserved {reserved}, requested {requested}); "
            "raise query_max_memory_bytes or enable spill_enabled",
            "EXCEEDED_LOCAL_MEMORY_LIMIT")
        self.requested = requested
        self.reserved = reserved
        self.limit = limit


class NodeMemoryExceededError(TrinoError):
    """The worker-wide pool is exhausted across ALL queries and
    cross-query revocation could not free enough (reference: the node
    MemoryPool blocking with no revocable bytes left)."""

    def __init__(self, requested: int, reserved: int, limit: int,
                 query_id: str = ""):
        super().__init__(
            f"Worker memory pool exhausted: node limit {limit} bytes, "
            f"reserved {reserved} across all queries, query "
            f"{query_id or '?'} requested {requested} more",
            "EXCEEDED_NODE_MEMORY")
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
    masks + the valid mask. Disk-parked pages carry their recorded
    footprint (their arrays are not in RAM to measure)."""
    recorded = getattr(page, "hbm_bytes", None)
    if recorded is not None:
        return recorded
    cap = page.capacity
    total = cap  # valid mask (bool = 1 byte)
    for c in page.cols:  # torch tensors on the device, numpy when parked
        total += cap * c.itemsize
        total += cap  # null mask
    return total


class SpilledPage:
    """A DevicePage parked in host RAM.

    Live lanes are compacted on the device (``DevicePage.live_lanes``,
    the wire's compaction too) and padded to the smallest power-of-two
    capacity: device pages are often mostly dead lanes (filtered rows,
    partials padded to their input capacity), so compaction shrinks both
    the host footprint and the device memory needed to bring the page
    back. ``device`` is where ``to_device`` puts it back."""

    __slots__ = ("types", "cols", "nulls", "valid", "dictionaries",
                 "device", "__weakref__")

    def __init__(self, page):
        import torch

        from ..block import padded_size

        self.types = list(page.types)
        self.dictionaries = list(page.dictionaries)
        self.device = page.device
        keep = torch.nonzero(page.valid).squeeze(1)
        k = int(keep.shape[0])
        cap = padded_size(k)
        if cap < page.capacity:
            _, cols, nulls = page.live_lanes(keep)
            self.cols = [np_pad(c, cap) for c in cols]
            self.nulls = [np_pad(n, cap) for n in nulls]
            v = np.zeros(cap, dtype=bool)
            v[:k] = True
            self.valid = v
        else:
            self.cols = [to_host(c, "spill.page") for c in page.cols]
            self.nulls = [to_host(n, "spill.page") for n in page.nulls]
            self.valid = to_host(page.valid, "spill.page")

    @classmethod
    def from_host(cls, types, cols, nulls, valid, dictionaries,
                  device) -> "SpilledPage":
        """A page over host arrays already compacted and padded; it
        reloads onto ``device``."""
        page = cls.__new__(cls)
        page.types = list(types)
        page.dictionaries = list(dictionaries)
        page.device = device
        page.cols, page.nulls, page.valid = list(cols), list(nulls), valid
        return page

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    def host_bytes(self) -> int:
        return sum(c.nbytes for c in self.cols) \
            + sum(n.nbytes for n in self.nulls) + self.valid.nbytes

    def host(self) -> "SpilledPage":
        """An in-RAM view of this page (disk-parked pages load here)."""
        return self

    def to_device(self):
        import torch

        from ..block import DevicePage

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return DevicePage(list(self.types), [up(c) for c in self.cols],
                          [up(n) for n in self.nulls], up(self.valid),
                          list(self.dictionaries))


def np_pad(a: np.ndarray, cap: int, fill: bool = False) -> np.ndarray:
    """``a`` padded to ``cap`` lanes with zeros (with ``fill`` for a bool
    array)."""
    if a.shape[0] == cap:
        return a
    out = np.full(cap, fill, dtype=bool) if a.dtype == bool \
        else np.zeros(cap, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


class DiskSpilledPage(SpilledPage):
    """A SpilledPage demoted to a per-query spill file: the arrays live
    on disk in one CRC-checked frame (``serde.spill_frame``), written
    atomically; only types, dictionaries, device and footprint stay in
    RAM (dictionaries are shared host objects — the page reloads in this
    process, so pools need not be serialized).

    Reference analog: ``spiller/FileSingleStreamSpiller.java`` — the
    tier below host RAM."""

    __slots__ = ("path", "_capacity", "hbm_bytes", "disk_bytes")

    def __init__(self, spilled: SpilledPage, path: str):
        # deliberately no super().__init__: the array slots stay unset
        self.types = list(spilled.types)
        self.dictionaries = list(spilled.dictionaries)
        self.device = spilled.device
        self.path = path
        self._capacity = spilled.capacity
        self.hbm_bytes = device_page_bytes(spilled)
        self.disk_bytes = 0  # set by DiskSpiller after the write

    @property
    def capacity(self) -> int:
        return self._capacity

    def host(self) -> SpilledPage:
        """Load the frame back into an in-RAM SpilledPage."""
        from .serde import read_spill_file

        cols, nulls, valid = read_spill_file(self.path)
        return SpilledPage.from_host(self.types, cols, nulls, valid,
                                     self.dictionaries, self.device)

    def to_device(self):
        return self.host().to_device()


class HostSpillLedger:
    """Live host-RAM bytes held by SpilledPages, node-wide when a node
    pool exists. Charged at spill time and discharged by a weakref
    finalizer when the parked page is dropped (uploaded back or
    demoted), so residency tracks actual lifetime, not call sites.

    The ledger also tracks the operator page lists holding parked pages
    (with the context lock guarding each), so over-limit demotion can
    run across operator lists: the operator that spills last is often
    not the one parking the biggest pages (reference:
    MemoryRevokingScheduler picking victims pool-wide)."""

    def __init__(self, limit_bytes: Optional[int] = None):
        self.limit_bytes = limit_bytes
        self.resident_bytes = 0
        self.peak_bytes = 0
        self.cross_list_demotions = 0
        # reentrant: dropping a SpilledPage reference can fire its
        # ``_discharge`` finalizer on the dropping thread at any
        # allocation/decref point — including while this lock is held
        self._lock = threading.RLock()
        #: (pages list, guarding context lock, owning QueryMemoryPool);
        #: entries die with their pool (untrack_pool at close)
        self._tracked: List[tuple] = []

    def charge(self, page: SpilledPage) -> None:
        nbytes = page.host_bytes()
        with self._lock:
            self.resident_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.resident_bytes)
        weakref.finalize(page, self._discharge, nbytes)

    def _discharge(self, nbytes: int) -> None:
        with self._lock:
            self.resident_bytes -= nbytes

    def over_limit(self) -> bool:
        with self._lock:
            return self.limit_bytes is not None \
                and self.resident_bytes > self.limit_bytes

    # -- cross-operator-list demotion -----------------------------------

    def track(self, pages: List, lock, pool: "QueryMemoryPool") -> None:
        """Register an operator's revocable page list as a demotion
        candidate (idempotent per list)."""
        if pool.disk_spiller is None:
            return  # its pages can never demote — don't scan them
        with self._lock:
            for ps, _, _ in self._tracked:
                if ps is pages:
                    return
            self._tracked.append((pages, lock, pool))

    def untrack_pool(self, pool: "QueryMemoryPool") -> None:
        with self._lock:
            dropped = [t for t in self._tracked if t[2] is pool]
            self._tracked = [t for t in self._tracked
                             if t[2] is not pool]
        # the entries held the last strong refs to their page lists:
        # release outside the lock so the pages' discharge finalizers
        # (which take it) fire lock-free
        del dropped

    def demote_across(self, exclude: Optional[List] = None) -> None:
        """Demote in-RAM SpilledPages of other tracked lists,
        largest-first, while over limit. Foreign context locks are taken
        non-blocking: an operator actively mutating its state is skipped
        rather than deadlocked against (the caller already holds its own
        context lock)."""
        if not self.over_limit():
            return
        with self._lock:
            tracked = list(self._tracked)
        held = []
        demoted = 0
        try:
            for pages, lock, pool in tracked:
                if pages is exclude:
                    continue
                if not lock.acquire(blocking=False):
                    continue
                if pool.disk_spiller.closed:
                    lock.release()  # pool closed after the snapshot
                    continue
                held.append((pages, lock, pool))
            candidates = sorted(
                ((i, pages, pool)
                 for pages, _, pool in held
                 for i, p in enumerate(pages)
                 if isinstance(p, SpilledPage)
                 and not isinstance(p, DiskSpilledPage)),
                key=lambda t: -t[1][t[0]].host_bytes())
            for i, pages, pool in candidates:
                if not self.over_limit():
                    break
                try:
                    pages[i] = pool.disk_spiller.spill(pages[i])
                except SpillerClosedError:
                    continue  # close() raced the spill; nothing leaked
                demoted += 1
        finally:
            for _, lock, _ in held:
                lock.release()
        if demoted:
            with self._lock:
                self.cross_list_demotions += demoted


class SpillerClosedError(RuntimeError):
    """A demotion raced the owning query's close: the spill directory is
    gone and must not be recreated."""


def spill_root() -> str:
    """Where spill directories go: ``TRINO_TPU_SPILL_DIR``, else
    ``trino_tpu_torch_spill`` under the process's temporary directory
    (its own name, so a test run of both engines never shares one).
    Read per spiller, not at import: embedders may set it later."""
    import tempfile

    return os.environ.get("TRINO_TPU_SPILL_DIR") or os.path.join(
        tempfile.gettempdir(), "trino_tpu_torch_spill")


class DiskSpiller:
    """Per-query spill-file manager: one directory per query under
    ``spill_root()/<pid>``, one CRC-framed file per demoted page, atomic
    writes (reference: ``FileSingleStreamSpiller`` + ``SpillerFactory``'s
    per-query directories)."""

    def __init__(self, query_id: str = "q"):
        self.query_id = query_id
        self._dir: Optional[str] = None
        self._seq = 0
        self._lock = threading.Lock()
        self.closed = False
        self.spill_events = 0
        self.spilled_bytes = 0       # uncompressed bytes demoted
        self.file_bytes = 0          # on-disk (compressed) bytes

    def _next_path(self) -> str:
        import tempfile

        with self._lock:
            if self.closed:
                raise SpillerClosedError("spiller closed")
            if self._dir is None:
                base = os.path.join(spill_root(), str(os.getpid()))
                os.makedirs(base, exist_ok=True)
                self._dir = tempfile.mkdtemp(
                    prefix=f"{self.query_id}.", dir=base)
            self._seq += 1
            return os.path.join(self._dir, f"spill-{self._seq}.bin")

    def spill(self, page: SpilledPage) -> DiskSpilledPage:
        from .serde import write_spill_file

        path = self._next_path()
        disk = DiskSpilledPage(page, path)
        nbytes = write_spill_file(path, page.cols, page.nulls, page.valid)
        disk.disk_bytes = nbytes
        with self._lock:
            self.spill_events += 1
            self.spilled_bytes += page.host_bytes()
            self.file_bytes += nbytes
        # the file dies with the page object (upload consumed it) or at
        # close(), whichever first
        weakref.finalize(disk, _remove_quiet, path)
        return disk

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"disk_spill_events": self.spill_events,
                    "disk_spilled_bytes": self.spilled_bytes,
                    "disk_file_bytes": self.file_bytes}

    def close(self):
        import shutil

        with self._lock:
            self.closed = True
            d, self._dir = self._dir, None
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)


def _remove_quiet(path: str):
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def spill_pages(pages: List, pool: "QueryMemoryPool" = None,
                lock=None) -> int:
    """Convert DevicePage entries to SpilledPage in place (caller holds
    the owning context's lock); returns the device bytes freed. With a
    pool, host residency is charged to its ledger and — when the ledger
    is over its limit and disk spill is enabled — the largest parked
    pages demote to the disk tier, in this list first and then across
    every other tracked operator list. ``lock`` is the context lock
    guarding ``pages``: passing it registers the list so other
    operators' over-limit demotions can reach these pages too."""
    from ..block import DevicePage

    freed = 0
    for i, p in enumerate(pages):
        if isinstance(p, DevicePage):
            freed += device_page_bytes(p)
            spilled = SpilledPage(p)
            if pool is not None:
                pool.host_ledger.charge(spilled)
            pages[i] = spilled
    if pool is not None:
        if lock is not None:
            pool.host_ledger.track(pages, lock, pool)
        pool.maybe_demote(pages)
    return freed


def reserve_and_append(ctx: "OperatorMemoryContext", pages: List, page):
    """The add_input discipline of spillable operators: charge the page,
    then publish it to the revocable list under the context lock."""
    ctx.reserve(device_page_bytes(page))
    with ctx.lock:
        pages.append(page)


def prepare_finish(ctx: "OperatorMemoryContext", pages: List):
    """Shared finish-time transition for spillable operators: their pages
    stop being revocable (the finish pass owns them), so if the finish
    transient (~2x total for concat + result) would not fit alongside the
    current reservations, park everything on the host first — spill
    compacts dead lanes, so totals are recomputed from parked sizes (=
    what re-upload actually costs). Returns (total, uploads)."""
    pool = ctx.pool
    with ctx.lock:
        total = sum(device_page_bytes(p) for p in pages)
        uploads = sum(device_page_bytes(p) for p in pages
                      if isinstance(p, SpilledPage))
        freed = 0
        if pool.spill_enabled and \
                pool.reserved + uploads + 2 * total > pool.max_bytes:
            freed = spill_pages(pages, pool, ctx.lock)
            total = sum(device_page_bytes(p) for p in pages)
            uploads = total
        # clear the callback inside the lock: a concurrent pool revoke
        # between the totals above and here would invalidate them
        ctx.set_revoke_callback(None)
    if freed:
        pool.record_spill(freed)
        ctx.free(freed)
    return total, uploads


class OperatorMemoryContext:
    """One operator's slice of the query pool (reference:
    ``memory/context/LocalMemoryContext``).

    ``lock`` guards the owner's spillable state; a revoke callback runs
    under it. ``reserve``/``free`` must be called without holding it."""

    def __init__(self, pool: "QueryMemoryPool", name: str):
        self.pool = pool
        self.name = name
        self.lock = threading.RLock()
        self.reserved = 0
        self.peak = 0               # high-water mark (survives close())
        self.revocable = 0          # portion of reserved revoke can free
        self._revoke_cb: Optional[Callable[[], int]] = None

    def set_revoke_callback(self, cb: Optional[Callable[[], int]]):
        """cb() spills the owner's revocable state to the host and
        returns the bytes freed (reference: Operator.startMemoryRevoke)."""
        self._revoke_cb = cb

    def reserve(self, nbytes: int, revocable: bool = True):
        if nbytes <= 0:
            return
        self.pool._reserve(self, nbytes, revocable)

    def free(self, nbytes: int, revocable: bool = True):
        if nbytes <= 0:
            return
        self.pool._free(self, nbytes, revocable)

    def close(self):
        if self.reserved:
            self.pool._free(self, self.reserved, revocable=False)
            self.revocable = 0


class QueryMemoryPool:
    """Per-(query, node) device-memory accounting with synchronous
    revocation (reference: ``memory/MemoryPool.java``'s per-query
    reservation + ``QueryContext``). With a ``parent`` NodeMemoryPool every
    reservation also charges the node; without one (single-query runners)
    the pool stands alone."""

    def __init__(self, max_bytes: int, spill_enabled: bool = False,
                 spill_to_disk: bool = False,
                 host_spill_limit: Optional[int] = None,
                 parent: "NodeMemoryPool" = None,
                 query_id: str = "q"):
        self.max_bytes = int(max_bytes)
        self.spill_enabled = spill_enabled
        self.spill_to_disk = spill_to_disk
        self.query_id = query_id
        self.parent = parent
        self.reserved = 0
        self.peak_bytes = 0
        self.spill_events = 0
        self.spilled_bytes = 0
        self.partition_spills = 0       # hybrid-join partitions demoted
        self.partition_spilled_bytes = 0
        #: fault injection: a period of reserve calls — every
        #: ``countdown``-th reservation triggers one full-pressure
        #: revocation, so revocation lands mid-build and mid-probe
        #: without shrinking the pool
        self.fault_revoke_countdown: Optional[int] = None
        self._fault_revoke_left: Optional[int] = None
        self._lock = threading.Lock()
        self._contexts: List[OperatorMemoryContext] = []
        self.host_ledger = parent.host_ledger if parent is not None \
            else HostSpillLedger(host_spill_limit)
        self.disk_spiller = DiskSpiller(query_id) if spill_to_disk \
            else None

    def create_context(self, name: str) -> OperatorMemoryContext:
        ctx = OperatorMemoryContext(self, name)
        with self._lock:
            self._contexts.append(ctx)
        return ctx

    # -- spill tiers ----------------------------------------------------

    def maybe_demote(self, pages: List):
        """Demote the largest in-RAM SpilledPages to disk while the host
        ledger is over its limit: this operator's own list first (its
        context lock is already held by the caller), then across every
        other tracked operator list on the node."""
        if self.disk_spiller is None or not self.host_ledger.over_limit():
            return
        self._demote_list_locked(pages)
        if self.host_ledger.over_limit():
            self.host_ledger.demote_across(exclude=pages)

    def _demote_list_locked(self, pages: List):
        """Demote one list largest-first (caller holds the list's
        guarding context lock)."""
        order = sorted(
            (i for i, p in enumerate(pages)
             if isinstance(p, SpilledPage)
             and not isinstance(p, DiskSpilledPage)),
            key=lambda i: -pages[i].host_bytes())
        for i in order:
            if not self.host_ledger.over_limit():
                return
            # the replaced SpilledPage's finalizer discharges the
            # ledger as soon as the reference drops
            pages[i] = self.disk_spiller.spill(pages[i])

    # -- internal (called by contexts) ----------------------------------

    def _reserve(self, ctx: OperatorMemoryContext, nbytes: int,
                 revocable: bool):
        self._reserve_local(ctx, nbytes, revocable)
        if self.parent is not None:
            try:
                self.parent.reserve_for(self, nbytes)
            except TrinoError:
                # roll back the local admit only: the node charge never
                # happened, so _free's parent uncharge must not run
                with self._lock:
                    self._free_locked(ctx, nbytes, revocable)
                raise

    def _maybe_fault_revoke(self):
        """Injected revocation: every ``countdown``-th reserve call
        revokes everything revocable."""
        with self._lock:
            period = self.fault_revoke_countdown
            if period is None:
                return
            left = self._fault_revoke_left
            left = period - 1 if left is None else left - 1
            if left > 0:
                self._fault_revoke_left = left
                return
            self._fault_revoke_left = period
        self.revoke_up_to(self.max_bytes)

    def _reserve_local(self, ctx: OperatorMemoryContext, nbytes: int,
                       revocable: bool):
        self._maybe_fault_revoke()
        # revoke-until-fit: the target is re-derived under the lock each
        # round and the request fails only once revocation stops making
        # progress
        while True:
            with self._lock:
                if self.reserved + nbytes <= self.max_bytes:
                    self._admit_locked(ctx, nbytes, revocable)
                    return
                if not self.spill_enabled:
                    raise MemoryExceededError(nbytes, self.reserved,
                                              self.max_bytes)
                needed = self.reserved + nbytes - self.max_bytes
            # the requester's own state first: self-revoke is
            # deadlock-free (its RLock is reentrant on this thread) and
            # the largest state usually belongs to the operator asking
            if self.revoke_up_to(needed, prefer=ctx) <= 0:
                break
        with self._lock:
            if self.reserved + nbytes > self.max_bytes:
                raise MemoryExceededError(nbytes, self.reserved,
                                          self.max_bytes)
            self._admit_locked(ctx, nbytes, revocable)

    def revoke_up_to(self, needed: int, prefer=None) -> int:
        """Spill revocable contexts largest-first until ``needed`` bytes
        came free (or no revocable state remains); returns the bytes
        actually freed. Runs without the pool lock held: callbacks move
        whole operator states device -> host."""
        with self._lock:
            candidates = sorted(self._contexts,
                                key=lambda c: (c is not prefer,
                                               -c.revocable))
        total_freed = 0
        for c in candidates:
            if total_freed >= needed:
                break
            if c.revocable <= 0:
                continue
            # partial revocation: a callback may free only a slice of its
            # state per call (the hybrid hash join demotes one build
            # partition at a time) — keep asking the same context until
            # the target is met or it stops making progress
            while total_freed < needed:
                with c.lock:
                    cb = c._revoke_cb
                    freed = cb() if cb is not None else 0
                if freed <= 0:
                    break
                total_freed += freed
                self.record_spill(freed)
                self._free(c, freed, revocable=True)
        return total_freed

    def revocable_bytes(self) -> int:
        with self._lock:
            return sum(c.revocable for c in self._contexts)

    def _admit_locked(self, ctx, nbytes, revocable):
        self.reserved += nbytes
        ctx.reserved += nbytes
        ctx.peak = max(ctx.peak, ctx.reserved)
        if revocable:
            ctx.revocable += nbytes
        self.peak_bytes = max(self.peak_bytes, self.reserved)

    def _free(self, ctx: OperatorMemoryContext, nbytes: int,
              revocable: bool):
        with self._lock:
            freed = self._free_locked(ctx, nbytes, revocable)
        if freed and self.parent is not None:
            self.parent.uncharge_for(self, freed)

    def _free_locked(self, ctx, nbytes, revocable) -> int:
        nbytes = min(nbytes, ctx.reserved)
        self.reserved -= nbytes
        ctx.reserved -= nbytes
        if revocable:
            ctx.revocable = max(0, ctx.revocable - nbytes)
        return nbytes

    def record_spill(self, freed: int):
        with self._lock:
            self.spill_events += 1
            self.spilled_bytes += freed

    def record_partition_spill(self, freed: int, parts: int = 1):
        """One hybrid-join build partition demoted off the device."""
        with self._lock:
            self.partition_spills += parts
            self.partition_spilled_bytes += freed

    def close(self):
        """Release every context's residue and the disk spill directory
        (end of the query's life on this node)."""
        with self._lock:
            contexts = list(self._contexts)
        for c in contexts:
            c.close()
        # drop this query's page lists from the ledger's demotion
        # candidates before the spill directory dies with the spiller
        self.host_ledger.untrack_pool(self)
        if self.disk_spiller is not None:
            self.disk_spiller.close()

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, int]:
        out = {
            "reserved_bytes": self.reserved,
            "peak_bytes": self.peak_bytes,
            "max_bytes": self.max_bytes,
            "spill_events": self.spill_events,
            "spilled_bytes": self.spilled_bytes,
            "partition_spills": self.partition_spills,
            "partition_spilled_bytes": self.partition_spilled_bytes,
        }
        if self.disk_spiller is not None:
            out.update(self.disk_spiller.stats())
        return out


class NodeMemoryPool:
    """The worker-wide pool every concurrent query charges (reference:
    ``memory/MemoryPool.java`` — the actual per-node general pool).

    Over-budget reservations revoke across queries LARGEST-REVOCABLE-
    first; a node that still cannot admit records a blocked event (the
    signal the coordinator's low-memory killer keys on) and raises
    EXCEEDED_NODE_MEMORY."""

    def __init__(self, max_bytes: int,
                 host_spill_limit: Optional[int] = None):
        self.max_bytes = int(max_bytes)
        self.reserved = 0
        self.peak_bytes = 0
        self.blocked_events = 0
        self.cross_query_revokes = 0
        self._lock = threading.Lock()
        self._children: Dict[str, QueryMemoryPool] = {}
        #: peaks of already-released queries, kept so a heartbeat after
        #: the fast failure still feeds the retry MemoryEstimator
        self._released_peaks: Dict[str, int] = {}
        self.host_ledger = HostSpillLedger(host_spill_limit)

    def create_query_pool(self, query_id: str, max_bytes: int,
                          spill_enabled: bool = False,
                          spill_to_disk: bool = False) -> QueryMemoryPool:
        with self._lock:
            pool = self._children.get(query_id)
            if pool is None:
                pool = QueryMemoryPool(
                    max_bytes, spill_enabled, spill_to_disk,
                    parent=self, query_id=query_id)
                self._children[query_id] = pool
            else:
                # a hit must not serve a stale configuration (the
                # qlint cache-coherence class): a memory-aware retry
                # re-admits with an ESCALATED budget while a straggling
                # prior attempt still holds a pool ref — widen to the
                # newest request instead of silently keeping the old
                # limits
                pool.max_bytes = max(pool.max_bytes, int(max_bytes))
                pool.spill_enabled = pool.spill_enabled or spill_enabled
                if spill_to_disk and not pool.spill_to_disk:
                    pool.spill_to_disk = True
                    if pool.disk_spiller is None:
                        pool.disk_spiller = DiskSpiller(query_id)
            return pool

    def release_query(self, query_id: str):
        with self._lock:
            pool = self._children.pop(query_id, None)
            if pool is not None:
                if len(self._released_peaks) >= 64:
                    self._released_peaks.clear()
                self._released_peaks[query_id] = pool.peak_bytes
        if pool is not None:
            pool.close()
            # close() frees context residue, which uncharges us; any
            # accounting drift dies with the child here
            with self._lock:
                self.reserved -= min(self.reserved, pool.reserved)

    # -- charging (called by child pools, never under their lock) --------

    def reserve_for(self, child: QueryMemoryPool, nbytes: int):
        # revoke-until-fit (same discipline as the query pool): the
        # target re-derives under the lock each round so concurrent
        # admissions cannot turn a satisfiable request into a failure
        # while revocable state remains
        while True:
            with self._lock:
                if self.reserved + nbytes <= self.max_bytes:
                    self._admit_locked(nbytes)
                    return
                needed = self.reserved + nbytes - self.max_bytes
                # cross-query revocation, largest revocable first; the
                # requester revokes last (its state is already
                # host-bound if its own cap forced spill)
                victims = sorted(self._children.values(),
                                 key=lambda p: (p is child,
                                                -p.revocable_bytes()))
            round_freed = 0
            for victim in victims:
                if round_freed >= needed:
                    break
                if not victim.spill_enabled:
                    continue
                freed = victim.revoke_up_to(needed - round_freed)
                if freed > 0:
                    with self._lock:
                        self.cross_query_revokes += 1
                round_freed += freed
            if round_freed <= 0:
                break
        with self._lock:
            if self.reserved + nbytes > self.max_bytes:
                self.blocked_events += 1
                raise NodeMemoryExceededError(
                    nbytes, self.reserved, self.max_bytes,
                    child.query_id)
            self._admit_locked(nbytes)

    def _admit_locked(self, nbytes: int):
        self.reserved += nbytes
        self.peak_bytes = max(self.peak_bytes, self.reserved)

    def uncharge_for(self, child: QueryMemoryPool, nbytes: int):
        with self._lock:
            self.reserved -= min(self.reserved, nbytes)

    # -- observability ---------------------------------------------------

    def snapshot(self) -> dict:
        """The heartbeat-piggyback payload: node totals + per-query
        reservations, the ClusterMemoryManager's input (reference:
        MemoryInfo in the ServerInfo heartbeat).  ``blocked_events`` is
        a DELTA consumed by the read: one blocked episode must trigger
        at most one killer decision, not one per heartbeat forever."""
        with self._lock:
            queries = {qid: {"reserved": 0, "peak": peak, "spilled": 0}
                       for qid, peak in self._released_peaks.items()}
            queries.update({qid: {"reserved": p.reserved,
                                  "peak": p.peak_bytes,
                                  "spilled": p.spilled_bytes}
                            for qid, p in self._children.items()})
            blocked, self.blocked_events = self.blocked_events, 0
            return {
                "max_bytes": self.max_bytes,
                "reserved_bytes": self.reserved,
                "peak_bytes": self.peak_bytes,
                "blocked_events": blocked,
                "cross_query_revokes": self.cross_query_revokes,
                "host_spill_resident": self.host_ledger.resident_bytes,
                "queries": queries,
            }


def pool_from_session(session, query_id: str = "q",
                      parent: NodeMemoryPool = None) -> QueryMemoryPool:
    """The query's pool: a child of ``parent`` (a worker's node pool)
    when given, else a pool of its own."""
    from .. import session_properties as SP

    if parent is not None:
        return parent.create_query_pool(
            query_id, SP.value(session, "query_max_memory_bytes"),
            SP.value(session, "spill_enabled"),
            SP.value(session, "spill_to_disk_enabled"))
    return QueryMemoryPool(
        SP.value(session, "query_max_memory_bytes"),
        SP.value(session, "spill_enabled"),
        SP.value(session, "spill_to_disk_enabled"),
        host_spill_limit=SP.value(session, "spill_host_memory_bytes"),
        query_id=query_id)
