"""Fault-tolerance substrate: failure taxonomy, deadlines, backoff, and
the deterministic fault-injection harness.

Reference analogs:
- ``spi/ErrorType.java`` — every failure is USER / INTERNAL / EXTERNAL /
  INSUFFICIENT_RESOURCES; retry policies consult the TYPE, not the
  message: user errors (division by zero, bad casts) are deterministic
  and fail fast, while infrastructure faults consume the retry budget
  (``execution/QueryStateMachine.java`` + ``faulttolerant/`` schedulers).
- ``execution/FailureInjector.java:40`` — injected task failures keyed
  by task id with an error type, for fault-tolerance tests.
- ``failuredetector/HeartbeatFailureDetector.java`` — the decay model
  behind worker-death detection (process_runner's heartbeat loop).

The ``FaultSchedule`` generalizes the seed's one-shot
``inject_task_failure`` into a seeded, deterministic chaos harness:
each armed fault is addressed by (task-id pattern, fault kind,
occurrence count) and is consumed exactly once per matching launch, so
a chaos run replays identically under a fixed schedule.

Host code only: a copy of the JAX engine's ``trino_tpu/parallel/fault.py``,
so both engines classify, back off and inject faults identically.
"""

from __future__ import annotations

import threading
import time
import traceback
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..types import TrinoError

# -- error taxonomy ------------------------------------------------------

USER = "USER"
INTERNAL = "INTERNAL"
EXTERNAL = "EXTERNAL"
INSUFFICIENT_RESOURCES = "INSUFFICIENT_RESOURCES"

ERROR_TYPES = (USER, INTERNAL, EXTERNAL, INSUFFICIENT_RESOURCES)

#: error codes that are NOT user mistakes — everything else raised as a
#: TrinoError is deterministic user input (retrying cannot help)
_INTERNAL_CODES = {"GENERIC_INTERNAL_ERROR", "PAGE_TRANSPORT_ERROR",
                   "REMOTE_TASK_ERROR", "NO_NODES_AVAILABLE"}
_RESOURCE_CODES = {"EXCEEDED_LOCAL_MEMORY_LIMIT",
                   "EXCEEDED_GLOBAL_MEMORY_LIMIT",
                   "EXCEEDED_MEMORY_LIMIT", "CLUSTER_OUT_OF_MEMORY",
                   "EXCEEDED_NODE_MEMORY", "EXCEEDED_CLUSTER_MEMORY"}


def classify_error_code(code: str) -> str:
    if code in _RESOURCE_CODES:
        return INSUFFICIENT_RESOURCES
    if code in _INTERNAL_CODES:
        return INTERNAL
    return USER


def classify_exception(exc: BaseException) -> str:
    """Map an exception to its error type (reference: each
    StandardErrorCode declares its ErrorType; here the taxonomy is
    derived from exception class + code)."""
    if isinstance(exc, RemoteTaskError):
        return exc.error_type
    if isinstance(exc, TrinoError):
        return classify_error_code(exc.code)
    if isinstance(exc, MemoryError):
        return INSUFFICIENT_RESOURCES
    if isinstance(exc, (ConnectionError, OSError, EOFError)):
        return EXTERNAL
    # torn spool files / lost exchange streams: the transport or the
    # durable store failed the engine (name-matched to avoid cycles)
    if type(exc).__name__ in ("SpoolCorruption", "ExchangeConnectionLost"):
        return EXTERNAL
    # AnalysisError and friends are user errors but never reach workers;
    # anything else raised during execution is an engine bug
    if type(exc).__name__ == "AnalysisError":
        return USER
    return INTERNAL


def is_retryable(error_type: str) -> bool:
    """USER errors are deterministic: re-running the same input re-fails
    (the reference's FTE retries only non-USER error types)."""
    return error_type != USER


def serialize_failure(exc: BaseException) -> dict:
    """Worker-side: pack a task failure for the RPC response so the
    coordinator sees the real error, its type, and the remote stack
    (reference: ExecutionFailureInfo shipped in TaskStatus)."""
    # TrinoError carries .code; an already-typed RemoteTaskError (a
    # transitively-propagated upstream failure) carries .error_code —
    # keep the original code either way so USER errors surface with
    # their real code after any number of exchange hops
    code = getattr(exc, "code", None) or getattr(exc, "error_code", None)
    return {
        "error": repr(exc),
        "error_type": classify_exception(exc),
        "error_code": code or "GENERIC_INTERNAL_ERROR",
        "remote_traceback": traceback.format_exc(),
        # a transport loss observed remotely stays a transport loss
        # after the hop: the coordinator's worker-lost (heal + query
        # retry) path keys off this flag
        "connection_lost": bool(getattr(exc, "connection_lost", False)),
        # torn durable state: a task retry would re-read the same bytes,
        # only a fresh query attempt (new spool) can recover — the
        # coordinator must not burn task retries on it
        "retry_scope": getattr(exc, "retry_scope", None) or (
            "query" if type(exc).__name__ == "SpoolCorruption"
            else "task"),
    }


class RemoteTaskError(RuntimeError):
    """A task/RPC failure with its taxonomy and the remote traceback —
    what `fetch_pages`/task RPCs raise instead of a bare string
    (reference: RemoteTaskException wrapping the worker's failure)."""

    def __init__(self, message: str, error_type: str = INTERNAL,
                 error_code: str = "GENERIC_INTERNAL_ERROR",
                 remote_traceback: str = "",
                 connection_lost: bool = False,
                 retry_scope: str = "task"):
        super().__init__(message)
        self.error_type = error_type
        self.error_code = error_code
        self.remote_traceback = remote_traceback
        self.connection_lost = connection_lost
        #: "task" (default) or "query": query-scoped failures (torn
        #: spool) are pointless to retry on another worker
        self.retry_scope = retry_scope

    @classmethod
    def from_response(cls, resp: dict, context: str = ""):
        msg = resp.get("error", "unknown remote failure")
        if context:
            msg = f"{context}: {msg}"
        tb = resp.get("remote_traceback") or ""
        if tb:
            msg = f"{msg}\n--- remote traceback ---\n{tb.rstrip()}"
        return cls(msg, resp.get("error_type", INTERNAL),
                   resp.get("error_code", "GENERIC_INTERNAL_ERROR"),
                   tb, bool(resp.get("connection_lost")),
                   resp.get("retry_scope") or "task")


# -- deadlines + backoff -------------------------------------------------


class Deadline:
    """Per-query wall-clock budget (`query_max_run_time`) enforced at
    every coordinator->worker RPC: the remaining budget caps each RPC
    timeout, and an expired deadline raises EXCEEDED_TIME_LIMIT — a USER
    error, so it is never retried (reference:
    QueryTracker.enforceTimeLimits)."""

    def __init__(self, max_run_time: float = 0.0):
        self.max_run_time = max_run_time
        self._expires = (time.monotonic() + max_run_time) \
            if max_run_time and max_run_time > 0 else None

    def remaining(self) -> Optional[float]:
        if self._expires is None:
            return None
        return self._expires - time.monotonic()

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0

    def check(self):
        if self.expired():
            raise TrinoError(
                f"query exceeded maximum run time of "
                f"{self.max_run_time}s", "EXCEEDED_TIME_LIMIT")

    def rpc_timeout(self, base: float) -> float:
        """Cap an RPC timeout by the remaining query budget."""
        self.check()
        rem = self.remaining()
        return base if rem is None else max(0.001, min(base, rem))


class BackoffPolicy:
    """Exponential backoff with deterministic jitter around query/task
    retries (reference: failure recovery's ExponentialBackoff). Seeded:
    the same (seed, attempt) always yields the same delay, so chaos runs
    replay identically."""

    def __init__(self, initial: float = 0.05, maximum: float = 2.0,
                 multiplier: float = 2.0, jitter: float = 0.25,
                 seed: int = 0):
        self.initial = initial
        self.maximum = maximum
        self.multiplier = multiplier
        self.jitter = jitter
        self.seed = seed

    def delay(self, attempt: int) -> float:
        base = min(self.maximum,
                   self.initial * (self.multiplier ** max(0, attempt)))
        # deterministic jitter in [1-j, 1+j): hash the (seed, attempt)
        # pair instead of sampling a shared RNG so concurrent queries
        # cannot perturb each other's schedules
        h = zlib.crc32(f"{self.seed}:{attempt}".encode()) / 0xFFFFFFFF
        return base * (1.0 - self.jitter + 2.0 * self.jitter * h)

    @staticmethod
    def seed_for(query_id: str) -> int:
        return zlib.crc32(query_id.encode())


class DecayingFailureStats:
    """Per-worker failure rate with exponential decay (reference:
    ``failuredetector/HeartbeatFailureDetector.java``'s DecayCounter):
    each recorded failure contributes weight 1 that halves every
    ``half_life_s`` seconds, so a worker that flapped a minute ago
    outranks one that failed within the last second, and a long-healed
    worker converges back to 0.  The scheduler sorts task/retry
    placement by this score so flapping workers shed load without being
    fenced outright."""

    def __init__(self, half_life_s: float = 60.0):
        import math

        self._decay = math.log(2.0) / max(half_life_s, 1e-9)
        self._weight = 0.0
        self._ts = 0.0
        self._lock = threading.Lock()
        self.total = 0              # undecayed lifetime count

    def _decayed_locked(self, now: float) -> float:
        import math

        if self._weight and now > self._ts:
            self._weight *= math.exp(-self._decay * (now - self._ts))
        self._ts = max(self._ts, now)
        return self._weight

    def record(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        with self._lock:
            self._weight = self._decayed_locked(now) + 1.0
            self.total += 1

    def score(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._decayed_locked(now)


# -- recovery observability ----------------------------------------------


@dataclass
class RecoveryStats:
    """What self-healing actually did, per query and cumulatively
    (surfaced through QueryResult.stats['recovery'], EXPLAIN ANALYZE and
    the bench output). Counters are bumped from parallel task threads,
    transport-retry callbacks and the monitor thread — mutate through
    the locked methods, not bare `+=`."""

    task_attempts: int = 0
    task_retries: int = 0
    query_retries: int = 0
    retries_by_type: Dict[str, int] = field(default_factory=dict)
    backoff_wall_s: float = 0.0
    workers_replaced: int = 0
    speculative_launched: int = 0
    speculative_wins: int = 0
    #: INSUFFICIENT_RESOURCES retries that re-admitted with a grown
    #: memory budget / reduced task width (memory-aware escalation)
    memory_escalations: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def incr(self, counter: str, amount=1):
        with self._lock:
            setattr(self, counter, getattr(self, counter) + amount)

    def record_retry(self, error_type: str, query_level: bool = False):
        with self._lock:
            if query_level:
                self.query_retries += 1
            else:
                self.task_retries += 1
            self.retries_by_type[error_type] = \
                self.retries_by_type.get(error_type, 0) + 1

    _FIELDS = ("task_attempts", "task_retries", "query_retries",
               "backoff_wall_s", "workers_replaced",
               "speculative_launched", "speculative_wins",
               "memory_escalations")

    def merge(self, other: "RecoveryStats"):
        with other._lock:
            snap = {f: getattr(other, f) for f in self._FIELDS}
            by_type = dict(other.retries_by_type)
        with self._lock:
            for f, v in snap.items():
                setattr(self, f, getattr(self, f) + v)
            for k, v in by_type.items():
                self.retries_by_type[k] = \
                    self.retries_by_type.get(k, 0) + v

    def to_dict(self) -> dict:
        return {
            "task_attempts": self.task_attempts,
            "task_retries": self.task_retries,
            "query_retries": self.query_retries,
            "retries_by_type": dict(self.retries_by_type),
            "backoff_wall_s": round(self.backoff_wall_s, 4),
            "workers_replaced": self.workers_replaced,
            "speculative_launched": self.speculative_launched,
            "speculative_wins": self.speculative_wins,
            "memory_escalations": self.memory_escalations,
        }


# -- deterministic fault injection ---------------------------------------

#: every fault shape the harness can inject, and where it fires
FAULT_KINDS = (
    "error",                # raise INTERNAL at task start (seed behavior)
    "user-error",           # raise a USER-typed error at task start
    "kill-worker",          # os._exit the worker process mid-task
    "drop-connection",      # close a results connection mid-frame
    "delay",                # straggler: sleep before executing
    "fail-after-publish",   # task fails AFTER its spool output published
    "kill-after-publish",   # os._exit the worker AFTER spool publish:
    #                         the output must outlive the process
    "truncate-spool",       # corrupt the published spool file mid-frame
    "revoke-memory",        # force a full pool revocation every
    #                         `countdown` reservations: pressure lands
    #                         mid-build AND mid-probe deterministically
)


@dataclass
class FaultSpec:
    pattern: str            # task-id prefix to match
    kind: str               # one of FAULT_KINDS
    remaining: int = 1      # occurrences left to fire
    delay_s: float = 0.0    # for kind == "delay"
    error_code: str = "DIVISION_BY_ZERO"   # for kind == "user-error"
    countdown: int = 1      # for kind == "revoke-memory": the period of
    #                         reservations between forced revocations
    fired: int = 0


class FaultSchedule:
    """Seeded, deterministic chaos harness (reference:
    FailureInjector.injectTaskFailure — generalized to five fault
    shapes). Faults are armed by (task-id pattern, kind, occurrences);
    ``match`` consumes one occurrence per matching task launch and
    returns the directive the coordinator ships with ``run_task``.

    Determinism: occurrence accounting is exact (first `remaining`
    matching launches, in launch order, fire the fault), and the seed
    parameterizes any randomized knob (currently delay jitter) through
    a private RNG — two runs with the same schedule and the same launch
    order inject identically.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.specs: List[FaultSpec] = []
        self._lock = threading.Lock()

    def add(self, pattern: str, kind: str = "error", times: int = 1,
            delay_s: float = 0.0,
            error_code: str = "DIVISION_BY_ZERO",
            countdown: int = 1) -> "FaultSchedule":
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        self.specs.append(FaultSpec(pattern, kind, times, delay_s,
                                    error_code, countdown))
        return self

    def match(self, task_id: str) -> Optional[dict]:
        """Consume and return the directive for this task launch, or
        None. First matching armed spec wins (schedule order)."""
        with self._lock:
            for spec in self.specs:
                if spec.remaining > 0 and task_id.startswith(spec.pattern):
                    spec.remaining -= 1
                    spec.fired += 1
                    directive = {"kind": spec.kind}
                    if spec.kind == "delay":
                        # deterministic jitter: +-10% keyed by (seed,
                        # pattern, occurrence)
                        h = zlib.crc32(
                            f"{self.seed}:{spec.pattern}:{spec.fired}"
                            .encode()) / 0xFFFFFFFF
                        directive["delay_s"] = spec.delay_s * \
                            (0.9 + 0.2 * h)
                    if spec.kind == "user-error":
                        directive["error_code"] = spec.error_code
                    if spec.kind == "revoke-memory":
                        directive["countdown"] = spec.countdown
                    return directive
        return None

    def pending(self) -> Dict[str, int]:
        with self._lock:
            return {s.pattern: s.remaining for s in self.specs
                    if s.remaining > 0}

    def armed(self) -> bool:
        return bool(self.pending())
