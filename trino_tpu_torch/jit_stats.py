"""Process-wide program first-call counters: the torch engine's
counterpart of the JAX engine's jit trace counters
(``trino_tpu/jit_stats.py``).

A torch function is not traced: it runs its operations eagerly, every
call. What the JAX engine counts as a trace (a cache miss of a jitted
program) is here the FIRST call of a named program at a new signature:
its name, the shapes and dtypes of its tensor arguments and the values
of its static scalars (``signature``). A ``CountedProgram`` keeps the
signatures it has seen, as a jitted program keeps its compiled cache,
and bumps the named counter on a signature it has not seen. So the
invariant reads the same in both engines: same-shape pages add no
count, and a count that keeps growing means the shapes keep changing.

The driver snapshots ``thread_total()`` around each operator call and
attributes the delta to the operator's ``compile_count``; the metric
family ``trino_jit_traces_total`` reads ``counts()``.
"""

from __future__ import annotations

import inspect
import threading
from typing import Dict, Tuple

import torch

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_tls = threading.local()


def bump(name: str) -> None:
    """Record one first call of the named program at a new signature."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + 1
    _tls.total = getattr(_tls, "total", 0) + 1


def counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def total() -> int:
    with _lock:
        return sum(_counts.values())


def total_for(*names: str) -> int:
    """Sum of the named counters (0 for programs never called) — lets
    tests assert "this program saw no new signature" without being
    perturbed by unrelated programs called concurrently."""
    with _lock:
        return sum(_counts.get(n, 0) for n in names)


def thread_total() -> int:
    """First calls recorded on THIS thread. A program runs on the thread
    that called it, so snapshot deltas of this value attribute first
    calls to the enclosing operator call exactly, even with concurrent
    drivers."""
    return getattr(_tls, "total", 0)


def reset() -> None:
    """Zero the counters (tests). Does NOT forget any program's seen
    signatures: a program already called at a shape will not re-bump,
    as a compiled JAX program stays warm."""
    with _lock:
        _counts.clear()


# -- signatures -------------------------------------------------------------


def _token(x):
    """Hashable token of one argument: a tensor by (shape, dtype,
    device type), a sequence by its items' tokens, a python scalar by
    its type (its value does not shape the program), anything else by
    itself (frozen IR, strings, None)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.is_cuda)
    if isinstance(x, (list, tuple)):
        return tuple(_token(v) for v in x)
    if isinstance(x, (bool, int, float)):
        return type(x)
    if isinstance(x, dict):
        return tuple(sorted((k, _token(v)) for k, v in x.items()))
    return x


def _static(x):
    """A static argument's value, lists made hashable."""
    if isinstance(x, list):
        return tuple(_static(v) for v in x)
    return x


def static_positions(fn, static_argnames: Tuple[str, ...]) -> frozenset:
    """Positional indices of ``fn``'s static parameters."""
    if not static_argnames:
        return frozenset()
    try:
        params = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return frozenset()
    return frozenset(i for i, p in enumerate(params)
                     if p in static_argnames)


def signature(args, kwargs, static_pos: frozenset,
              static_names: frozenset) -> tuple:
    """The program signature of one call: every argument's token,
    static arguments by value. Raises TypeError when a static value is
    unhashable."""
    parts = tuple(_static(a) if i in static_pos else _token(a)
                  for i, a in enumerate(args))
    if kwargs:
        parts += tuple(sorted(
            (k, _static(v) if k in static_names else _token(v))
            for k, v in kwargs.items()))
    hash(parts)
    return parts


class CountedProgram:
    """A named torch program that bumps its counter on the first call at
    each new signature (the per-program seen set stands for a jitted
    program's compiled cache: a fresh ``CountedProgram`` of the same
    function counts again, as a fresh ``jax.jit`` retraces)."""

    __slots__ = ("name", "fn", "static_pos", "static_names", "_seen",
                 "_lock", "_signature")

    def __init__(self, name: str, fn, static_argnames: Tuple[str, ...] = (),
                 signature_fn=None):
        self.name = name
        self.fn = fn
        self.static_names = frozenset(static_argnames)
        self.static_pos = static_positions(fn, tuple(static_argnames))
        self._seen: set = set()
        self._lock = threading.Lock()
        self._signature = signature_fn

    def signature(self, args, kwargs) -> tuple:
        """The call's signature: ``signature_fn(*args, **kwargs)`` when the
        program was given one (a cheap key standing for its arguments'
        shapes), else every argument's token. Raises TypeError when a
        static value is unhashable."""
        if self._signature is not None:
            return self._signature(*args, **kwargs)
        return signature(args, kwargs, self.static_pos, self.static_names)

    def note(self, sig) -> bool:
        """Record one call at ``sig``; True when it is the first."""
        with self._lock:
            if sig in self._seen:
                return False
            self._seen.add(sig)
        bump(self.name)
        return True

    def __call__(self, *args, **kwargs):
        try:
            sig = self.signature(args, kwargs)
        except TypeError:
            sig = None  # unhashable static: counted as one signature
        self.note(sig)
        return self.fn(*args, **kwargs)
