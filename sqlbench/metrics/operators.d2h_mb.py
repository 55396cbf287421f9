"""Per statement, the bytes of the host's reads of device tensors
(``d2h_bytes`` over every span of its trace), in 10^6 bytes, mean over
the window's statements."""

from sqlbench import readers


def per_statement(run, key):
    """Mean over the window's traced statements of ``key`` summed over
    every span of the statement's trace; None where no span has it."""
    values, seen = [], False
    for _, e in readers.matched(run):
        spans = e.stats.get("trace")
        if not spans:
            continue
        attrs = [s.get("attrs", {}) for s in spans]
        seen = seen or any(key in a for a in attrs)
        values.append(sum(a.get(key, 0) for a in attrs))
    return readers.mean(values) if seen else None


def read(run):
    value = per_statement(run, "d2h_bytes")
    return None if value is None else value / 1e6
