"""Per statement, the host's ms blocked in its reads of device tensors
(``d2h_wait_ms`` over every span of its trace, summed over every thread
that read), mean over the window's statements."""

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
    return per_statement(run, "d2h_wait_ms")
