"""Of the traced window's idle device time (the stretches in which no
kernel, copy or set ran), the percent during which no operator call was
open on any thread: the host was then between operators (scheduling,
planning, serving), not inside one. The calls are the ``calls``
intervals the operator spans keep while the device trace records."""

from sqlbench import readers, summary


def read(run):
    t = run.trace
    if t is None:
        return None
    calls = []
    for _, e in readers.matched(run):
        for s in e.stats.get("trace") or ():
            calls.extend(tuple(c) for c in
                         s.get("attrs", {}).get("calls") or ())
    gaps = t.idle_gaps()
    idle = sum(b - a for a, b in gaps)
    if not calls or idle <= 0:
        return None
    inside = sum(summary.union_length(
        [(max(a, c0), min(b, c1)) for c0, c1 in calls
         if c1 > a and c0 < b]) for a, b in gaps)
    return 100.0 * (idle - inside) / idle
