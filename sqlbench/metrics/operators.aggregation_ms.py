"""Per statement, the host wall of its aggregation operators (the
drivers' own wall counters, which include their waits on the device),
summed over the statement's operators; mean over the window's
statements."""

from sqlbench import readers


def read(run):
    return readers.mean(
        sum(op.get("wall_ms", 0.0) for op in e.stats.get("operators", ())
            if "Aggregation" in op.get("name", ""))
        for _, e in readers.matched(run))
