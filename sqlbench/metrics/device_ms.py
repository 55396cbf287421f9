"""Device time per statement: the seconds of the traced span in which a
kernel, a set or a copy inside the device ran (the union of their
intervals), per statement in it; over the whole window in an untraced
run. Copies to and from the host are left out: the host's memory moves
at the host's pace, which this number is kept free of."""

from sqlbench import readers, summary


def on_device(op) -> bool:
    return op.cat in ("kernel", "gpu_memset") or (
        op.cat == "gpu_memcpy" and "DtoD" in op.name)


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    w = t.window_s
    busy = summary.union_length([(max(o.start, 0.0), min(o.end, w))
                                 for o in t.ops if on_device(o)
                                 and o.end > 0.0 and o.start < w])
    if busy <= 0:
        return None
    return readers.per_statement_in_trace(run, 1e3 * busy)
