"""Device time of host-to-device copies per statement in the traced
window: the memory connector keeps tables as host pages, and each scan
uploads them."""

from sqlbench import readers


def read(run):
    if run.trace is None:
        return None
    ms = sum(o.seconds for o in run.trace.ops
             if o.cat == "gpu_memcpy" and "HtoD" in o.name) * 1e3
    return readers.per_statement_in_trace(run, ms)
