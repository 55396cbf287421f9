"""Per statement, the operators' time off the CPU: over its operator
spans, the busy wall less the thread CPU of the operator's calls
(``busy_ms`` - ``cpu_ms``), summed; the time their threads waited for
the interpreter lock, a lock or the device. Mean over the window's
statements whose operator spans carry ``cpu_ms``."""

from sqlbench import readers


def read(run):
    values = []
    for _, e in readers.matched(run):
        ops = [s["attrs"] for s in e.stats.get("trace") or ()
               if s.get("attrs", {}).get("span_kind") == "operator"
               and "cpu_ms" in s["attrs"]]
        if ops:
            values.append(sum(a["busy_ms"] - a["cpu_ms"] for a in ops))
    return readers.mean(values)
