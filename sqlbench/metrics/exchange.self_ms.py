"""Self time of the exchange operators' spans (the exchange sources and
sinks, host or device) per statement: the spans of every statement's
trace (``stats["trace"]``, which the distributed runner records under
``query_tracing_enabled``), each counted once by its id, summed over the
window and divided by the window's statements. The runner keeps its
tracer on itself, so under concurrent statements a span can land in
another statement's trace; counting each span once over the window
keeps the total whole."""

from sqlbench import readers
from sqlbench.summary import union_length


def _exchange(name):
    return "Exchange" in name or name == "PartitionedOutputOperator"


def self_ms(spans):
    children = {}
    for s in spans:
        children.setdefault(s.get("parent_id"), []).append(s)
    total = 0.0
    for s in spans:
        if not _exchange(s.get("name", "")):
            continue
        kids = [(max(c["start"], s["start"]), min(c["end"], s["end"]))
                for c in children.get(s["span_id"], ())
                if c["end"] > s["start"] and c["start"] < s["end"]]
        total += (s["end"] - s["start"]) - union_length(kids)
    return total * 1e3


def read(run):
    pairs = readers.matched(run)
    spans = {}
    for _, e in pairs:
        for s in e.stats.get("trace") or ():
            spans[s["span_id"]] = s
    if not spans:
        return None
    return self_ms(list(spans.values())) / len(pairs)
