"""Per statement, the summed wall of its statement spans (``span_kind``
``statement``: parse, plan, results and history, which the distributed
runner opens under the statement's root span), in ms; the mean over the
window's statements whose trace has them."""

from sqlbench import readers


def read(run):
    values = []
    for _, e in readers.matched(run):
        spans = [s for s in e.stats.get("trace") or ()
                 if s.get("attrs", {}).get("span_kind") == "statement"]
        if spans:
            values.append(sum(s["end"] - s["start"] for s in spans) * 1e3)
    return readers.mean(values)
