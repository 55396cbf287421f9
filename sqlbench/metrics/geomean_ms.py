"""Geometric mean of the latency, POST to last page on the client's
clock, of every statement sent in the window (those still running at its
close are waited for): TPC-H's power metric, which weighs a short query
and a long one alike."""

from sqlbench import summary


def read(run):
    lat = [r["latency_ms"] for r in run.answered()]
    return summary.geomean(lat) if lat else None
