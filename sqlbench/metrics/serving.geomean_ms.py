"""Geometric mean of the latency, POST to last page on the client's
clock, of every statement sent in the window (those still running at its
close are waited for): TPC-H's power metric, which weighs a short query
and a long one alike. Per layer: it follows the host's speed, which
moves from run to run by more than an end-to-end bound may hold."""

from sqlbench import summary


def read(run):
    lat = [r["latency_ms"] for r in run.answered()]
    return summary.geomean(lat) if lat else None
