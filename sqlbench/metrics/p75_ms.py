"""75th percentile of the latencies of ``geomean_ms``, over all
statements of all streams: the highest percentile with ten or more of a
window's statements beyond it (a one-stream window of the cluster cell
holds about 40)."""

from sqlbench import summary


def read(run):
    lat = [r["latency_ms"] for r in run.answered()]
    return summary.percentile(lat, 75) if lat else None
