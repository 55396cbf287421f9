"""Statements completed in the window, over all streams, per second of
the window (host clock): TPC-H's throughput test in small."""

from sqlbench import summary


def read(run):
    return summary.rate(len(run.completed_in_window()), run.seconds)
