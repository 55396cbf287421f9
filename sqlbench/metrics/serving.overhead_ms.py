"""Per statement, the client's latency less the server-side wall of the
runner's execution of it (timed by ``instrument.TimedRunner`` around the
call the server makes): queueing, HTTP, paging and polling. Mean over
the window's statements."""

from sqlbench import readers


def read(run):
    return readers.mean(rec["latency_ms"] - e.wall_ms
                        for rec, e in readers.matched(run))
