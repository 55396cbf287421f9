"""Kernel launches in the traced window per statement in it."""

from sqlbench import readers


def read(run):
    if run.trace is None:
        return None
    return readers.per_statement_in_trace(run, len(run.trace.kernels()))
