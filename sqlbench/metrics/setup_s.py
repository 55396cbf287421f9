"""Process start to the first timed POST: data generation and loading,
the runner, the server, the kernels' build or load, and the warm-up."""


def read(run):
    return run.setup_s
