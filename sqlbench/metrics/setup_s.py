"""Process start to the first timed POST: data generation and loading,
the runner, the server, the kernels' build or load, and the warm-up;
less the start of the benchmark's own profiler where an end-to-end metric
records the device, which is no part of the system's set-up."""


def read(run):
    return run.setup_s
