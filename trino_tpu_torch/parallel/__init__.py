"""Distributed execution on one device: the fragment runner, the stage
exchanges and the scaled-writer rebalancer."""


def __getattr__(name):
    # lazy: the runner imports the planner and operators, which import
    # this package's exchange primitives
    if name == "DistributedQueryRunner":
        from .distributed import DistributedQueryRunner

        return DistributedQueryRunner
    raise AttributeError(name)
