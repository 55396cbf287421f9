"""Distributed execution: the one-device fragment runner, the stage
exchanges and the scaled-writer rebalancer, and the multi-process
cluster (coordinator, worker processes, task RPC, the spooled exchange,
fault-tolerant retry, node memory pools)."""


def __getattr__(name):
    # lazy: the runners import the planner and operators, which import
    # this package's exchange primitives
    if name == "DistributedQueryRunner":
        from .distributed import DistributedQueryRunner

        return DistributedQueryRunner
    if name == "ProcessQueryRunner":
        from .process_runner import ProcessQueryRunner

        return ProcessQueryRunner
    raise AttributeError(name)
