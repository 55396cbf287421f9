"""The system under test, as a configuration deploys it: the port's
runner over a memory connector that holds the generated tables, behind
the port's statement server.

``runner`` in the configuration file: ``{"kind": "local"}`` is
``LocalQueryRunner`` (coordinator and worker in one node);
``{"kind": "distributed", "n_workers": n}`` is
``parallel.DistributedQueryRunner`` with ``n`` worker tasks per stage on
one card. ``session`` sets session properties over the port's defaults.
"""

from __future__ import annotations


def make_runner(config: dict, db, device: str):
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.sql.analyzer import Session

    from . import data

    mem = MemoryConnector()
    data.load_memory(db, mem)
    session = Session(catalog="memory", schema="default")
    session.properties.update(config.get("session", {}))
    kind = config["runner"]["kind"]
    splits = int(config["desired_splits"])
    if kind == "local":
        from trino_tpu_torch import LocalQueryRunner

        return LocalQueryRunner({"memory": mem}, session,
                                desired_splits=splits, device=device)
    if kind == "distributed":
        from trino_tpu_torch.parallel import DistributedQueryRunner

        return DistributedQueryRunner(
            {"memory": mem}, session,
            n_workers=int(config["runner"]["n_workers"]),
            desired_splits=splits, device=device)
    raise ValueError(f"unknown runner kind {kind!r}")


def serve(runner):
    """The port's statement server over ``runner`` on a free local
    port, started."""
    from trino_tpu_torch.server.protocol import ProtocolServer

    return ProtocolServer(runner, host="127.0.0.1", port=0).start()
