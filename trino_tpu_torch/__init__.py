"""trino_tpu_torch — the SQL engine of ``trino_tpu`` on PyTorch and CUDA.

A port of ``trino_tpu`` (the JAX engine, kept as the reference) to torch
tensors on one device, with hand-written CUDA kernels for NVIDIA Hopper
where the JAX engine had Pallas kernels for the TPU. It imports neither
``jax`` nor ``trino_tpu``: the host layers (types, parser, analyzer,
planner, connectors) are the JAX engine's own code, copied.

Entry point: ``LocalQueryRunner(connectors, session, device="cuda")``.
The device is explicit; tests pass ``device="cpu"``.
"""

from .runner import LocalQueryRunner, QueryResult  # noqa: F401

__version__ = "0.1.0"
