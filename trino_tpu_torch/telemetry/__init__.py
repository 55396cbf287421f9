"""Telemetry of the torch engine: the metrics registry and live query
progress (copies of the JAX engine's ``trino_tpu/telemetry/`` modules of
the same names; its tracer, profiler and history store are not ported).
"""
