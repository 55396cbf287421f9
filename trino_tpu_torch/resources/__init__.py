"""Benchmark query texts (TPC-H), shared with the JAX engine's copy."""
