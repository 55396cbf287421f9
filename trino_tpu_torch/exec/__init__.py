"""Execution: local planning, the driver loop, memory accounting."""
