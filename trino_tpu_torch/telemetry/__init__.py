"""Telemetry layer of the torch engine: tracing, metrics, the program
profiler, the history-based statistics store and live query progress.

The JAX engine's ``trino_tpu/telemetry/`` modules of the same names:

- ``tracing``: Tracer/Span core with W3C-traceparent-style dict
  context, Chrome-trace-event export (Perfetto-loadable), span-timeline
  analysis (critical path) and the slow-query record;
- ``metrics``: process-local counter/gauge/histogram registry with
  Prometheus text exposition;
- ``profiler``: per-program calls, device time (CUDA events on the
  card), bytes and operations;
- ``stats_store``: per-plan-node actuals fed back into the cost model;
- ``connectors/system.py`` (outside this package) serves them as the
  ``system.runtime`` tables.

The port's own ``device_reads``: the one door for the host's reads of
device tensors, and the counters each read is charged to.
"""

from .metrics import (ClusterMetrics, MetricsRegistry, merge_families,
                      process_families, relabel, render_prometheus)
from .tracing import (NULL_TRACER, Span, Tracer, critical_path,
                      span_tree, to_chrome_trace, trace_line)

__all__ = [
    "ClusterMetrics", "MetricsRegistry", "merge_families",
    "process_families", "relabel", "render_prometheus",
    "NULL_TRACER", "Span", "Tracer", "critical_path", "span_tree",
    "to_chrome_trace", "trace_line",
]
