"""repro_torch.obs — the telemetry layer (tracing + metrics), a copy of the
JAX package's ``repro.obs`` with ``torch.profiler.record_function`` in
place of ``jax.profiler`` annotations.

- :class:`~repro_torch.obs.trace.Tracer` / :class:`~repro_torch.obs.trace.Span`
  — nestable phase-level wall-clock spans with Chrome-trace export, each
  also an annotation of a running ``torch.profiler``.
- :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters, gauges and
  p50/p95/p99 histograms rendering the ``repro.api/metrics/v1`` section.
"""
from repro_torch.obs.metrics import (METRICS_SCHEMA_ID, Counter, Gauge,
                                     Histogram, MetricsRegistry, percentile,
                                     validate_metrics)
from repro_torch.obs.trace import NULL_TRACER, Span, SpanEvent, Tracer

__all__ = [
    "METRICS_SCHEMA_ID", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "percentile", "validate_metrics",
    "NULL_TRACER", "Span", "SpanEvent", "Tracer",
]
