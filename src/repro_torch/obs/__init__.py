"""Observability: tracing, metrics, exporters (the stack's joining view).

* :mod:`repro.obs.trace` — spans with injectable clocks and explicit
  cross-network parenting; disabled mode is a strict no-op.
* :mod:`repro.obs.metrics` — counters/gauges/fixed-bucket histograms plus
  adapters lifting the existing per-layer stat structs into uniformly
  named metrics.
* :mod:`repro.obs.export` — JSONL span dumps and Chrome trace-event
  files (flamegraphs), with span-tree integrity helpers.

PyTorch port: a copy of :mod:`repro.obs`; everything below
this docstring is unchanged.
"""
from .trace import NULL_TRACER, NullTracer, Span, TraceContext, Tracer
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      lift_ae_stats, lift_dispatch_stats, lift_io_stats,
                      lift_network, lift_query_stats, lift_struct)
from .export import (span_trees, spans_to_chrome, spans_to_jsonl, tree_names,
                     write_chrome_trace, write_jsonl)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span", "TraceContext",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "lift_struct", "lift_io_stats", "lift_query_stats", "lift_ae_stats",
    "lift_network", "lift_dispatch_stats",
    "spans_to_jsonl", "write_jsonl", "spans_to_chrome",
    "write_chrome_trace", "span_trees", "tree_names",
]
