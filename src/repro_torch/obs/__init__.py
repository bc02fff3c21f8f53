"""Observability subsystem: metrics registry, request tracer, exporters.

The port's own copy of ``repro.obs`` (stdlib only; the port imports
nothing of the JAX package), byte-for-byte the same behaviour: the same
metric names, bucket grids, dump and exposition formats and trace
schema (pinned against ``repro.obs`` in ``tests/test_torch_obs.py``).

Three pieces, all stdlib-only and clock-agnostic:

* :mod:`repro_torch.obs.registry` — a thread-safe
  :class:`MetricsRegistry` of counters, gauges, and fixed-bucket
  histograms with label support; the
  engine's ``EngineMetrics`` is a live view over it, and it exports as
  Prometheus text exposition or a deterministic JSON dump.
* :mod:`repro_torch.obs.trace` — a ring-buffered request-lifecycle
  :class:`Tracer` stamping every span event from an injected clock (the
  engine's single time base), exportable as Perfetto/Chrome
  ``trace_event`` JSON.
* :mod:`repro_torch.obs.exporters` — an optional background HTTP thread
  serving ``/metrics`` (Prometheus scrape endpoint) plus file-dump
  helpers for both exposition formats.

The JAX package's ``docs/observability.md`` lists the metric names and
the event schema.
"""
from repro_torch.obs.exporters import (dump_metrics, dump_trace,
                                       start_metrics_server)
from repro_torch.obs.registry import (ITL_BUCKETS, PHASE_BUCKETS,
                                      SPEC_REQUEST_BUCKETS,
                                      SPEC_WINDOW_BUCKETS, TTFT_BUCKETS,
                                      Counter, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs.trace import TraceEvent, Tracer, perfetto_json

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TTFT_BUCKETS", "ITL_BUCKETS", "PHASE_BUCKETS",
    "SPEC_WINDOW_BUCKETS", "SPEC_REQUEST_BUCKETS",
    "TraceEvent", "Tracer", "perfetto_json",
    "start_metrics_server", "dump_metrics", "dump_trace",
]
