"""Observability: phase-span tracing, the metric registry, and the
Chrome/Perfetto trace exporter (DESIGN.md §14).

* :mod:`repro_torch.obs.tracer` — :class:`Span`/:class:`Tracer`: nested
  phase spans hanging off each :class:`~repro_torch.core.executor.JobRecord`.
  ``tracer=None`` everywhere means *no* tracing code runs.
* :mod:`repro_torch.obs.metrics` — counters / gauges / HDR-style
  histograms in one ``msj.* / svc.* / ft.*`` namespace, plus a JSONL sink.
* :mod:`repro_torch.obs.perfetto` — ``trace_event`` JSON writer, a schema
  validator, and :func:`~repro_torch.obs.perfetto.report_from_trace`,
  which reconstructs a Report whose ``net_time_by_events`` replays
  bit-exactly from the exported spans alone.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    JsonlSink,
    MetricRegistry,
    counter_attr,
)
from repro_torch.obs.perfetto import (  # noqa: F401
    audit_trace,
    phase_breakdown,
    report_from_trace,
    trace_events,
    validate_trace,
    write_trace,
)
from repro_torch.obs.tracer import Span, Tracer  # noqa: F401
