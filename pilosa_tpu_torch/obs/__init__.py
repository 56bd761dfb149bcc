"""Observability of the port: the metrics registry (:mod:`.metrics`),
spans and traces (:mod:`.tracing`), the tenant context (:mod:`.tenants`),
the query-history ring (:mod:`.history`) and the query logger
(:mod:`.logger`); the health plane (:mod:`.timeline`, :mod:`.slo` and
:mod:`.flight`, composed by :mod:`.health`) and the device profiler
(:mod:`.devprof`). Exports what ``pilosa_tpu/obs/__init__.py`` exports.
"""

from pilosa_tpu_torch.obs.flight import FlightRecorder
from pilosa_tpu_torch.obs.health import HealthPlane
from pilosa_tpu_torch.obs.history import (ExecutionRecord,
                                          ExecutionRequestsAPI)
from pilosa_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from pilosa_tpu_torch.obs.slo import (Objective, SLOTracker,
                                      default_objectives)
from pilosa_tpu_torch.obs.timeline import TimelineSampler, estimate_quantile
from pilosa_tpu_torch.obs.tracing import (
    NOP_SPAN, NopTracer, Span, TraceStore, Tracer, active_span, configure,
    current_span, current_traceparent, format_traceparent, get_tracer,
    parse_traceparent, set_tracer, span_scope,
)

__all__ = [
    "REGISTRY", "MetricsRegistry", "Tracer", "NopTracer", "Span",
    "TraceStore", "NOP_SPAN", "get_tracer", "set_tracer", "configure",
    "current_span", "active_span", "current_traceparent", "span_scope",
    "format_traceparent", "parse_traceparent",
    "ExecutionRecord", "ExecutionRequestsAPI",
    "HealthPlane", "TimelineSampler", "SLOTracker", "Objective",
    "FlightRecorder", "default_objectives", "estimate_quantile",
]
