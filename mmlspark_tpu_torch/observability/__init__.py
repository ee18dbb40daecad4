"""Telemetry the checkpointer reports through: the metrics registry, span
tracing and the flight recorder, copied from mmlspark_tpu/observability
(stdlib only). The JAX package's profiler, stage, fleet, slo and timeline
modules are not ported yet (ROADMAP.md Queue 1, item 15)."""

from .metrics import (DEFAULT_BUCKETS, METRIC_NAME_RE, PHASE_BUCKETS, Counter, Gauge,
                      Histogram, MetricsRegistry, get_registry, set_default_registry,
                      set_enabled)
from .recorder import (DUMP_SCHEMA_VERSION, FlightRecorder, get_recorder, load_dump,
                       set_default_recorder)
from .tracing import (CHROME_EVENT_KEYS, PHASE_SPAN_PREFIX, Span, Tracer,
                      current_traceparent, format_traceparent, get_tracer, load_jsonl,
                      merge_jsonl, parse_traceparent, phase_children, set_default_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "PHASE_BUCKETS", "METRIC_NAME_RE", "get_registry", "set_default_registry",
    "set_enabled",
    "Span", "Tracer", "get_tracer", "set_default_tracer", "load_jsonl",
    "merge_jsonl", "format_traceparent", "parse_traceparent",
    "current_traceparent", "CHROME_EVENT_KEYS", "PHASE_SPAN_PREFIX",
    "phase_children",
    "FlightRecorder", "load_dump", "get_recorder", "set_default_recorder",
    "DUMP_SCHEMA_VERSION",
]
