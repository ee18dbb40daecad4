"""Unified telemetry: metrics registry, span tracing, /metrics exposition,
copied from mmlspark_tpu/observability (stdlib only). The fleet layer
(fleet/slo) aggregates across replicas: exposition parse/merge/re-render,
W3C traceparent propagation, and SLO burn rates; `timeline` persists the
merged scrape as segment files in the JAX package's format and evaluates
alert rules over it. The JAX package's profiler and stage modules are not
ported yet (ROADMAP.md Queue 1, item 15)."""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_BUCKETS, PHASE_BUCKETS, METRIC_NAME_RE,
                      get_registry, set_default_registry, set_enabled)
from .tracing import (Span, Tracer, get_tracer, set_default_tracer,
                      load_jsonl, merge_jsonl, format_traceparent,
                      parse_traceparent, current_traceparent,
                      CHROME_EVENT_KEYS, PHASE_SPAN_PREFIX, phase_children)
from .recorder import (FlightRecorder, load_dump, get_recorder,
                       set_default_recorder, DUMP_SCHEMA_VERSION)
from .fleet import (MetricFamily, MetricSample, FamilyList,
                    MetricsAggregator,
                    parse_prometheus, render_families, merge_policy_for,
                    GAUGE_MERGE_POLICIES, FLEET_REPLICA, REPLICA_LABEL)
from .slo import (SLO, SLOEngine, SeriesReader, availability_slo,
                  latency_slo)
from .timeline import (TimelineStore, TimelineRecorder, AlertRule,
                       AlertEngine, RegressionWatch, TIMELINE_SERIES)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "PHASE_BUCKETS", "METRIC_NAME_RE", "get_registry",
    "set_default_registry", "set_enabled",
    "Span", "Tracer", "get_tracer", "set_default_tracer", "load_jsonl",
    "merge_jsonl", "format_traceparent", "parse_traceparent",
    "current_traceparent", "CHROME_EVENT_KEYS", "PHASE_SPAN_PREFIX",
    "phase_children",
    "FlightRecorder", "load_dump", "get_recorder", "set_default_recorder",
    "DUMP_SCHEMA_VERSION",
    "MetricFamily", "MetricSample", "FamilyList", "MetricsAggregator",
    "parse_prometheus",
    "render_families", "merge_policy_for", "GAUGE_MERGE_POLICIES",
    "FLEET_REPLICA", "REPLICA_LABEL", "SLO", "SLOEngine", "SeriesReader",
    "availability_slo", "latency_slo",
    "TimelineStore", "TimelineRecorder", "AlertRule", "AlertEngine",
    "RegressionWatch", "TIMELINE_SERIES",
]
