"""Unified telemetry: metrics registry, span tracing, /metrics exposition,
copied from mmlspark_tpu/observability (stdlib only). The fleet layer
(fleet/slo) aggregates across replicas: exposition parse/merge/re-render,
W3C traceparent propagation, and SLO burn rates; `timeline` persists the
merged scrape as segment files in the JAX package's format and evaluates
alert rules over it. `profiler` attributes every fused dispatch and
serving request to a closed vocabulary of phases (disarmed by default);
`stage` wraps any transformer with metrics, a span and a flight
recorder."""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_BUCKETS, PHASE_BUCKETS, METRIC_NAME_RE,
                      get_registry, set_default_registry, set_enabled)
from .tracing import (Span, Tracer, get_tracer, set_default_tracer,
                      load_jsonl, merge_jsonl, format_traceparent,
                      parse_traceparent, current_traceparent,
                      CHROME_EVENT_KEYS, PHASE_SPAN_PREFIX, phase_children)
from .recorder import (FlightRecorder, load_dump, get_recorder,
                       set_default_recorder, DUMP_SCHEMA_VERSION)
from .profiler import (Profiler, PhaseLedger, PHASES, PROFILER_SERIES,
                       get_profiler, set_default_profiler,
                       cost_analysis_of, attribution_from_snapshot,
                       render_attribution)
from .stage import InstrumentedTransformer, FlightRecorderTransformer
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
    "phase_children", "InstrumentedTransformer",
    "FlightRecorderTransformer",
    "FlightRecorder", "load_dump", "get_recorder", "set_default_recorder",
    "DUMP_SCHEMA_VERSION",
    "Profiler", "PhaseLedger", "PHASES", "PROFILER_SERIES", "get_profiler",
    "set_default_profiler", "cost_analysis_of", "attribution_from_snapshot",
    "render_attribution",
    "MetricFamily", "MetricSample", "FamilyList", "MetricsAggregator",
    "parse_prometheus",
    "render_families", "merge_policy_for", "GAUGE_MERGE_POLICIES",
    "FLEET_REPLICA", "REPLICA_LABEL", "SLO", "SLOEngine", "SeriesReader",
    "availability_slo", "latency_slo",
    "TimelineStore", "TimelineRecorder", "AlertRule", "AlertEngine",
    "RegressionWatch", "TIMELINE_SERIES",
]
