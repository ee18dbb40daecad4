"""InstrumentedTransformer: Timer.scala parity, emitting into the registry.

A copy of mmlspark_tpu/observability/stage.py.

The reference's `Timer` stage (Timer.scala:55-124) logs wall-clock per
transform; core.pipeline.Timer reproduces that. This stage is the
telemetry-era version of the same wrapper: per-transform duration lands
in a labeled histogram, row throughput in a counter, and the transform
runs inside a tracer span — so any pipeline stage becomes scrapeable
from `/metrics` and visible in the exported trace by wrapping it.

FlightRecorderTransformer is the black-box sibling: same wrapping shape,
but per-transform events land in a FlightRecorder ring and an unhandled
exception in the wrapped stage dumps the ring to `flight_recorder_dir`
before re-raising — batch/streaming pipelines get the same postmortem
trail the serving fleet records (observability/recorder.py).
"""

from __future__ import annotations

from typing import Any

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage
from .metrics import MetricsRegistry, get_registry
from .recorder import FlightRecorder
from .tracing import Tracer, get_tracer

__all__ = ["InstrumentedTransformer", "FlightRecorderTransformer"]

STAGE_SECONDS = "mmlspark_tpu_pipeline_stage_seconds"
STAGE_ROWS = "mmlspark_tpu_pipeline_stage_rows_total"


@register_stage
class InstrumentedTransformer(Transformer):
    """Wrap a transformer: duration histogram + row counter + span.

    Series (labeled `stage=` the wrapped class name, or `stage_name`):
      mmlspark_tpu_pipeline_stage_seconds      transform wall time
      mmlspark_tpu_pipeline_stage_rows_total   rows transformed

    `metrics`/`tracer` are injectable attributes (process defaults when
    left None) — the MetricsRegistry surface is deliberately NOT a Param:
    registries hold live locks and belong to the process, not the saved
    stage."""

    inner = Param(None, "wrapped transformer stage", required=True)
    stage_name = Param(None, "series label (default: inner class name)",
                       ptype=str)
    disable = Param(False, "if true, pass through uninstrumented", ptype=bool)

    metrics: "MetricsRegistry | None" = None   # injectable; default registry
    tracer: "Tracer | None" = None             # injectable; default tracer
    last_elapsed: "float | None" = None        # Timer-parity attribute

    def __init__(self, inner: "Transformer | None" = None, **kw):
        super().__init__(**kw)
        if inner is not None:
            self.set(inner=inner)

    def _label(self) -> str:
        return self.get("stage_name") or type(self.get("inner")).__name__

    def _transform(self, table: Table) -> Table:
        inner: Transformer = self.get("inner")
        if self.get("disable"):
            return inner.transform(table)
        reg = self.metrics if self.metrics is not None else get_registry()
        tracer = self.tracer if self.tracer is not None else get_tracer()
        label = self._label()
        hist = reg.histogram(
            STAGE_SECONDS, "pipeline stage transform wall time",
            labels=("stage",)).labels(stage=label)
        rows = reg.counter(
            STAGE_ROWS, "rows through instrumented pipeline stages",
            labels=("stage",)).labels(stage=label)
        import time as _time

        t0 = _time.perf_counter()
        with tracer.start_span(f"stage:{label}", rows=table.num_rows):
            with hist.time():
                out = inner.transform(table)
        self.last_elapsed = _time.perf_counter() - t0
        rows.inc(table.num_rows)
        from ..core.logging import get_logger

        get_logger("timer").info(
            "%s.transform took %.4fs", label, self.last_elapsed)
        return out

    # nested-stage serialization (same contract as CircuitBreakerTransformer)
    def _save_state(self) -> dict[str, Any]:
        return {"inner": self.get("inner")}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(inner=state["inner"])

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("inner", None)
        return d


STAGE_RECORDED = "mmlspark_tpu_pipeline_stage_recorded_seconds"


@register_stage
class FlightRecorderTransformer(Transformer):
    """Wrap a transformer with a flight recorder: every transform appends
    a structured event (stage, rows, duration, trace_id) to a bounded
    per-stage ring, the stage latency histogram retains OpenMetrics
    exemplars linking buckets to trace ids, and an unhandled exception in
    the wrapped stage dumps the ring to `flight_recorder_dir` (atomic
    JSONL, `tools/diagnose.py --postmortem` loads it) before re-raising.

    `recorder` is an injectable attribute (like InstrumentedTransformer's
    `metrics`): pass a shared FlightRecorder to pool several stages into
    one ring, or leave None for a private ring sized by `ring_capacity` —
    live rings hold locks and belong to the process, not the saved stage.
    """

    inner = Param(None, "wrapped transformer stage", required=True)
    stage_name = Param(None, "event/series label (default: inner class name)",
                       ptype=str)
    flight_recorder_dir = Param(
        None, "directory triggered dumps land in (None: record only)",
        ptype=str)
    exemplars = Param(
        True, "retain OpenMetrics exemplars on the stage latency histogram",
        ptype=bool)
    ring_capacity = Param(
        4096, "flight-recorder ring bound (oldest events evicted)",
        ptype=int)
    tick_interval_s = Param(
        5.0, "coarse cadence of metric-delta snapshot events in the ring",
        ptype=float)

    recorder: "FlightRecorder | None" = None   # injectable; private default
    metrics: "MetricsRegistry | None" = None   # injectable; default registry
    tracer: "Tracer | None" = None             # injectable; default tracer

    def __init__(self, inner: "Transformer | None" = None, **kw):
        super().__init__(**kw)
        if inner is not None:
            self.set(inner=inner)

    def _label(self) -> str:
        return self.get("stage_name") or type(self.get("inner")).__name__

    def _recorder(self) -> FlightRecorder:
        if self.recorder is None:
            self.recorder = FlightRecorder(
                capacity=int(self.get("ring_capacity")),
                dump_dir=self.get("flight_recorder_dir"),
                process=f"stage-{self._label()}",
                tick_interval_s=float(self.get("tick_interval_s")))
        else:
            # params stay authoritative over a rebound shared recorder's
            # dump target so save/load round trips keep dumping
            if self.get("flight_recorder_dir") and not self.recorder.dump_dir:
                self.recorder.dump_dir = self.get("flight_recorder_dir")
        return self.recorder

    def _transform(self, table: Table) -> Table:
        inner: Transformer = self.get("inner")
        rec = self._recorder()
        reg = self.metrics if self.metrics is not None else get_registry()
        tracer = self.tracer if self.tracer is not None else get_tracer()
        label = self._label()
        hist = reg.histogram(
            STAGE_RECORDED, "recorded pipeline stage transform wall time",
            labels=("stage",), exemplars=bool(self.get("exemplars")))
        child = hist.labels(stage=label)
        import time as _time

        t0 = _time.perf_counter()
        with tracer.start_span(f"stage:{label}", rows=table.num_rows) as span:
            trace_id = getattr(span, "trace_id", 0)
            try:
                out = inner.transform(table)
            except Exception as e:
                rec.record("stage.exception", stage=label,
                           error=f"{type(e).__name__}: {e}",
                           trace_id=str(trace_id))
                rec.trigger_dump("exception", force=True, stage=label)
                raise
        elapsed = _time.perf_counter() - t0
        ex = ({"trace_id": format(trace_id, "032x")} if trace_id else None)
        child.observe(elapsed, exemplar=ex)
        rec.record("stage.transform", stage=label, rows=table.num_rows,
                   elapsed_s=elapsed, trace_id=str(trace_id))
        rec.maybe_tick(reg)
        return out

    # nested-stage serialization (same contract as InstrumentedTransformer)
    def _save_state(self) -> dict[str, Any]:
        return {"inner": self.get("inner")}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(inner=state["inner"])

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("inner", None)
        return d
