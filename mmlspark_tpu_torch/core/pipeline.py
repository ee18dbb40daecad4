"""Transformer / Estimator / Pipeline protocol.

Reference: Spark ML's Transformer/Estimator/PipelineModel as used throughout
eisber/mmlspark (every capability in SURVEY.md §2 is expressed as one), plus
`core/spark/NamespaceInjections.pipelineModel` (build a PipelineModel without
fitting — used by CognitiveServiceBase.scala:284).

A copy of mmlspark_tpu/core/pipeline.py: stages are plain Python objects
over `Table`s, eagerly transformed — no copy-on-write DataFrame plans.
"""

from __future__ import annotations

import time
from typing import Any, Sequence

from .params import Param, Params
from .schema import Table
from .serialize import register_stage, save_stage, load_stage

__all__ = [
    "PipelineStage",
    "Transformer",
    "Estimator",
    "Model",
    "Pipeline",
    "PipelineModel",
    "pipeline_model",
]


class PipelineStage(Params):
    """Base of Transformer and Estimator. Save/load via serialize.py."""

    def save(self, path: str) -> None:
        save_stage(self, path)

    @staticmethod
    def load(path: str) -> "PipelineStage":
        return load_stage(path)

    # Complex (non-JSON) state: subclasses override to persist fitted state.
    def _save_state(self) -> dict[str, Any]:
        return {}

    def _load_state(self, state: dict[str, Any]) -> None:
        pass


class Transformer(PipelineStage):
    def transform(self, table: Table) -> Table:
        self._check_required()
        return self._transform(table)

    def _transform(self, table: Table) -> Table:
        raise NotImplementedError

    def __call__(self, table: Table) -> Table:
        return self.transform(table)


class Estimator(PipelineStage):
    def fit(self, table: Table, params: dict[str, Any] | None = None) -> "Transformer":
        stage = self.copy(params) if params else self
        stage._check_required()
        return stage._fit(table)

    def _fit(self, table: Table) -> "Transformer":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""


@register_stage
class Pipeline(Estimator):
    """Sequence of stages; `fit` fits estimators in order, transforming the
    running table through each fitted stage (Spark ML Pipeline semantics)."""

    stages = Param(None, "list of pipeline stages", ptype=(list, tuple))

    def __init__(self, stages: Sequence[PipelineStage] | None = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))

    def _fit(self, table: Table) -> "PipelineModel":
        fitted: list[Transformer] = []
        current = table
        for stage in self.get("stages") or []:
            if isinstance(stage, Estimator):
                model = stage.fit(current)
            elif isinstance(stage, Transformer):
                model = stage
            else:
                raise TypeError(f"not a pipeline stage: {stage!r}")
            fitted.append(model)
            current = model.transform(current)
        return PipelineModel(fitted)

    def _save_state(self) -> dict[str, Any]:
        return {"stages": list(self.get("stages") or [])}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(stages=state["stages"])

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("stages", None)  # complex; persisted via _save_state
        return d


@register_stage
class PipelineModel(Model):
    stages = Param(None, "list of fitted transformer stages", ptype=(list, tuple))

    def __init__(self, stages: Sequence[Transformer] | None = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))

    def _transform(self, table: Table) -> Table:
        current = table
        for stage in self.get("stages") or []:
            current = stage.transform(current)
        return current

    def _save_state(self) -> dict[str, Any]:
        return {"stages": list(self.get("stages") or [])}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(stages=state["stages"])

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("stages", None)
        return d


def pipeline_model(*stages: Transformer) -> PipelineModel:
    """Build a PipelineModel without fitting (reference
    `NamespaceInjections.pipelineModel`, core/spark)."""
    return PipelineModel(list(stages))


@register_stage
class Timer(Transformer):
    """Wraps a stage and logs wall-clock transform time.

    Reference: pipeline-stages/src/main/scala/Timer.scala:55-124.
    """

    stage = Param(None, "wrapped transformer")
    disable = Param(False, "if true, skip timing", ptype=bool)

    last_elapsed: float | None = None  # class default so loaded stages have it
    #: per-segment device/host split when the wrapped stage is a fused
    #: pipeline (core/fusion.py), else None
    last_segments: list | None = None

    def __init__(self, stage: Transformer | None = None, **kw):
        super().__init__(**kw)
        if stage is not None:
            self.set(stage=stage)

    def _transform(self, table: Table) -> Table:
        inner: Transformer = self.get("stage")
        if self.get("disable"):
            return inner.transform(table)
        t0 = time.perf_counter()
        out = inner.transform(table)
        self.last_elapsed = time.perf_counter() - t0
        from .logging import get_logger

        log = get_logger("timer")
        log.info(
            "%s.transform took %.4fs", type(inner).__name__, self.last_elapsed
        )
        self.last_segments = self._segment_report(inner)
        for seg in self.last_segments or []:
            log.info(
                "  segment %s [%s] %s: %.4fs (device %.4fs, host %.4fs)",
                seg["segment"], seg["kind"], "+".join(seg["stages"]),
                seg["seconds"], seg["device_seconds"], seg["host_seconds"],
            )
        # also land the measurement in the process registry (lazy import:
        # observability's package init imports THIS module)
        try:
            from ..observability.metrics import get_registry

            reg = get_registry()
            reg.histogram(
                "mmlspark_tpu_pipeline_stage_seconds",
                "pipeline stage transform wall time",
                labels=("stage",)).labels(
                    stage=type(inner).__name__).observe(self.last_elapsed)
            for seg in self.last_segments or []:
                reg.histogram(
                    "mmlspark_tpu_pipeline_segment_seconds",
                    "fused-pipeline segment wall time by execution kind",
                    labels=("kind", "mesh_shape")).labels(
                        kind=seg["kind"],
                        mesh_shape=seg.get("mesh_shape", "1"),
                    ).observe(seg["seconds"])
        except Exception:
            pass
        return out

    @staticmethod
    def _segment_report(inner: Transformer) -> "list | None":
        """Device/host time split per fused-pipeline segment. Fused
        segments spend `prepare_seconds` on the host (slice/pad/upload);
        the rest of their wall time is device dispatch + read-back. Host
        segments (and host fallbacks) are all host time."""
        stats = getattr(inner, "last_stats", None)
        if not isinstance(stats, dict) or not stats.get("segments"):
            return None
        report = []
        for i, seg in enumerate(stats["segments"]):
            total = float(seg.get("seconds", 0.0))
            if seg.get("kind") == "fused":
                host = min(float(seg.get("prepare_seconds", 0.0)), total)
                device = total - host
            else:
                host, device = total, 0.0
            report.append({
                "segment": seg.get("segment", i), "kind": seg.get("kind"),
                "stages": list(seg.get("stages", [])), "seconds": total,
                "device_seconds": device, "host_seconds": host,
                "mesh_shape": seg.get("mesh_shape", "1"),
            })
        return report

    def _save_state(self) -> dict[str, Any]:
        return {"stage": self.get("stage")}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(stage=state["stage"])

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("stage", None)
        return d
