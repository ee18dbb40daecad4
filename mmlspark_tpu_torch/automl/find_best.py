"""FindBestModel — model selection over already-trained models.

Reference: src/find-best-model/ — `FindBestModel` (FindBestModel.scala:
51-148: evaluates N fitted models on an eval dataset, picks by metric),
`BestModel` (:149-195: exposes the scored dataset, ROC DataFrame, and
per-model metrics).

A copy of mmlspark_tpu/automl/find_best.py (host only): each candidate
scores on its own device, and `ComputeModelStatistics` reduces on the host.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.params import HasLabelCol, Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.serialize import register_stage
from ..core.schema import Table
from .metrics import ComputeModelStatistics, MetricConstants
from .tune import _MAXIMIZE

__all__ = ["FindBestModel", "BestModel"]


@register_stage
class FindBestModel(HasLabelCol, Estimator):
    models = Param(None, "list of FITTED transformers to compare", required=True)
    evaluation_metric = Param("accuracy", "metric to rank by", ptype=str)

    def _save_state(self):
        return {"models": list(self.get("models"))}

    def _load_state(self, state):
        self.set(models=state["models"])

    def params_to_dict(self):
        d = dict(self._values)
        d.pop("models", None)
        return d

    _KNOWN_METRICS = tuple(MetricConstants.CLASSIFICATION_METRICS
                           + MetricConstants.REGRESSION_METRICS)

    def _fit(self, table: Table) -> "BestModel":
        models: list[Transformer] = self.get("models")
        metric = self.get("evaluation_metric")
        # validate the metric BEFORE scoring: a typo'd name must not cost
        # N full model evaluations before the KeyError lands
        if metric not in self._KNOWN_METRICS:
            raise ValueError(
                f"evaluation_metric {metric!r} is not rankable; choose one "
                f"of {sorted(self._KNOWN_METRICS)}")
        maximize = metric in _MAXIMIZE
        stats = ComputeModelStatistics(
            label_col=self.get("label_col"), scored_labels_col="prediction"
        )
        rows = []
        scoreds = []
        for m in models:
            scored = m.transform(table)
            scoreds.append(scored)
            row = stats.transform(scored)
            if metric not in row:
                raise KeyError(f"metric {metric!r} not in {row.columns}")
            rows.append({c: np.asarray(row[c])[0] for c in row.columns})
        values = np.asarray([float(r[metric]) for r in rows], np.float64)
        # NaN metrics never win: np.argmax/argmin over a NaN-containing
        # array returns the NaN's index, silently selecting a garbage
        # model. Skip them with a warning; only an all-NaN board raises.
        finite = ~np.isnan(values)
        if not finite.any():
            raise ValueError(
                f"every candidate scored NaN on {metric!r}; no model is "
                "selectable")
        if not finite.all():
            import warnings

            bad = [i for i, ok in enumerate(finite) if not ok]
            warnings.warn(
                f"skipping {len(bad)} model(s) with NaN {metric!r} "
                f"(indexes {bad})", stacklevel=2)
        masked = np.where(finite, values,
                          -np.inf if maximize else np.inf)
        best = int(np.argmax(masked) if maximize else np.argmin(masked))
        out = BestModel()
        out.best_model = models[best]
        out.best_model_metrics = rows[best]
        out.all_model_metrics = rows
        out.scored_dataset = scoreds[best]
        out._label_col = self.get("label_col")
        return out


@register_stage
class BestModel(Model):
    """Reference: FindBestModel.scala:149-195."""

    best_model: Transformer | None = None
    best_model_metrics: dict[str, Any] = {}
    all_model_metrics: list = []
    scored_dataset: Table | None = None
    _label_col: str = "label"

    def _transform(self, table: Table) -> Table:
        return self.best_model.transform(table)

    def get_roc_curve(self):
        """(fpr, tpr, thresholds) on the eval scoring (BestModel.getRocCurve)."""
        from .metrics import roc_curve

        t = self.scored_dataset
        if t is None:
            raise ValueError("no scored dataset (load() drops it)")
        scores_col = "probability" if "probability" in t else "prediction"
        scores = np.asarray(t[scores_col], np.float64)
        if scores.ndim == 2:
            scores = scores[:, -1]
        return roc_curve(np.asarray(t[self._label_col], np.float64), scores)

    def _save_state(self) -> dict[str, Any]:
        from ..core.serialize import stage_to_blob

        return {
            "best_model": stage_to_blob(self.best_model),
            "best_model_metrics": {
                k: float(v) for k, v in self.best_model_metrics.items()
                if isinstance(v, (int, float, np.floating, np.integer))
            },
        }

    def _load_state(self, state: dict[str, Any]) -> None:
        from ..core.serialize import stage_from_blob

        self.best_model = stage_from_blob(state["best_model"])
        self.best_model_metrics = state.get("best_model_metrics", {})
