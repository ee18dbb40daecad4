"""AutoML train wrappers: TrainClassifier / TrainRegressor.

Reference: src/train/ — `TrainClassifier` (TrainClassifier.scala:50-276:
label reindex :20-47, featurize → fit, model + featurizer saved together),
`TrainedClassifierModel` (:278-376), `TrainRegressor`/`TrainedRegressorModel`
(TrainRegressor.scala:21-180), `AutoTrainer` (AutoTrainer.scala:12+).

A copy of mmlspark_tpu/automl/train.py. The inner estimator's Params, its
`device` among them, pass through to the fit untouched.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.params import HasLabelCol, Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import SCORE_KIND, Table, host_array
from ..core.serialize import register_stage, stage_from_blob, stage_to_blob
from ..ops.featurize import Featurize

__all__ = [
    "TrainClassifier",
    "TrainedClassifierModel",
    "TrainRegressor",
    "TrainedRegressorModel",
]


class _AutoTrainer(HasLabelCol, Estimator):
    """Shared featurize-then-fit logic (reference AutoTrainer.scala:12+)."""

    model = Param(None, "inner estimator to train", required=True)
    features_col = Param("features", "assembled features column", ptype=str)
    number_of_features = Param(None, "hash buckets for featurization", ptype=int)

    def _featurize(self, table: Table, feature_inputs: list[str]):
        kw: dict[str, Any] = {
            "feature_columns": {self.get("features_col"): feature_inputs}
        }
        if self.get("number_of_features"):
            kw["number_of_features"] = self.get("number_of_features")
        return Featurize(**kw).fit(table)

    def _feature_inputs(self, table: Table) -> list[str]:
        label = self.get("label_col")
        return [c for c in table.columns if c != label]

    def _inner_estimator(self) -> Estimator:
        est = self.get("model")
        if not isinstance(est, Estimator):
            raise TypeError("model param must be an Estimator")
        return est

    def _save_state(self) -> dict[str, Any]:
        return {"model": self.get("model")}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(model=state["model"])

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("model", None)
        return d


@register_stage
class TrainClassifier(_AutoTrainer):
    """Featurize + label-reindex + fit (TrainClassifier.scala:50-276)."""

    reindex_label = Param(True, "reindex labels to [0, K)", ptype=bool)

    def _fit(self, table: Table) -> "TrainedClassifierModel":
        label_col = self.get("label_col")
        feats = self._feature_inputs(table)
        featurizer = self._featurize(table, feats)
        featurized = featurizer.transform(table)

        labels_raw = table[label_col]
        levels: list | None = None
        if self.get("reindex_label"):
            vals = [v.item() if isinstance(v, np.generic) else v for v in labels_raw]
            levels = sorted(set(vals))
            lookup = {v: i for i, v in enumerate(levels)}
            y = np.asarray([lookup[v] for v in vals], np.float64)
            featurized = featurized.with_column(label_col, y)

        inner = self._inner_estimator().copy(
            {"features_col": self.get("features_col"), "label_col": label_col}
        )
        fitted = inner.fit(featurized)

        out = TrainedClassifierModel(
            label_col=label_col, features_col=self.get("features_col")
        )
        out.featurizer = featurizer
        out.inner_model = fitted
        out.levels = levels
        return out


@register_stage
class TrainedClassifierModel(HasLabelCol, Model):
    """Featurizer + fitted model + label decode
    (TrainClassifier.scala:278-376)."""

    features_col = Param("features", "assembled features column", ptype=str)

    featurizer: Transformer | None = None
    inner_model: Transformer | None = None
    levels: list | None = None

    def _transform(self, table: Table) -> Table:
        featurized = self.featurizer.transform(table)
        scored = self.inner_model.transform(featurized)
        if self.levels is not None and "prediction" in scored:
            idx = host_array(scored["prediction"]).astype(int)
            idx = np.clip(idx, 0, len(self.levels) - 1)
            decoded = np.asarray([self.levels[i] for i in idx])
            scored = scored.with_column(
                "prediction", decoded, meta={SCORE_KIND: "predicted_label"}
            )
        # drop the intermediate assembled features (reference drops them too)
        if self.get("features_col") in scored:
            scored = scored.drop(self.get("features_col"))
        return scored

    def _save_state(self) -> dict[str, Any]:
        return {
            "featurizer": stage_to_blob(self.featurizer),
            "inner_model": stage_to_blob(self.inner_model),
            "levels": self.levels,
        }

    def _load_state(self, state: dict[str, Any]) -> None:
        self.featurizer = stage_from_blob(state["featurizer"])
        self.inner_model = stage_from_blob(state["inner_model"])
        self.levels = state.get("levels")


@register_stage
class TrainRegressor(_AutoTrainer):
    """Reference: TrainRegressor.scala:21-106."""

    def _fit(self, table: Table) -> "TrainedRegressorModel":
        label_col = self.get("label_col")
        featurizer = self._featurize(table, self._feature_inputs(table))
        featurized = featurizer.transform(table)
        inner = self._inner_estimator().copy(
            {"features_col": self.get("features_col"), "label_col": label_col}
        )
        fitted = inner.fit(featurized)
        out = TrainedRegressorModel(
            label_col=label_col, features_col=self.get("features_col")
        )
        out.featurizer = featurizer
        out.inner_model = fitted
        return out


@register_stage
class TrainedRegressorModel(TrainedClassifierModel):
    """Reference: TrainRegressor.scala:108-180."""

    levels = None
