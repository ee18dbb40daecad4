"""GBDT pipeline stages: the LightGBMClassifier and LightGBMRegressor surface.

Counterpart of mmlspark_tpu/gbdt/estimators.py. Reference:
src/lightgbm/src/main/scala/LightGBMClassifier.scala:27-158,
LightGBMRegressor.scala:38-156 and LightGBMParams.scala:11-149 (shared
params). The Params keep the JAX package's names (the reference's
spelling) and gain `device`, the torch device of the fit, "cuda" by
default. `model_string` warm-starts from a model's JSON text, and
`validation_fraction` with `early_stopping_round` holds out a seeded share
of the rows for early stopping, and `categorical_slot_indexes` names the
feature slots split as category subsets. A Param value the port does not
run yet (checkpoints, the mesh, elastic workers; see booster.py) raises
NotImplementedError at fit time naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.params import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasWeightCol,
    Param,
)
from ..core.pipeline import Estimator, Model
from ..core.schema import SCORE_KIND, Table
from ..core.serialize import register_stage
from .booster import Booster, TrainOptions, _not_ported
from .sparse import as_features

__all__ = [
    "GBDTClassifier",
    "GBDTClassificationModel",
    "GBDTRegressor",
    "GBDTRegressionModel",
    "LightGBMClassifier",
    "LightGBMRegressor",
]


def _features_from(table: Table, col: str):
    """Features column -> float64 ndarray, or CSRMatrix when the column holds
    a sparse matrix (the SparseVector-dataset path, LightGBMUtils.scala:358-394)."""
    return as_features(table[col])


class _GBDTParams(HasFeaturesCol, HasLabelCol, HasWeightCol, HasPredictionCol):
    """Shared training params (reference LightGBMParams.scala:11-149)."""

    boosting_type = Param("gbdt", "gbdt|rf|dart|goss", ptype=str)
    num_iterations = Param(100, "number of boosting rounds", ptype=int)
    learning_rate = Param(0.1, "shrinkage rate", ptype=float)
    num_leaves = Param(31, "max leaves per tree", ptype=int)
    max_bin = Param(255, "max histogram bins per feature", ptype=int)
    max_depth = Param(-1, "max tree depth (<=0 unlimited)", ptype=int)
    min_data_in_leaf = Param(20, "min rows per leaf", ptype=int)
    min_sum_hessian_in_leaf = Param(1e-3, "min hessian sum per leaf", ptype=float)
    lambda_l1 = Param(0.0, "L1 regularization", ptype=float)
    lambda_l2 = Param(0.0, "L2 regularization", ptype=float)
    min_gain_to_split = Param(0.0, "min split gain", ptype=float)
    bagging_fraction = Param(1.0, "row subsample fraction", ptype=float)
    bagging_freq = Param(0, "bagging frequency (0=off)", ptype=int)
    bagging_seed = Param(3, "bagging rng seed", ptype=int)
    feature_fraction = Param(1.0, "feature subsample fraction per tree", ptype=float)
    early_stopping_round = Param(0, "stop if no val improvement for N rounds", ptype=int)
    validation_fraction = Param(0.0, "fraction of rows held out for early stopping", ptype=float)
    categorical_slot_indexes = Param((), "indexes of categorical feature slots", ptype=(list, tuple))
    bin_dtype = Param("int32", "device bin-matrix dtype: int32 | uint8 (4x fewer bytes per histogram pass)", ptype=str)
    device_binning = Param(False, "bin the training matrix on the fit's device (float32 compare; boundaries snapped through float32)", ptype=bool)
    bin_construct_sample_cnt = Param(200_000, "rows sampled per column for bin-boundary construction (0 = all)", ptype=int)
    cat_smooth = Param(10.0, "categorical smoothing for the sorted-subset split order", ptype=float)
    cat_l2 = Param(10.0, "extra L2 regularization on categorical splits", ptype=float)
    max_cat_threshold = Param(32, "max categories on the smaller side of a categorical split", ptype=int)
    model_string = Param(None, "warm-start model text (reference modelString)", ptype=str)
    boost_from_average = Param(True, "init score from label average", ptype=bool)
    use_mesh = Param(False, "shard rows over several devices (not ported yet)", ptype=bool)
    tree_learner = Param(
        "data_parallel", "data_parallel | voting_parallel (LightGBMParams.scala:12-14)",
        ptype=str,
    )
    top_k = Param(20, "voting-parallel local candidate count", ptype=int)
    deterministic = Param(
        False, "bit-exact histogram merge (LightGBM's deterministic flag); "
        "a one-device fit is exact already", ptype=bool,
    )
    verbosity = Param(1, "logging verbosity", ptype=int)
    seed = Param(0, "master rng seed", ptype=int)
    checkpoint_dir = Param(None, "snapshot directory for preemption-tolerant training (not ported yet)", ptype=str)
    checkpoint_every_n = Param(0, "boosting rounds between snapshots (0 = off)", ptype=int)
    elastic_workers = Param(0, "fit over N elastic fleet workers (not ported yet)", ptype=int)
    elastic_num_virtual = Param(32, "virtual shards for the elastic fit", ptype=int)
    device = Param("cuda", "torch device of the fit: cuda | cpu", ptype=str)

    def _train_options(self, objective: str, num_class: int = 1) -> TrainOptions:
        if self.get("use_mesh") or int(self.get("elastic_workers") or 0) > 0:
            raise _not_ported("use_mesh / elastic_workers", "distributed GBDT")
        init_model = None
        if self.get("model_string"):
            init_model = Booster.from_text(self.get("model_string"), device=self.get("device"))
        return TrainOptions(
            objective=objective,
            boosting_type=self.get("boosting_type"),
            num_iterations=self.get("num_iterations"),
            learning_rate=self.get("learning_rate"),
            num_leaves=self.get("num_leaves"),
            max_bin=self.get("max_bin"),
            max_depth=self.get("max_depth"),
            min_data_in_leaf=self.get("min_data_in_leaf"),
            min_sum_hessian_in_leaf=self.get("min_sum_hessian_in_leaf"),
            lambda_l1=self.get("lambda_l1"),
            lambda_l2=self.get("lambda_l2"),
            min_gain_to_split=self.get("min_gain_to_split"),
            bagging_fraction=self.get("bagging_fraction"),
            bagging_freq=self.get("bagging_freq"),
            bagging_seed=self.get("bagging_seed"),
            feature_fraction=self.get("feature_fraction"),
            early_stopping_round=self.get("early_stopping_round"),
            categorical_indexes=tuple(self.get("categorical_slot_indexes") or ()),
            bin_dtype=self.get("bin_dtype"),
            device_binning=self.get("device_binning"),
            bin_construct_sample_cnt=self.get("bin_construct_sample_cnt"),
            cat_smooth=self.get("cat_smooth"),
            cat_l2=self.get("cat_l2"),
            max_cat_threshold=self.get("max_cat_threshold"),
            tree_learner=self.get("tree_learner"),
            top_k=self.get("top_k"),
            deterministic=self.get("deterministic"),
            num_class=num_class,
            boost_from_average=self.get("boost_from_average"),
            init_model=init_model,
            checkpoint_dir=self.get("checkpoint_dir"),
            checkpoint_every_n=self.get("checkpoint_every_n"),
            seed=self.get("seed"),
            device=self.get("device"),
        )

    def _fit_arrays(self, table: Table):
        x = _features_from(table, self.get("features_col"))
        if getattr(x, "ndim", 2) == 1:
            x = x[:, None]
        y = np.asarray(table[self.get("label_col")], dtype=np.float64)
        w = None
        wc = self.get("weight_col")
        if wc:
            w = np.asarray(table[wc], dtype=np.float64)
        valid = None
        vf = self.get("validation_fraction") or 0.0
        if vf > 0 and self.get("early_stopping_round"):
            # the held-out rows: a permutation from the master seed
            # (reference estimators.py:197-209)
            perm = np.random.default_rng(self.get("seed")).permutation(len(x))
            cut = int(round(vf * len(x)))
            vi, ti = perm[:cut], perm[cut:]
            valid = (x[vi], y[vi])
            x, y = x[ti], y[ti]
            if w is not None:
                w = w[ti]
        return x, y, w, valid

    def _log(self):
        if self.get("verbosity") and self.get("verbosity") > 0:
            from ..core.logging import get_logger

            return get_logger(type(self).__name__).info
        return None


class _BoosterModelMixin:
    """Fitted-model persistence and placement."""

    def _save_state(self) -> dict[str, Any]:
        return {"booster_text": self.booster.to_text()}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.booster = Booster.from_text(state["booster_text"])

    def save_native_model(self, path: str, format: str = "json") -> None:
        """Reference: LightGBMClassificationModel.saveNativeModel
        (LightGBMClassifier.scala:148-151)."""
        self.booster.save_native_model(path, format=format)

    def to(self, device: str):
        """Score on `device` from now on (PyTorch's idiom; returns self). A
        loaded model holds "cuda" until moved."""
        self.booster = self.booster.to(device)
        return self

    def get_feature_importances(self, importance_type: str = "split") -> list[float]:
        return list(self.booster.feature_importances(importance_type))


@register_stage
class GBDTClassifier(_GBDTParams, Estimator):
    """Histogram-GBDT classifier (reference LightGBMClassifier,
    src/lightgbm/src/main/scala/LightGBMClassifier.scala:27-94)."""

    raw_prediction_col = Param("raw_prediction", "margin scores output column", ptype=str)
    probability_col = Param("probability", "probability output column", ptype=str)
    is_unbalance = Param(False, "reweight classes by inverse frequency", ptype=bool)
    objective = Param("binary", "binary|multiclass (auto-upgraded by label arity)", ptype=str)

    def _fit(self, table: Table) -> "GBDTClassificationModel":
        x, y, w, valid = self._fit_arrays(table)
        # the class set spans the training and the held-out labels, so a
        # class seen only in the held-out rows still gets its own index
        classes = np.unique(y if valid is None else np.concatenate([y, valid[1]]))
        y_idx = np.searchsorted(classes, y).astype(np.float64)
        if valid is not None:
            valid = (valid[0], np.searchsorted(classes, valid[1]).astype(np.float64))
        num_class = len(classes)
        if self.is_set("objective"):
            objective = self.get("objective")
            if objective == "binary" and num_class > 2:
                raise ValueError(f"objective='binary' but {num_class} classes found")
        else:
            objective = "binary" if num_class <= 2 else "multiclass"
        opts = self._train_options(objective, num_class=num_class)
        opts.is_unbalance = self.get("is_unbalance")
        booster = Booster.train(x, y_idx, opts, weights=w, valid=valid, log=self._log())
        booster.class_labels = [float(c) for c in classes]
        model = GBDTClassificationModel(
            features_col=self.get("features_col"),
            prediction_col=self.get("prediction_col"),
            raw_prediction_col=self.get("raw_prediction_col"),
            probability_col=self.get("probability_col"),
        )
        model.booster = booster
        model.classes = classes
        return model


@register_stage
class GBDTClassificationModel(_BoosterModelMixin, HasFeaturesCol, HasPredictionCol, Model):
    """Reference: LightGBMClassificationModel (LightGBMClassifier.scala:98-158)
    — scoring is one batched traversal on the booster's device (host walk
    for small batches), not per-row calls."""

    raw_prediction_col = Param("raw_prediction", "margin scores output column", ptype=str)
    probability_col = Param("probability", "probability output column", ptype=str)

    booster: Booster | None = None
    classes: np.ndarray | None = None

    def _transform(self, table: Table) -> Table:
        x = _features_from(table, self.get("features_col"))
        if getattr(x, "ndim", 2) == 1:
            x = x[:, None]
        # one bin+traverse pass: both output columns derive from the margins
        raw = self.booster.predict_raw(x)
        prob = self.booster.transform_score(raw)
        if raw.ndim == 1:  # binary: present as (n, 2) like the reference
            prob2 = np.stack([1.0 - prob, prob], axis=1)
            raw2 = np.stack([-raw, raw], axis=1)
            idx = (prob >= 0.5).astype(int)
        else:
            prob2, raw2 = prob, raw
            idx = np.argmax(prob, axis=1)
        labels = self.classes[idx] if self.classes is not None else idx
        out = table.with_column(
            self.get("raw_prediction_col"), raw2, meta={SCORE_KIND: "raw_prediction"}
        )
        cls_meta = None if self.classes is None else [float(c) for c in self.classes]
        out = out.with_column(
            self.get("probability_col"),
            prob2,
            meta={SCORE_KIND: "probability", "class_labels": cls_meta},
        )
        # "predicted_label" (not "prediction") so metrics inference can tell
        # classifier output from regressor output
        return out.with_column(
            self.get("prediction_col"),
            labels.astype(np.float64),
            meta={SCORE_KIND: "predicted_label"},
        )

    def _save_state(self) -> dict[str, Any]:
        st = _BoosterModelMixin._save_state(self)
        st["classes"] = None if self.classes is None else self.classes.tolist()
        return st

    def _load_state(self, state: dict[str, Any]) -> None:
        _BoosterModelMixin._load_state(self, state)
        self.classes = None if state.get("classes") is None else np.asarray(state["classes"])

    @staticmethod
    def load_native_model(path: str, device: str = "cuda", **cols) -> "GBDTClassificationModel":
        """Reference: LightGBMClassificationModel.loadNativeModelFromFile
        (LightGBMClassifier.scala:160-184), for the JSON format."""
        booster = Booster.load_native_model(path, device=device)
        model = GBDTClassificationModel(**cols)
        model.booster = booster
        if booster.class_labels is not None:
            model.classes = np.asarray(booster.class_labels, np.float64)
        else:
            k = booster.num_class if booster.num_class > 1 else 2
            model.classes = np.arange(k, dtype=np.float64)
        return model


@register_stage
class GBDTRegressor(_GBDTParams, Estimator):
    """Reference: LightGBMRegressor (LightGBMRegressor.scala:38-101) with the
    full objective set of :17-36."""

    objective = Param(
        "regression",
        "regression|l1|l2|huber|fair|poisson|quantile|mape|gamma|tweedie",
        ptype=str,
    )
    alpha = Param(0.9, "huber/quantile alpha", ptype=float)
    tweedie_variance_power = Param(1.5, "tweedie variance power (1..2)", ptype=float)
    fair_c = Param(1.0, "fair-loss c", ptype=float)

    def _fit(self, table: Table) -> "GBDTRegressionModel":
        x, y, w, valid = self._fit_arrays(table)
        opts = self._train_options(self.get("objective"))
        opts.alpha = self.get("alpha")
        opts.tweedie_variance_power = self.get("tweedie_variance_power")
        opts.fair_c = self.get("fair_c")
        booster = Booster.train(x, y, opts, weights=w, valid=valid, log=self._log())
        model = GBDTRegressionModel(
            features_col=self.get("features_col"),
            prediction_col=self.get("prediction_col"),
        )
        model.booster = booster
        return model


@register_stage
class GBDTRegressionModel(_BoosterModelMixin, HasFeaturesCol, HasPredictionCol, Model):
    """Reference: LightGBMRegressionModel (LightGBMRegressor.scala:103-156)."""

    booster: Booster | None = None

    def _transform(self, table: Table) -> Table:
        x = _features_from(table, self.get("features_col"))
        if getattr(x, "ndim", 2) == 1:
            x = x[:, None]
        pred = self.booster.predict(x)
        return table.with_column(
            self.get("prediction_col"), np.asarray(pred, np.float64),
            meta={SCORE_KIND: "prediction"})

    def device_kernel(self):
        """The pipeline fusion engine's kernel (core/fusion.py) comes with
        ROADMAP Queue 1's GBDT-serving item; the fused bin -> traverse
        program it wraps is `Booster.device_predict_fn`."""
        raise _not_ported("GBDTRegressionModel.device_kernel (pipeline fusion)",
                          "P3: GBDT serving")

    def native_score_fn(self):
        """Host-side scorer for a serving hot path: `fn(x) -> float64
        predictions` on the native host walk, with no device dispatch.
        Bit-identical to `_transform`'s column (the host walk adds in the
        traversal's float32 order, and the regression objectives'
        transform is the identity or exp). Returns a reason string when
        there is no fitted booster."""
        b = self.booster
        if b is None:
            return "no fitted booster"

        def fn(x: np.ndarray) -> np.ndarray:
            if getattr(x, "ndim", 2) == 1:
                x = x[:, None]
            return np.asarray(b.predict(x, device="host"), np.float64)

        return fn

    @staticmethod
    def load_native_model(path: str, device: str = "cuda", **cols) -> "GBDTRegressionModel":
        """Reference: LightGBMRegressionModel.loadNativeModelFromFile, for
        the JSON format."""
        model = GBDTRegressionModel(**cols)
        model.booster = Booster.load_native_model(path, device=device)
        return model


# Drop-in familiar names for reference users.
LightGBMClassifier = GBDTClassifier
LightGBMRegressor = GBDTRegressor
