"""Model evaluation metrics for classification and regression.

Counterpart of mmlspark_tpu/automl/metrics.py. Reference:
`src/compute-model-statistics/ComputeModelStatistics.scala:57-467`
(confusion matrix, micro/macro metrics, binary ROC/AUC; rocCurve at :89),
metric names from `core/metrics/MetricConstants.scala:7-60`.

Metrics are small host reductions in numpy. The confusion matrix counts in
float32, as the JAX package's does with 64-bit mode off, so both report the
same accuracy bits; the regression metrics reduce in float32 for the same
reason. Ranking metrics are a later slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import SCORE_KIND, Table
from ..core.serialize import register_stage

__all__ = ["MetricConstants", "ComputeModelStatistics", "roc_curve", "auc"]


class MetricConstants:
    """Reference: core/metrics/MetricConstants.scala:7-60."""

    MSE = "mean_squared_error"
    RMSE = "root_mean_squared_error"
    R2 = "R^2"
    MAE = "mean_absolute_error"
    AUC = "AUC"
    ACCURACY = "accuracy"
    PRECISION = "precision"
    RECALL = "recall"
    NDCG = "ndcgAt"
    MAP = "map"
    MRR = "mrr"
    ALL = "all"

    CLASSIFICATION_METRICS = [AUC, ACCURACY, PRECISION, RECALL]
    REGRESSION_METRICS = [MSE, RMSE, R2, MAE]
    RANKING_METRICS = [NDCG, MAP, MRR, "precisionAtk", "recallAtK"]


def _confusion_matrix(labels: np.ndarray, preds: np.ndarray, num_classes: int) -> np.ndarray:
    idx = labels.astype(np.int64) * num_classes + preds.astype(np.int64)
    counts = np.zeros(num_classes * num_classes, np.float32)
    np.add.at(counts, idx, np.float32(1.0))
    return counts.reshape(num_classes, num_classes)


def _regression_metrics(labels: np.ndarray, preds: np.ndarray):
    """(mse, rmse, r2, mae) in float32, as the JAX package's jitted
    reduction computes them with 64-bit mode off."""
    labels = np.asarray(labels, np.float32)
    err = np.asarray(preds, np.float32) - labels
    mse = np.mean(err * err, dtype=np.float32)
    mae = np.mean(np.abs(err), dtype=np.float32)
    ss_res = np.sum(err * err, dtype=np.float32)
    ss_tot = np.sum(np.square(labels - np.mean(labels, dtype=np.float32)), dtype=np.float32)
    r2 = np.float32(1.0) - ss_res / (np.float32(1.0) if ss_tot == 0 else ss_tot)
    return mse, np.sqrt(mse), r2, mae


def roc_curve(labels: np.ndarray, scores: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds), computed by a sort + cumulative sums.
    Reference rocCurve ComputeModelStatistics.scala:89."""
    labels = np.asarray(labels, np.float64)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind="stable")
    y = labels[order]
    s = scores[order]
    tps = np.cumsum(y)
    fps = np.cumsum(1.0 - y)
    # keep last index of each distinct threshold
    distinct = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps, fps, thr = tps[distinct], fps[distinct], s[distinct]
    p = labels.sum()
    n = labels.size - p
    tpr = np.r_[0.0, tps / max(p, 1.0)]
    fpr = np.r_[0.0, fps / max(n, 1.0)]
    return fpr, tpr, np.r_[np.inf, thr]


_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2 fallback


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(labels, scores)
    return float(_trapezoid(tpr, fpr))


@register_stage
class ComputeModelStatistics(Transformer):
    """Emit a one-row metrics table for a classifier- or regressor-scored
    dataset."""

    label_col = Param("label", "true-label column", ptype=str)
    scores_col = Param(None, "raw score / probability column (binary)", ptype=str)
    scored_labels_col = Param("scored_labels", "predicted-label column", ptype=str)
    evaluation_metric = Param("all", "classification | regression | ranking "
                              "| all | <metric>", ptype=str)
    k = Param(10, "ranking cutoff for the @k metrics", ptype=int)

    # most recent confusion matrix (reference keeps it as a side output)
    confusion_matrix: np.ndarray | None = None

    def _transform(self, table: Table) -> Table:
        metric = self.get("evaluation_metric")
        if metric in MetricConstants.RANKING_METRICS + ["ranking"]:
            raise NotImplementedError(
                "ranking metrics are not ported yet; see ROADMAP.md Queue 1, "
                "'recommendation and AutoML'")
        labels = np.asarray(table[self.get("label_col")], np.float64)
        if self._infer_is_classification(table, labels, metric):
            return self._classification(table, labels)
        return self._regression(table, labels)

    def _infer_is_classification(self, table: Table, labels: np.ndarray, metric: str) -> bool:
        if metric in MetricConstants.CLASSIFICATION_METRICS + ["classification"]:
            return True
        if metric in MetricConstants.REGRESSION_METRICS + ["regression"]:
            return False
        # a probability/raw_prediction score column marks classifier output
        # (GBDTClassificationModel tags columns with SCORE_KIND)
        has_prob = any(
            table.meta(c).get(SCORE_KIND) in ("probability", "raw_prediction")
            for c in table.columns
        )
        if self.get("scored_labels_col") not in table:
            if has_prob:
                raise ValueError(
                    f"table looks classifier-scored but scored_labels_col="
                    f"{self.get('scored_labels_col')!r} is absent; available "
                    f"columns: {table.columns}"
                )
            return False
        if has_prob:
            return True
        labels_kind = table.meta(self.get("scored_labels_col")).get(SCORE_KIND)
        if labels_kind == "predicted_label":
            return True
        if labels_kind == "prediction":
            return False
        # all integral labels with few distinct values -> classification
        return bool(
            np.all(labels == np.round(labels)) and np.unique(labels).size <= 100
        )

    def _classification(self, table: Table, labels: np.ndarray) -> Table:
        preds = np.asarray(table[self.get("scored_labels_col")], np.float64)
        # remap arbitrary label values (negative, sparse, large) to dense ids
        classes, remapped = np.unique(np.concatenate([labels, preds]), return_inverse=True)
        num_classes = int(classes.size) if classes.size else 1
        lab_ids = remapped[: labels.size]
        pred_ids = remapped[labels.size :]
        cm = _confusion_matrix(lab_ids, pred_ids, num_classes)
        self.confusion_matrix = cm
        total = cm.sum()
        tp_per_class = np.diag(cm)
        accuracy = tp_per_class.sum() / max(total, 1.0)
        # micro precision == micro recall == accuracy for single-label
        with np.errstate(divide="ignore", invalid="ignore"):
            prec_c = np.where(cm.sum(0) > 0, tp_per_class / cm.sum(0), 0.0)
            rec_c = np.where(cm.sum(1) > 0, tp_per_class / cm.sum(1), 0.0)
        row: dict[str, Any] = {
            MetricConstants.ACCURACY: float(accuracy),
            "macro_precision": float(prec_c.mean()),
            "macro_recall": float(rec_c.mean()),
        }
        if num_classes == 2:
            row[MetricConstants.PRECISION] = float(prec_c[1])
            row[MetricConstants.RECALL] = float(rec_c[1])
        scores_col = self.get("scores_col")
        if not scores_col and num_classes == 2:
            # schema sniffing (reference MetricUtils): a SCORE_KIND-tagged
            # binary-shaped probability column stands in for scores_col
            def _binary_shaped(c):
                arr = table[c]
                return isinstance(arr, np.ndarray) and (
                    arr.ndim == 1 or (arr.ndim == 2 and arr.shape[1] == 2)
                )

            scores_col = next(
                (c for c in table.columns
                 if table.meta(c).get(SCORE_KIND) == "probability"
                 and _binary_shaped(c)), None)
        if scores_col and scores_col in table and num_classes == 2:
            scores = np.asarray(table[scores_col], np.float64)
            if scores.ndim == 2:
                scores = scores[:, -1]
            # positive class = larger label value = class id 1 after remap
            row[MetricConstants.AUC] = auc(lab_ids.astype(np.float64), scores)
        return Table.from_rows([row])

    def _regression(self, table: Table, labels: np.ndarray) -> Table:
        pred_col = self.get("scores_col") or self.get("scored_labels_col")
        preds = np.asarray(table[pred_col], np.float64)
        mse, rmse, r2, mae = (float(v) for v in _regression_metrics(labels, preds))
        return Table.from_rows([{
            MetricConstants.MSE: mse,
            MetricConstants.RMSE: rmse,
            MetricConstants.R2: r2,
            MetricConstants.MAE: mae,
        }])
