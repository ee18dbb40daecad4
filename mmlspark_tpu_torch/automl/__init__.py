"""AutoML layer of the port: evaluation metrics so far (reference
compute-model-statistics). Auto-train, tuning, model selection and
interpretation are later slices (ROADMAP.md, Queue 1)."""

from .metrics import (
    MetricConstants,
    ComputeModelStatistics,
    ComputePerInstanceStatistics,
    roc_curve,
    auc,
)

__all__ = ["MetricConstants", "ComputeModelStatistics", "ComputePerInstanceStatistics",
           "roc_curve", "auc"]
