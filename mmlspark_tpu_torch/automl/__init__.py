"""AutoML layer of the port: evaluation metrics (reference
compute-model-statistics) and the featurize-then-fit trainers
(TrainClassifier, TrainRegressor). Tuning, model selection and
interpretation are later slices (ROADMAP.md, Queue 1)."""

from .metrics import (
    MetricConstants,
    ComputeModelStatistics,
    ComputePerInstanceStatistics,
    roc_curve,
    auc,
)
from .train import (
    TrainClassifier,
    TrainedClassifierModel,
    TrainRegressor,
    TrainedRegressorModel,
)

__all__ = ["MetricConstants", "ComputeModelStatistics", "ComputePerInstanceStatistics",
           "roc_curve", "auc", "TrainClassifier", "TrainedClassifierModel", "TrainRegressor",
           "TrainedRegressorModel"]
