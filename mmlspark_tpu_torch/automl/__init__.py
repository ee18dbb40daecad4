"""AutoML layer of the port: evaluation metrics (reference
compute-model-statistics, ranking metrics included), the
featurize-then-fit trainers (TrainClassifier, TrainRegressor),
hyperparameter search (TuneHyperparameters over grid and random spaces),
model selection (FindBestModel), the preemptible hyperband sweep over a
fleet of worker processes (SweepScheduler) and interpretation (superpixels,
ImageLIME)."""

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
from .tune import (
    DiscreteHyperParam,
    RangeHyperParam,
    HyperparamBuilder,
    GridSpace,
    RandomSpace,
    TuneHyperparameters,
    TuneHyperparametersModel,
    DefaultHyperparams,
)
from .find_best import FindBestModel, BestModel
from .sweep import (
    HyperbandPruner,
    SweepScheduler,
    SweepResult,
    SweepWorkerFactory,
    SweepModelFactory,
)
from .lime import superpixels, SuperpixelTransformer, ImageLIME

__all__ = ["MetricConstants", "ComputeModelStatistics", "ComputePerInstanceStatistics",
           "roc_curve", "auc", "TrainClassifier", "TrainedClassifierModel", "TrainRegressor",
           "TrainedRegressorModel", "DiscreteHyperParam", "RangeHyperParam",
           "HyperparamBuilder", "GridSpace", "RandomSpace", "TuneHyperparameters",
           "TuneHyperparametersModel", "DefaultHyperparams", "FindBestModel", "BestModel",
           "HyperbandPruner", "SweepScheduler", "SweepResult", "SweepWorkerFactory",
           "SweepModelFactory", "superpixels", "SuperpixelTransformer", "ImageLIME"]
