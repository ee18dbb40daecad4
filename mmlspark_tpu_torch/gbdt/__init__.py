"""Histogram GBDT on PyTorch and one H100 — the LightGBM-on-Spark equivalent.

Counterpart of mmlspark_tpu/gbdt. Quantile binning on the host (or on the
device), leaf-wise tree growth on device tensors with the histogram built by
a hand-written CUDA kernel (csrc/hist_kernel.cu), every objective and
multiclass, and a batched tree traversal for scoring (also fused with
binning: `Booster.device_predict_fn`).
"""

from .binning import BinMapper
from .sparse import CSRMatrix
from .booster import Booster, booster_from_arrays
from .estimators import (
    GBDTClassifier,
    GBDTClassificationModel,
    GBDTRegressor,
    GBDTRegressionModel,
    LightGBMClassifier,
    LightGBMRegressor,
)

__all__ = [
    "BinMapper",
    "CSRMatrix",
    "Booster",
    "booster_from_arrays",
    "GBDTClassifier",
    "GBDTClassificationModel",
    "GBDTRegressor",
    "GBDTRegressionModel",
    "LightGBMClassifier",
    "LightGBMRegressor",
]
