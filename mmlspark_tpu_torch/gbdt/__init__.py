"""Histogram GBDT on PyTorch and one H100 — the LightGBM-on-Spark equivalent.

Counterpart of mmlspark_tpu/gbdt. Quantile binning on the host, leaf-wise
tree growth on device tensors with the histogram built by a hand-written
CUDA kernel (csrc/hist_kernel.cu), and a batched tree traversal for scoring.
"""

from .binning import BinMapper
from .sparse import CSRMatrix
from .booster import Booster, booster_from_arrays
from .estimators import (
    GBDTClassifier,
    GBDTClassificationModel,
    LightGBMClassifier,
)

__all__ = [
    "BinMapper",
    "CSRMatrix",
    "Booster",
    "booster_from_arrays",
    "GBDTClassifier",
    "GBDTClassificationModel",
    "LightGBMClassifier",
]
