"""Boosting objectives: gradients/hessians of the training losses.

Counterpart of mmlspark_tpu/gbdt/objectives.py. Reference: the objective
strings accepted by the native learner (src/lightgbm/src/main/scala/
TrainParams.scala:40-74). Each objective is an elementwise torch function
of (label, raw_score) on the fit's device and returns (grad, hess) of the
loss with respect to the raw (margin) score.

This slice ports `binary`. Every other objective raises NotImplementedError
until its ROADMAP item (Queue 1, "other objectives and multiclass") lands.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["get_objective", "sigmoid", "init_raw_score", "OBJECTIVES"]

_LATER = ("objective {!r} is not ported yet; see ROADMAP.md Queue 1, "
          "'other objectives and multiclass'")


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def _binary(y: torch.Tensor, raw: torch.Tensor, sigmoid_coef: float = 1.0):
    p = torch.sigmoid(sigmoid_coef * raw)
    grad = sigmoid_coef * (p - y)
    hess = sigmoid_coef * sigmoid_coef * p * (1.0 - p)
    return grad, hess


OBJECTIVES: dict[str, Callable] = {
    "binary": _binary,
}


def get_objective(name: str) -> Callable:
    """Resolve an objective name to fn(y, raw) -> (grad, hess)."""
    key = name.lower()
    if key not in OBJECTIVES:
        raise NotImplementedError(_LATER.format(name))
    return OBJECTIVES[key]


def init_raw_score(
    objective: str,
    y,
    weights=None,
    boost_from_average: bool = True,
    alpha: float = 0.9,
) -> float:
    """Initial constant raw score (reference: boost_from_average semantics):
    for binary, the log-odds of the weighted base rate."""
    key = objective.lower()
    if key not in OBJECTIVES:
        raise NotImplementedError(_LATER.format(objective))
    if not boost_from_average:
        return 0.0
    y = np.asarray(y, dtype=np.float64)
    w = np.ones_like(y) if weights is None else np.asarray(weights, dtype=np.float64)
    mean = float(np.sum(y * w) / max(np.sum(w), 1e-12))
    p = min(max(mean, 1e-12), 1 - 1e-12)
    return float(np.log(p / (1 - p)))
