"""Boosting objectives: gradients/hessians of the training losses.

Counterpart of mmlspark_tpu/gbdt/objectives.py. Reference: the objective
strings accepted by the native learner — classifier "binary"/"multiclass"
(src/lightgbm/src/main/scala/TrainParams.scala:40-74) and the regressor set
regression/l1(mae)/l2(mse)/huber/fair/poisson/quantile/mape/gamma/tweedie
(src/lightgbm/src/main/scala/LightGBMRegressor.scala:17-36). Each objective
is an elementwise torch function of (label, raw_score) on the fit's device
and returns (grad, hess) of the loss with respect to the raw (margin)
score, in float32 as the JAX package computes them.

`get_validation_loss` gives early stopping's validation loss on each
objective's own scale, in float32.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch

__all__ = ["get_objective", "get_leaf_renewal", "get_validation_loss", "sigmoid",
           "softmax", "init_raw_score", "OBJECTIVES"]


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=axis)


# -- binary / multiclass ----------------------------------------------------

def _binary(y, raw, sigmoid_coef: float = 1.0):
    p = torch.sigmoid(sigmoid_coef * raw)
    grad = sigmoid_coef * (p - y)
    hess = sigmoid_coef * sigmoid_coef * p * (1.0 - p)
    return grad, hess


def _multiclass(y_onehot, raw):
    """raw, y_onehot: (n, K). Diagonal-hessian softmax cross-entropy, the
    hessian scaled by K/(K-1) as LightGBM scales it."""
    p = torch.softmax(raw, dim=-1)
    grad = p - y_onehot
    hess = p * (1.0 - p)
    k = raw.shape[-1]
    return grad, hess * (k / max(k - 1.0, 1.0))


# -- regression -------------------------------------------------------------

def _l2(y, raw):
    return raw - y, torch.ones_like(raw)


def _l1(y, raw):
    return torch.sign(raw - y), torch.ones_like(raw)


def _huber(y, raw, alpha: float = 0.9):
    d = raw - y
    grad = torch.where(torch.abs(d) <= alpha, d, alpha * torch.sign(d))
    return grad, torch.ones_like(raw)


def _fair(y, raw, c: float = 1.0):
    d = raw - y
    denom = torch.abs(d) + c
    return c * d / denom, c * c / (denom * denom)


def _poisson(y, raw, max_delta_step: float = 0.7):
    # loss = exp(raw) - y*raw; hessian stabilised like the native learner.
    # exp(max_delta_step) is taken in f32, as jnp takes it
    e = torch.exp(raw)
    return e - y, e * torch.exp(torch.tensor(max_delta_step, dtype=raw.dtype))


def _quantile(y, raw, alpha: float = 0.9):
    d = raw - y
    return torch.where(d >= 0, 1.0 - alpha, -alpha), torch.ones_like(raw)


def _mape(y, raw):
    denom = torch.clamp(torch.abs(y), min=1.0)
    return torch.sign(raw - y) / denom, torch.ones_like(raw) / denom


def _gamma(y, raw):
    # negative log-likelihood of gamma with log link
    e = torch.exp(-raw)
    return 1.0 - y * e, y * e


def _tweedie(y, raw, rho: float = 1.5):
    e1 = torch.exp((2.0 - rho) * raw)
    e2 = torch.exp((1.0 - rho) * raw)
    return e1 - y * e2, (2.0 - rho) * e1 - (1.0 - rho) * y * e2


OBJECTIVES: dict[str, Callable] = {
    "binary": _binary,
    "multiclass": _multiclass,
    "regression": _l2,
    "l2": _l2,
    "mean_squared_error": _l2,
    "mse": _l2,
    "regression_l2": _l2,
    "l1": _l1,
    "mae": _l1,
    "mean_absolute_error": _l1,
    "regression_l1": _l1,
    "huber": _huber,
    "fair": _fair,
    "poisson": _poisson,
    "quantile": _quantile,
    "mape": _mape,
    "gamma": _gamma,
    "tweedie": _tweedie,
}

_L1_NAMES = ("l1", "mae", "mean_absolute_error", "regression_l1")
_L2_NAMES = ("regression", "l2", "mse", "mean_squared_error", "regression_l2")


def get_leaf_renewal(name: str, alpha: float = 0.9):
    """Leaf-output renewal of the gradient-scale-free objectives, or None:
    (percentile_alpha, weighted_by_inv_label). LightGBM's RenewTreeOutput
    replaces each leaf's value with a percentile of its rows' residuals:
    l1/mae the median, quantile the objective's alpha, mape the
    1/max(|y|, 1)-weighted median. huber and the L2 family are not renewed,
    as in LightGBM."""
    key = name.lower()
    if key in _L1_NAMES:
        return 0.5, False
    if key == "quantile":
        return float(alpha), False
    if key == "mape":
        return 0.5, True
    return None


def get_objective(name: str, **kw) -> Callable:
    """Resolve an objective name to fn(y, raw) -> (grad, hess); `alpha`
    (huber, quantile), `tweedie_variance_power` and `fair_c` bind the
    objective's own parameter."""
    key = name.lower()
    if key not in OBJECTIVES:
        raise ValueError(f"unknown objective {name!r}; choose from {sorted(set(OBJECTIVES))}")
    fn = OBJECTIVES[key]
    if key == "huber" and "alpha" in kw:
        return partial(_huber, alpha=kw["alpha"])
    if key == "quantile" and "alpha" in kw:
        return partial(_quantile, alpha=kw["alpha"])
    if key == "tweedie" and "tweedie_variance_power" in kw:
        return partial(_tweedie, rho=kw["tweedie_variance_power"])
    if key == "fair" and "fair_c" in kw:
        return partial(_fair, c=kw["fair_c"])
    return fn


def init_raw_score(
    objective: str,
    y,
    weights=None,
    boost_from_average: bool = True,
    alpha: float = 0.9,
) -> float:
    """Initial constant raw score (reference: boost_from_average semantics):
    binary the log-odds of the base rate; the L2 family, huber and fair the
    weighted mean; quantile the alpha-quantile and the L1 family and mape
    the median of the labels; poisson, gamma and tweedie the log of the
    weighted mean; else 0."""
    if not boost_from_average:
        return 0.0
    y = np.asarray(y, dtype=np.float64)
    w = np.ones_like(y) if weights is None else np.asarray(weights, dtype=np.float64)
    key = objective.lower()
    mean = float(np.sum(y * w) / max(np.sum(w), 1e-12))
    if key == "binary":
        p = min(max(mean, 1e-12), 1 - 1e-12)
        return float(np.log(p / (1 - p)))
    if key in _L2_NAMES or key in ("huber", "fair"):
        return mean
    if key == "quantile":
        return float(np.quantile(y, alpha))
    if key in _L1_NAMES or key == "mape":
        return float(np.median(y))
    if key in ("poisson", "gamma", "tweedie"):
        return float(np.log(max(mean, 1e-12)))
    return 0.0


def get_validation_loss(objective: str, alpha: float = 0.9,
                        tweedie_variance_power: float = 1.5) -> Callable:
    """Early stopping's validation loss fn(raw, y) -> 0-d f32 tensor, on the
    scale the objective optimizes (reference objectives.py:208): binary
    log-loss, multiclass cross-entropy over class indexes y, the
    poisson / gamma / tweedie negative log-likelihoods of a log-space
    margin, the pinball loss for quantile, mean |raw - y| for the L1
    family, the 1/max(|y|, 1)-weighted one for mape, else the mean squared
    error (huber, fair and the name "mean_absolute_error" included, as in
    the reference)."""
    obj = objective.lower()
    rho = tweedie_variance_power

    def loss(raw, y):
        if obj == "binary":
            p = torch.sigmoid(raw)
            eps = 1e-7
            return -torch.mean(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))
        if obj == "multiclass":
            logp = torch.log_softmax(raw, dim=-1)
            return -torch.mean(logp.gather(1, y.long()[:, None])[:, 0])
        if obj == "poisson" or (obj == "tweedie" and abs(rho - 1.0) < 1e-9):
            return torch.mean(torch.exp(raw) - y * raw)
        if obj == "gamma" or (obj == "tweedie" and abs(rho - 2.0) < 1e-9):
            return torch.mean(raw + y * torch.exp(-raw))
        if obj == "tweedie":
            return torch.mean(-y * torch.exp((1 - rho) * raw) / (1 - rho)
                              + torch.exp((2 - rho) * raw) / (2 - rho))
        if obj == "quantile":
            d = y - raw
            return torch.mean(torch.maximum(alpha * d, (alpha - 1) * d))
        if obj in ("l1", "mae", "regression_l1"):   # not "mean_absolute_error", as there
            return torch.mean(torch.abs(raw - y))
        if obj == "mape":
            return torch.mean(torch.abs(raw - y) / torch.clamp(torch.abs(y), min=1.0))
        return torch.mean((raw - y) ** 2)

    return loss
