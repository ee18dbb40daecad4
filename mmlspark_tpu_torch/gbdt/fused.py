"""The boosting loop: rounds of objective -> tree growth -> prediction update.

Counterpart of mmlspark_tpu/gbdt/fused.py, which runs the whole multi-round
loop as one XLA program (one dispatch per fit). PyTorch has no `lax.scan`;
here the loop over rounds is a Python loop over device tensors. Nothing in
it reads back to the host: the trees stay on the device until the fit ends
and come back in one transfer (`Booster.train`).

This slice ports the plain `gbdt` loop. Bagging, GOSS, rf, dart, early
stopping and leaf renewal raise NotImplementedError until their ROADMAP
items land.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .engine import GrowConfig, TreeArrays, make_grow_fn

__all__ = ["FusedTrainSpec", "make_fused_train_fn"]


class FusedTrainSpec(NamedTuple):
    """Static configuration of the boosting loop."""

    num_rounds: int
    num_class: int = 1                 # trees per round
    boosting_type: str = "gbdt"


def make_fused_train_fn(
    num_features: int,
    num_bins: int,
    cfg: GrowConfig,
    feature_num_bins: np.ndarray,
    categorical_mask: np.ndarray,
    obj_fn: Callable,
    spec: FusedTrainSpec,
    device: "str | torch.device" = "cuda",
):
    """Build the boosting loop for tensors on `device`.

      fn(bins (n, F) uint8/int32, y (n,) f32, base_w (n,) f32, pred0 (n,) f32)
        -> (TreeArrays stacked over rounds, final_pred (n,) f32)

    base_w holds the sample weights (0 on padded rows) and is every tree's
    row mask, as in the JAX loop without bagging.
    """
    if spec.boosting_type != "gbdt" or spec.num_class != 1:
        raise NotImplementedError(
            f"boosting_type={spec.boosting_type!r} with {spec.num_class} "
            "trees per round is not ported yet; see ROADMAP.md Queue 1, "
            "'other boosting types' and 'other objectives and multiclass'")
    grow = make_grow_fn(num_features, num_bins, cfg, feature_num_bins,
                        categorical_mask, device=device)

    def loop(bins, y, base_w, pred0):
        fmask = torch.ones(num_features, dtype=torch.float32, device=bins.device)
        pred = pred0
        trees = []
        for _ in range(spec.num_rounds):
            g, h = obj_fn(y, pred)
            tree, row_values, _ = grow(bins, g, h, base_w, fmask)
            pred = pred + row_values
            trees.append(tree)
        return TreeArrays(*(torch.stack(field) for field in zip(*trees))), pred

    return loop
