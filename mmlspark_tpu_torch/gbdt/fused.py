"""The boosting loop: rounds of objective -> tree growth -> prediction update.

Counterpart of mmlspark_tpu/gbdt/fused.py, which runs the whole multi-round
loop as one XLA program (one dispatch per fit). PyTorch has no `lax.scan`;
here the loop over rounds is a Python loop over device tensors. Nothing in
it reads back to the host: the trees stay on the device until the fit ends
and come back in one transfer (`Booster.train`).

A round calls the objective once on the (n,) or (n, K) margins, grows one
tree per class in class order from that class's column of the gradients
and hessians, and adds the trees' row values to the margins. The L1-family
objectives (l1, quantile, mape) renew each tree's leaves to a percentile
of their rows' residuals before the margins move (`_renew_tree_values`,
LightGBM's RenewTreeOutput), as torch ops: the reference writes renewal as
an XLA composition, not as a kernel.

This slice ports the plain `gbdt` loop. Bagging, GOSS, rf, dart and early
stopping raise NotImplementedError until their ROADMAP items land.
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
    num_class: int = 1                 # trees per round (multiclass K)
    boosting_type: str = "gbdt"
    # leaf-output renewal (objectives.get_leaf_renewal): the percentile of
    # in-leaf residuals that replaces the grad/hess leaf value. None = off.
    renew_alpha: "float | None" = None
    renew_weighted: bool = False       # mape: residuals weighted by 1/max(|y|, 1)


_RENEW_BINS = 256      # residual-histogram resolution for leaf renewal
_RENEW_CHUNK = 4096    # rows a one-hot product, as the reference chunks them
# refinement rounds: each multiplies the percentile's resolution by
# _RENEW_BINS within the node's own residual bracket (node span / 65536)
_RENEW_ROUNDS = 2


def _renew_tree_values(tree: TreeArrays, node_of_row, resid, w, alpha: float,
                       learning_rate: float) -> TreeArrays:
    """LightGBM RenewTreeOutput, as fused.py:97 computes it: each leaf's
    value becomes learning_rate x the alpha-percentile of its (weighted)
    rows' residuals. Each node keeps its own [lo, hi] residual bracket, and
    the percentile is found by _RENEW_ROUNDS rounds of 256-bin histogram
    refinement. The histograms are chunked one-hot products in f32 (TF32
    is off), the reference's Precision.HIGHEST dot_general: the same sums
    on every launch. Non-finite residuals carry no weight."""
    m = tree.value.shape[0]
    dev = resid.device
    f32 = torch.float32
    n = resid.shape[0]
    chunk = min(_RENEW_CHUNK, max(n, 1))
    pad = (-n) % chunk
    nd = node_of_row.long()
    r = resid.to(f32)
    w = w.to(f32)
    if pad:
        nd = torch.cat([nd, nd.new_zeros(pad)])
        r = torch.cat([r, r.new_zeros(pad)])
        w = torch.cat([w, w.new_zeros(pad)])

    # per-node residual bracket: an outlier only widens its own node's span
    live = (w > 0) & torch.isfinite(r)
    inf = torch.tensor(float("inf"), device=dev)
    lo = torch.full((m,), float("inf"), device=dev).scatter_reduce(
        0, nd, torch.where(live, r, inf), "amin")
    hi = torch.full((m,), float("-inf"), device=dev).scatter_reduce(
        0, nd, torch.where(live, r, -inf), "amax")
    empty = lo > hi          # nodes without rows keep inf brackets
    lo = torch.where(empty, 0.0, lo)
    hi = torch.where(empty, 0.0, hi)

    bins = torch.arange(_RENEW_BINS, device=dev)
    nodes = torch.arange(m, device=dev)

    def hist_pass(lo, hi, target, first):
        span = torch.clamp(hi - lo, min=1e-12)
        hist = torch.zeros((m, _RENEW_BINS), dtype=f32, device=dev)
        for s in range(0, n + pad, chunk):
            ndc, rc, wc = nd[s:s + chunk], r[s:s + chunk], w[s:s + chunk]
            lo_r, hi_r = lo[ndc], hi[ndc]
            bin_f = (rc - lo_r) / span[ndc] * _RENEW_BINS
            # rows outside their node's bracket, and non-finite ones, carry
            # no weight; their bin index is then never used
            ok = (rc >= lo_r) & (rc <= hi_r) & torch.isfinite(rc)
            bidx = torch.where(ok, bin_f, 0.0).to(torch.int32).clamp(0, _RENEW_BINS - 1)
            inw = torch.where(ok, wc, 0.0)
            oh_n = (ndc[:, None] == nodes[None, :]).to(f32)              # (ch, M)
            oh_b = (bidx[:, None] == bins[None, :]).to(f32) * inw[:, None]
            hist = hist + oh_n.t() @ oh_b                                 # (M, B)
        cum = torch.cumsum(hist, dim=1)
        tot = cum[:, -1]
        if first:
            target = alpha * tot
        idx = (cum >= target[:, None]).to(torch.int8).argmax(dim=1)     # first bin reaching it
        below = cum.gather(1, torch.clamp(idx - 1, min=0)[:, None])[:, 0]
        below = torch.where(idx > 0, below, 0.0)
        width = span / _RENEW_BINS
        new_lo = lo + idx.to(f32) * width
        return new_lo, new_lo + width, target - below, tot

    target = torch.zeros(m, dtype=f32, device=dev)
    tot0 = None
    for rnd in range(_RENEW_ROUNDS):
        lo, hi, target, tot = hist_pass(lo, hi, target, first=(rnd == 0))
        if tot0 is None:
            tot0 = tot
    centers = (lo + hi) * 0.5
    value = torch.where(tree.is_leaf & (tot0 > 0), (centers * learning_rate).to(f32),
                        tree.value)
    return tree._replace(value=value)


def _apply_renewal(tree, node_row, resid, member_w, y, spec: FusedTrainSpec,
                   cfg: GrowConfig):
    """Renew a grown tree's leaves and recompute its row values (fused.py:209).
    `member_w` is bag membership times the data weight (the data weight
    alone without bagging); mape divides it by max(|y|, 1)."""
    if spec.renew_weighted:
        member_w = member_w / torch.clamp(torch.abs(y), min=1.0)
    tree = _renew_tree_values(tree, node_row, resid, member_w, spec.renew_alpha,
                              cfg.learning_rate)
    return tree, tree.value.gather(0, node_row.long())


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

      fn(bins (n, F) uint8/int32, y, base_w (n,) f32, pred0)
        -> (TreeArrays stacked over rounds [x K], final_pred)

    y and pred0 are (n,) f32, or (n, K) f32 (one-hot labels, margins) for
    multiclass; the tree fields are then (rounds, K, M). base_w holds the
    sample weights (0 on padded rows) and is every tree's row mask, as in
    the JAX loop without bagging.
    """
    if spec.boosting_type != "gbdt":
        raise NotImplementedError(
            f"boosting_type={spec.boosting_type!r} is not ported yet; see "
            "ROADMAP.md Queue 1, 'other boosting types'")
    k = spec.num_class
    grow = make_grow_fn(num_features, num_bins, cfg, feature_num_bins,
                        categorical_mask, device=device)

    def grow_round(bins, y, base_w, pred, fmask):
        g, h = obj_fn(y, pred)
        trees_k, rowvals = [], []
        for cls in range(k):
            gc = g[:, cls] if k > 1 else g
            hc = h[:, cls] if k > 1 else h
            tree, rv, node_row = grow(bins, gc, hc, base_w, fmask)
            if spec.renew_alpha is not None and k == 1:
                tree, rv = _apply_renewal(tree, node_row, y - pred, base_w, y, spec, cfg)
            trees_k.append(tree)
            rowvals.append(rv)
        if k > 1:
            pred = pred + torch.stack(rowvals, dim=-1)
            return pred, TreeArrays(*(torch.stack(field) for field in zip(*trees_k)))
        return pred + rowvals[0], trees_k[0]

    def loop(bins, y, base_w, pred0):
        fmask = torch.ones(num_features, dtype=torch.float32, device=bins.device)
        pred = pred0
        trees = []
        for _ in range(spec.num_rounds):
            pred, tree = grow_round(bins, y, base_w, pred, fmask)
            trees.append(tree)
        return TreeArrays(*(torch.stack(field) for field in zip(*trees))), pred

    return loop
