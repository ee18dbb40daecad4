"""The boosting loop: rounds of objective -> tree growth -> prediction update.

Counterpart of mmlspark_tpu/gbdt/fused.py, which runs the whole multi-round
loop as one XLA program (one dispatch per fit). PyTorch has no `lax.scan`;
here the loop over rounds is a Python loop over device tensors. Without
early stopping nothing in it reads back to the host: the trees stay on the
device until the fit ends and come back in one transfer (`Booster.train`).

A round calls the objective once on the (n,) or (n, K) margins, grows one
tree per class in class order from that class's column of the gradients
and hessians, and adds the trees' row values to the margins. The L1-family
objectives (l1, quantile, mape) renew each tree's leaves to a percentile
of their rows' residuals before the margins move (`_renew_tree_values`,
LightGBM's RenewTreeOutput), as torch ops: the reference writes renewal as
an XLA composition, not as a kernel.

`make_fused_train_fn` runs gbdt, goss and rf, with bagging, feature
sampling and early stopping; `make_fused_dart_fn` runs single-class dart.
Every draw comes from `core.prng`, which gives `jax.random`'s bits, on the
fit's device, from the keys the reference folds: the same seed gives the
same bags, GOSS samples, feature masks and drops as the JAX package. The
keys are host integers (the round index is a Python int here), so choosing
one costs nothing on the device.

Comparisons and products with a hyperparameter round it to float32 first
(`_f32`): JAX applies a Python float to a float32 array in float32.

With a `mesh` of several shards (parallel/mesh.py) every rank runs the loop
on its own block of rows and the trees come out the same on every rank
(the reference's shard_map over the loop, fused.py:478-491). The row draws
fold the shard index into the key first (bags, GOSS samples: fold_in(key,
shard), fused.py:320-322; dart's bag key, :562-565), so shards draw apart;
the feature masks and dart's drops stay on the shared key, so every rank
grows from the same ones. GOSS keeps each shard's own top fraction
(:334-345). Leaf renewal merges its residual brackets with pmin / pmax and
its histograms as the split histograms are merged. Early stopping scores a
validation set that every rank holds whole, so every rank stops at the
same round.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import prng
from ..parallel.collectives import pmax, pmin, psum, psum_exact_fixedpoint
from .engine import GrowConfig, TreeArrays, make_grow_fn, tree_apply

__all__ = ["FusedTrainSpec", "make_fused_train_fn", "make_fused_dart_fn"]


class FusedTrainSpec(NamedTuple):
    """Static configuration of the boosting loop."""

    num_rounds: int
    num_class: int = 1                 # trees per round (multiclass K)
    boosting_type: str = "gbdt"        # gbdt | goss | rf; dart: make_fused_dart_fn
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    feature_fraction: float = 1.0
    top_rate: float = 0.2              # goss
    other_rate: float = 0.1            # goss
    early_stopping_round: int = 0      # 0: off (gbdt and goss)
    drop_rate: float = 0.1             # dart
    # leaf-output renewal (objectives.get_leaf_renewal): the percentile of
    # in-leaf residuals that replaces the grad/hess leaf value. None = off.
    renew_alpha: "float | None" = None
    renew_weighted: bool = False       # mape: residuals weighted by 1/max(|y|, 1)


# A check's window on the draws: when set, the loops call
# round_hook(round, class, grow_mask (n,), feature_mask (F,), drop) with
# each tree's random parts as the tree grows from them, as device tensors
# (`drop`: dart's (rounds,) drop set, else None). None, the default, costs
# nothing and reads nothing back.
round_hook: "Callable | None" = None

_RENEW_BINS = 256      # residual-histogram resolution for leaf renewal
_RENEW_CHUNK = 4096    # rows a one-hot product, as the reference chunks them
# refinement rounds: each multiplies the percentile's resolution by
# _RENEW_BINS within the node's own residual bracket (node span / 65536)
_RENEW_ROUNDS = 2


def _renew_tree_values(tree: TreeArrays, node_of_row, resid, w, alpha: float,
                       learning_rate: float, mesh=None,
                       deterministic: bool = False) -> TreeArrays:
    """LightGBM RenewTreeOutput, as fused.py:97 computes it: each leaf's
    value becomes learning_rate x the alpha-percentile of its (weighted)
    rows' residuals. Each node keeps its own [lo, hi] residual bracket, and
    the percentile is found by _RENEW_ROUNDS rounds of 256-bin histogram
    refinement. The histograms are chunked one-hot products in f32 (TF32
    is off), the reference's Precision.HIGHEST dot_general: the same sums
    on every launch. Non-finite residuals carry no weight. On a mesh the
    brackets and the histograms are merged across the shards (fused.py:
    143-145, 176-180), so every rank renews to the same values."""
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
    if mesh is not None:
        lo, hi = pmin(lo, mesh), pmax(hi, mesh)
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
        if mesh is not None:
            hist = psum_exact_fixedpoint(hist, mesh) if deterministic else psum(hist, mesh)
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


def _apply_renewal(tree, node_row, resid, mask, base_w, y, spec: FusedTrainSpec,
                   cfg: GrowConfig, mesh=None):
    """Renew a grown tree's leaves and recompute its row values (fused.py:209).
    The rows weigh by bag membership times the data weight, not by the
    grow mask: GOSS amplifies its sampled small-gradient rows for the
    gradient sums, but the percentile runs over the rows with their own
    weights. mape divides them by max(|y|, 1)."""
    member_w = torch.where(mask > 0, base_w, 0.0)
    if spec.renew_weighted:
        member_w = member_w / torch.clamp(torch.abs(y), min=1.0)
    tree = _renew_tree_values(tree, node_row, resid, member_w, spec.renew_alpha,
                              cfg.learning_rate, mesh, cfg.deterministic)
    return tree, tree.value.gather(0, node_row.long())


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX applies it to an f32 array."""
    return float(np.float32(x))


def feature_mask_of(key, num_features: int, fraction: float, device) -> torch.Tensor:
    """A tree's feature mask (fused.py:325): each feature kept with
    probability `fraction`; if none is, the one of the smallest draw."""
    u = prng.uniform(key, (num_features,), device)
    sel = u < _f32(fraction)
    fallback = torch.arange(num_features, device=device) == u.argmin()
    return torch.where(sel.any(), sel, fallback).to(torch.float32)


def goss_mask_of(g, present, key, top_rate: float, other_rate: float) -> torch.Tensor:
    """GOSS row weights (fused.py:331): 1 on the top_rate share of present
    rows by |g|, (1 - top_rate) / other_rate on a random other_rate /
    (1 - top_rate) share of the rest, 0 elsewhere. Rows of weight 0
    (`present` 0) never set the bar. The count n_top is set in float32
    with the reference's relative epsilon (a product that lands just
    under an integer still floors to it), and the bar is the n_top-th
    largest |g|, gathered on the device: nothing reads back."""
    n = g.shape[0]
    ga = torch.abs(g) * present
    n_eff = present.sum()
    n_top = torch.clamp(torch.floor(n_eff * _f32(top_rate) * _f32(1.0 + 1e-6) + _f32(1e-6)),
                        min=1.0).long()
    desc = torch.sort(ga, descending=True).values
    thresh = desc.gather(0, (n_top - 1).clamp(max=n - 1).view(1))
    is_top = (ga >= thresh) & (present > 0)
    keep_small = (prng.uniform(key, (n,), g.device)
                  < _f32(other_rate / max(1.0 - top_rate, 1e-6)))
    amp = _f32((1.0 - top_rate) / max(other_rate, 1e-6))
    return torch.where(is_top, 1.0, torch.where(keep_small, amp, 0.0))


def _stack_trees(trees: list) -> TreeArrays:
    return TreeArrays(*(torch.stack(field) for field in zip(*trees)))


def make_fused_train_fn(
    num_features: int,
    num_bins: int,
    cfg: GrowConfig,
    feature_num_bins: np.ndarray,
    categorical_mask: np.ndarray,
    obj_fn: Callable,
    spec: FusedTrainSpec,
    device: "str | torch.device" = "cuda",
    val_loss_fn: "Callable | None" = None,
    mesh=None,
):
    """Build the gbdt / goss / rf loop for tensors on `device`, over this
    rank's block of rows when `mesh` has several shards.

      fn(bins (n, F) uint8/int32, y, base_w (n,) f32, pred0, seed, val=None,
         round_offset=0)
        -> (TreeArrays stacked over rounds [x K], final_pred, (best_iter, stopped))

    y and pred0 are (n,) f32, or (n, K) f32 (one-hot labels, margins) for
    multiclass; the tree fields are then (rounds, K, M). base_w holds the
    sample weights. `seed` is the int32 the draws fold from: per round
    `kr = fold_in(key, it)`, the bag from `fold_in(kr, 1)`, class c's GOSS
    draw from `fold_in(kr, 2 + c)` and its feature mask from
    `fold_in(kr, 100 + c)` (fused.py:356-381). On a mesh the bag's and
    GOSS's `key` is `fold_in(PRNGKey(seed), shard)`; the feature mask's
    stays `PRNGKey(seed)`.

    `it` is the global round index: the loop runs rounds round_offset ..
    round_offset + num_rounds - 1 (a Python int, as `fold_in` takes host
    ints). A checkpointed fit runs its rounds in chunks, each from the
    rounds already done, so every draw and every bag refresh
    (it % bagging_freq == 0) lands where the uninterrupted fit has it
    (reference fused.py:466-471). A chunk starts with a fresh bag, so under
    bagged gbdt round_offset must be a multiple of bagging_freq.

    With spec.early_stopping_round > 0, `val` is (val_bins (nv, F), y_val
    (nv,) f32 or int64 class indexes, val_raw0 (nv,) or (nv, K) f32): the
    validation margins move with every tree (`tree_apply`), and a round
    improves when its loss is below the best by more than 1e-9 in f32. The
    loop reads `stopped` once a round and leaves after the round that sets
    it, so it returns only the rounds run; the reference runs the rest as
    no-ops and the caller keeps best_iter + 1 rounds either way. best_iter
    and stopped come back as device tensors (-1 and False without early
    stopping).
    """
    if spec.boosting_type not in ("gbdt", "goss", "rf"):
        raise ValueError(f"the boosting loop runs gbdt, goss and rf, not "
                         f"{spec.boosting_type!r} (dart: make_fused_dart_fn)")
    es = spec.early_stopping_round > 0
    if es and val_loss_fn is None:
        raise ValueError("early stopping requires val_loss_fn")
    k = spec.num_class
    f = num_features
    if mesh is not None and mesh.size == 1:
        mesh = None
    grow = make_grow_fn(num_features, num_bins, cfg, feature_num_bins,
                        categorical_mask, device=device, mesh=mesh)
    rf_mode = spec.boosting_type == "rf"
    use_goss = spec.boosting_type == "goss"
    use_bagging = rf_mode or (spec.boosting_type == "gbdt" and spec.bagging_fraction < 1.0
                              and spec.bagging_freq > 0)
    if spec.bagging_fraction < 1.0:
        bag_frac = spec.bagging_fraction
    else:
        bag_frac = 0.632 if rf_mode else 1.0   # rf defaults to a bootstrap-sized bag
    bag_freq = max(spec.bagging_freq, 1)

    def loop(bins, y, base_w, pred0, seed, val=None, round_offset: int = 0):
        if use_bagging and not rf_mode and round_offset % bag_freq:
            raise ValueError(f"round_offset {round_offset} is not a multiple of "
                             f"bagging_freq {bag_freq}: the carried bag would be lost")
        dev = bins.device
        n = bins.shape[0]
        key_repl = prng.prng_key(seed)
        # rows draw per shard; the feature masks feed the shared tree state
        key = key_repl if mesh is None else prng.fold_in(key_repl, mesh.shard_index)
        present = (base_w > 0).to(torch.float32)
        ones_f = torch.ones(f, dtype=torch.float32, device=dev)
        pred, bag = pred0, base_w
        best_iter = torch.full((), -1, dtype=torch.long, device=dev)
        stopped = torch.zeros((), dtype=torch.bool, device=dev)
        if es:
            val_bins, y_val, val_raw = val
            best_loss = torch.full((), float("inf"), dtype=torch.float32, device=dev)
            since = torch.zeros((), dtype=torch.long, device=dev)
        trees = []
        for it in range(round_offset, round_offset + spec.num_rounds):
            kr = prng.fold_in(key, it)
            kr_repl = prng.fold_in(key_repl, it)
            # the gbdt bag refreshes every bag_freq rounds and is carried
            # between; rf draws a fresh one every round
            if use_bagging and (rf_mode or it % bag_freq == 0):
                u = prng.uniform(prng.fold_in(kr, 1), (n,), dev)
                bag = torch.where(u < _f32(bag_frac), base_w, 0.0)
            g, h = obj_fn(y, pred)
            trees_k, rowvals = [], []
            for cls in range(k):
                gc = g[:, cls] if k > 1 else g
                hc = h[:, cls] if k > 1 else h
                if use_goss:
                    mask = base_w * goss_mask_of(gc, present, prng.fold_in(kr, 2 + cls),
                                                 spec.top_rate, spec.other_rate)
                else:
                    mask = bag
                fmask = (feature_mask_of(prng.fold_in(kr_repl, 100 + cls), f,
                                         spec.feature_fraction, dev)
                         if spec.feature_fraction < 1.0 else ones_f)
                if round_hook is not None:
                    round_hook(it, cls, mask, fmask, None)
                tree, rv, node_row = grow(bins, gc, hc, mask, fmask)
                if spec.renew_alpha is not None and k == 1:
                    tree, rv = _apply_renewal(tree, node_row, y - pred, mask, base_w, y,
                                              spec, cfg, mesh)
                trees_k.append(tree)
                rowvals.append(rv)
            if rf_mode:
                pass                      # rf trees are independent of pred
            elif k > 1:
                pred = pred + torch.stack(rowvals, dim=-1)
            else:
                pred = pred + rowvals[0]
            trees.append(_stack_trees(trees_k) if k > 1 else trees_k[0])
            if es:
                contrib = [tree_apply(t, val_bins, cfg.num_leaves) for t in trees_k]
                val_raw = val_raw + (torch.stack(contrib, dim=-1) if k > 1 else contrib[0])
                vloss = val_loss_fn(val_raw, y_val)
                improved = vloss < best_loss - _f32(1e-9)
                best_loss = torch.where(improved, vloss, best_loss)
                best_iter = torch.where(improved, it, best_iter)
                since = torch.where(improved, 0, since + 1)
                stopped = since >= spec.early_stopping_round
                if bool(stopped):         # the one read a round, early stopping only
                    break
        return _stack_trees(trees), pred, (best_iter, stopped)

    return loop


def make_fused_dart_fn(
    num_features: int,
    num_bins: int,
    cfg: GrowConfig,
    feature_num_bins: np.ndarray,
    categorical_mask: np.ndarray,
    obj_fn: Callable,
    spec: FusedTrainSpec,
    device: "str | torch.device" = "cuda",
    mesh=None,
):
    """Build single-class DART (reference make_fused_dart_fn, fused.py:501),
    over this rank's block of rows when `mesh` has several shards.

      fn(bins, y, base_w, pred0, drop_seed, bag_seed, feat_seed)
        -> (TreeArrays stacked over rounds, tree_weights (R,) f32, final_pred)

    Each purpose has its own key: round r drops each earlier tree with
    probability drop_rate by `uniform(fold_in(PRNGKey(drop_seed), r),
    (rounds,))`, bags by `fold_in(PRNGKey(bag_seed), r)` (on a mesh
    `fold_in(fold_in(PRNGKey(bag_seed), shard), r)`) and samples
    features by `fold_in(PRNGKey(feat_seed), r)`. The round's base
    prediction is pred0 plus every earlier tree's row values (rows of a
    (rounds, n) f32 matrix) times its weight, 0 if dropped; the new tree
    trains on the gradients there. Then the dropped weights scale by
    k/(k+1), computed as (w * k) / (k + 1), and the new tree enters at
    1/(k+1). Tree values come back unscaled, for the caller to fold the
    weights in.

    The reference recomputes the base as one einsum a round. Here the loop
    carries the weighted sum of all trees grown so far; a round's base is
    that sum minus the dropped trees' share (one matrix-vector product),
    and the sum moves on by the dropped trees' new share and the new tree.
    A round costs the same few launches whatever its index. With nothing
    dropped both products are exactly 0, so drop_rate=0 (every weight 1)
    adds one tree a round as the gbdt loop does, and such a fit equals
    gbdt bit for bit (tests/test_gbdt.py:352).
    """
    if spec.num_class != 1:
        raise ValueError("dart covers the single-class path only")
    rounds = spec.num_rounds
    f = num_features
    if mesh is not None and mesh.size == 1:
        mesh = None
    grow = make_grow_fn(num_features, num_bins, cfg, feature_num_bins,
                        categorical_mask, device=device, mesh=mesh)
    use_bagging = spec.bagging_fraction < 1.0 and spec.bagging_freq > 0
    bag_freq = max(spec.bagging_freq, 1)

    def loop(bins, y, base_w, pred0, drop_seed, bag_seed, feat_seed):
        dev = bins.device
        n = bins.shape[0]
        key_drop, key_bag, key_feat = (prng.prng_key(s) for s in (drop_seed, bag_seed, feat_seed))
        if mesh is not None:
            key_bag = prng.fold_in(key_bag, mesh.shard_index)      # rows draw per shard
        ones_f = torch.ones(f, dtype=torch.float32, device=dev)
        order = torch.arange(rounds, device=dev)
        weights = torch.zeros(rounds, dtype=torch.float32, device=dev)
        contribs = torch.zeros((rounds, n), dtype=torch.float32, device=dev)
        total = pred0             # pred0 + every grown tree's weighted row values
        bag = base_w
        trees = []
        for it in range(rounds):
            u = prng.uniform(prng.fold_in(key_drop, it), (rounds,), dev)
            drop = (u < _f32(spec.drop_rate)) & (order < it)
            k_drop = drop.sum().to(torch.float32)
            pred_round = total - torch.mv(contribs.t(), torch.where(drop, weights, 0.0))
            if use_bagging and it % bag_freq == 0:
                u = prng.uniform(prng.fold_in(key_bag, it), (n,), dev)
                bag = torch.where(u < _f32(spec.bagging_fraction), base_w, 0.0)
            g, h = obj_fn(y, pred_round)
            fmask = (feature_mask_of(prng.fold_in(key_feat, it), f, spec.feature_fraction, dev)
                     if spec.feature_fraction < 1.0 else ones_f)
            if round_hook is not None:
                round_hook(it, 0, bag, fmask, drop)
            tree, rv, node_row = grow(bins, g, h, bag, fmask)
            if spec.renew_alpha is not None:
                tree, rv = _apply_renewal(tree, node_row, y - pred_round, bag, base_w, y,
                                          spec, cfg, mesh)
            weights = torch.where(drop, weights * k_drop / (k_drop + 1.0), weights)
            weights = torch.where(order == it, torch.reciprocal(k_drop + 1.0), weights)
            total = (pred_round + torch.mv(contribs.t(), torch.where(drop, weights, 0.0))
                     + rv * weights[it])
            contribs[it] = rv
            trees.append(tree)
        return _stack_trees(trees), weights, total

    return loop
