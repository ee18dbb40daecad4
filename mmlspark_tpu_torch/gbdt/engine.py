"""Histogram-GBDT training engine: leaf-wise tree growth on device tensors.

Counterpart of mmlspark_tpu/gbdt/engine.py. Reference semantics: the serial
tree learner of lib_lightgbm as driven by TrainUtils.scala:74-121 —
per-feature histogram build over the rows, best-gain split, leaf-wise
growth bounded by num_leaves/max_depth.

The JAX package runs the growth loop as one jitted `lax.fori_loop`. PyTorch
runs eagerly, so here it is a Python loop of num_leaves-1 split steps over
fixed-shape tensors, written with no host synchronisation: no `.item()`, no
Python branch on a tensor value, no boolean-mask indexing and no 0-d tensor
used as an index (PyTorch reads such an index back to the host). Indices
are one-element int64 tensors used through gather/index_select/index_copy_,
and every state update is gated with `torch.where` on `act`, as the JAX
step gates on it (engine.py:383-400), instead of a `break`. The shapes never
change, so a later change can capture the loop in a CUDA graph. The node
histograms are updated in place (`index_copy_`), where the JAX code builds
new arrays.

Each step launches the histogram kernel once, for the new left child; the
right child is the parent minus the left. With the root that is num_leaves
launches per tree.

Categorical splits are LightGBM's many-vs-many sorted-subset search, as in
the JAX package (engine.py:23-32): at each node a categorical feature's
bins are ordered by grad / (hess + cat_smooth) (`torch.argsort(stable=True)`,
the order `jnp.argsort` gives), its split positions are the prefixes of
that order, scored with cat_l2 added to lambda_l2 and capped by
max_cat_threshold on the smaller side, and the winning prefix becomes the
node's bitset over bins, which routes rows. Bin 0 (other, unseen, NaN),
empty bins and bins past the feature's count sort last and always go
right.

On a mesh of several shards (parallel/mesh.py: one process a shard) each
rank grows the tree from its own block of rows, and every node histogram
is merged across the ranks before the split search (engine.py:187-193 of
the JAX package): a plain `all_reduce`, or with `deterministic` the
bit-exact fixed-point merge (parallel/collectives.py). Every rank then
grows the same tree from the same merged histograms, LightGBM's
replicated model. The voting-parallel learner (`voting_top_k` > 0,
engine.py:288-331) first ranks the features by the best split gain of the
rank's own root histogram, proposes its top 2k (a stable descending sort:
`lax.top_k` puts the lower index first on ties), tallies the proposals
across the ranks (an all-reduce of one-hot votes) and keeps the 2k with
the most votes, the lower feature id first on equal votes; only those
features' histograms are merged for the whole tree. The collective waits
for the rank's kernels: a merge reads its histogram back when the backend
is gloo, and NCCL runs on the card's stream.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..parallel.collectives import psum, psum_exact_fixedpoint
from .hist_kernel import histogram

__all__ = ["TreeArrays", "GrowConfig", "make_grow_fn", "tree_apply", "pad_rows"]

_NEG_INF = float("-inf")


class TreeArrays(NamedTuple):
    """SoA tree layout (M = 2*num_leaves - 1 nodes, fixed)."""

    feature: torch.Tensor        # (M,) int32, -1 on leaves
    threshold_bin: torch.Tensor  # (M,) int32 (numeric: <= goes left;
                                 #  categorical: sorted-prefix length - 1)
    is_categorical: torch.Tensor # (M,) bool
    left: torch.Tensor           # (M,) int32, -1 on leaves
    right: torch.Tensor          # (M,) int32
    value: torch.Tensor          # (M,) float32 (already shrunk by learning_rate)
    is_leaf: torch.Tensor        # (M,) bool
    gain: torch.Tensor           # (M,) float32 split gain
    cat_bitset: torch.Tensor     # (M, B) bool — bins routed LEFT at a
                                 # categorical node; all-False elsewhere


class GrowConfig(NamedTuple):
    num_leaves: int = 31
    max_depth: int = -1           # <=0: unlimited (bounded by num_leaves)
    max_bin: int = 255
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    learning_rate: float = 0.1
    # voting-parallel (tree_learner=voting_parallel): each shard proposes
    # its top-k features, and only the 2k most voted are merged. 0 = data
    # parallel
    voting_top_k: int = 0
    # LightGBM's `deterministic`: merge the histograms by the fixed-point
    # all-reduce, the same bits under any order (one shard is exact already)
    deterministic: bool = False
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32


def pad_rows(n: int, shards: int) -> int:
    """Rows padded up so the data axis divides evenly (weight 0 on the pad)."""
    return ((n + shards - 1) // shards) * shards


def tree_apply(tree: TreeArrays, bins: torch.Tensor, max_steps: int) -> torch.Tensor:
    """Gather-walk of one tree over binned rows (n, F) -> (n,) leaf values.
    The clamps are explicit (JAX clamps out-of-range gathers by itself)."""
    n = bins.shape[0]
    bins = bins.long()
    feature = tree.feature.long()
    left, right = tree.left.long(), tree.right.long()
    thr = tree.threshold_bin.long()
    bc = tree.cat_bitset.shape[-1]
    bitset = tree.cat_bitset.reshape(-1)
    node = torch.zeros(n, dtype=torch.long, device=bins.device)
    for _ in range(max_steps):
        feat = feature.gather(0, node)
        col = bins.gather(1, feat.clamp(min=0)[:, None])[:, 0]
        go_left = torch.where(
            tree.is_categorical.gather(0, node),
            bitset.gather(0, node * bc + col.clamp(max=bc - 1)),
            col <= thr.gather(0, node),
        )
        node = torch.where(
            feat < 0, node,
            torch.where(go_left, left.gather(0, node), right.gather(0, node)))
    return tree.value.gather(0, node)


def _l1_threshold(g, l1):
    return torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)


def _leaf_objective(g, h, l1, l2):
    """-Thr(G)^2 / (H + l2): the (negated) optimal leaf loss."""
    t = _l1_threshold(g, l1)
    return (t * t) / (h + l2 + 1e-12)


def make_grow_fn(
    num_features: int,
    num_bins: int,
    cfg: GrowConfig,
    feature_num_bins: np.ndarray,
    categorical_mask: np.ndarray,
    device: "str | torch.device" = "cuda",
    mesh=None,
):
    """Build the single-tree growth function for tensors on `device`.

    Returns fn(bins (n, F) uint8/int32, grad (n,) f32, hess (n,) f32,
               sample_mask (n,) f32, feature_mask (F,) f32)
            -> (TreeArrays, per_row_value (n,) f32, node_of_row (n,) int32)

    `categorical_mask` (F,) bool marks the features split as category
    subsets. With a `mesh` of several shards the row inputs are this
    rank's block, the histograms are merged across the mesh and the tree
    comes out the same on every rank; `cfg.voting_top_k` > 0 takes the
    voting-parallel learner there (without such a mesh it has no effect,
    as in the reference)."""
    device = torch.device(device)
    if mesh is not None and mesh.size == 1:
        mesh = None
    voting = mesh is not None and cfg.voting_top_k > 0
    nl = cfg.num_leaves
    m = 2 * nl - 1
    max_depth = cfg.max_depth if cfg.max_depth and cfg.max_depth > 0 else nl + 1
    l1, l2 = cfg.lambda_l1, cfg.lambda_l2
    l2c = cfg.lambda_l2 + cfg.cat_l2
    # static split-position masks (engine.py:205-219): numeric features
    # split at any bin but the last real one; a categorical prefix of k+1
    # categories leaves one on the right, its smaller side at most
    # max_cat_threshold
    fbins = np.asarray(feature_num_bins, np.int64)
    is_cat_np = np.asarray(categorical_mask, bool)
    cat_any = bool(is_cat_np.any())
    pos = np.arange(num_bins)[None, :]
    n_cats = fbins[:, None] - 1                          # bin 0 excluded
    kp1 = pos + 1
    valid_cat = (kp1 <= n_cats - 1) & (np.minimum(kp1, n_cats - kp1) <= cfg.max_cat_threshold)
    valid_base = torch.as_tensor(
        np.where(is_cat_np[:, None], valid_cat, pos < (fbins[:, None] - 1)), device=device)
    is_cat_f = torch.as_tensor(is_cat_np, device=device)
    fbins_t = torch.as_tensor(fbins, device=device)
    bin_pos = torch.arange(num_bins, device=device)

    def cat_order(h, fb):
        """h (..., B, 3), fb (...) -> (..., B): a node's bins ordered by
        grad / (hess + cat_smooth), bin 0, empty bins and bins past the
        feature's count last (engine.py:221-234). The sort is stable, so
        the split step recomputes the gain scan's order bit for bit."""
        ratio = h[..., 0] / (h[..., 1] + cfg.cat_smooth)
        pushed = (bin_pos == 0) | (h[..., 2] <= 0) | (bin_pos >= fb[..., None])
        return torch.argsort(torch.where(pushed, float("inf"), ratio), dim=-1, stable=True)

    def merge(h):
        """The one histogram-merge collective (engine.py:187-193)."""
        if cfg.deterministic:
            return psum_exact_fixedpoint(h, mesh)
        return psum(h, mesh)

    def grow(bins, grad, hess, sample_mask, feature_mask):
        n = bins.shape[0]
        dev = bins.device
        node_ids = torch.arange(m, device=dev)

        def local_hist(mask):
            # channels: [grad, hess, row count] — count is unweighted so
            # min_data_in_leaf means ROWS (LightGBM semantics)
            stats = torch.stack(
                [grad * mask, hess * mask, (mask > 0).to(torch.float32)], dim=-1)
            return histogram(bins, stats, num_bins)                 # (F, B, 3)

        def gains(h, tot, valid):
            """h (k, F, B, 3), tot (k, 3) -> (k, F, B) split gains, -inf
            where a split is not allowed. Numeric position b: bins <= b go
            left; categorical position b: the first b + 1 bins of the
            node's order (engine.py:243-287)."""
            left = torch.cumsum(h, dim=2)
            if cat_any:
                order = cat_order(h, fbins_t)                       # (k, F, B)
                sorted_h = h.gather(2, order[..., None].expand(h.shape))
                left = torch.where(is_cat_f[:, None, None], torch.cumsum(sorted_h, dim=2), left)
            gl, hl, cl = left.unbind(-1)                            # (k, F, B)
            ng, nh, nc = (tot[:, c, None, None] for c in range(3))
            gr, hr, cr = ng - gl, nh - hl, nc - cl
            ok = (
                valid
                & (cl >= cfg.min_data_in_leaf)
                & (cr >= cfg.min_data_in_leaf)
                & (hl >= cfg.min_sum_hessian_in_leaf)
                & (hr >= cfg.min_sum_hessian_in_leaf)
            )
            parent = _leaf_objective(ng, nh, l1, l2)
            gain = (_leaf_objective(gl, hl, l1, l2)
                    + _leaf_objective(gr, hr, l1, l2) - parent)
            if cat_any:
                gain_cat = (_leaf_objective(gl, hl, l1, l2c) + _leaf_objective(gr, hr, l1, l2c)
                            - _leaf_objective(ng, nh, l1, l2c))
                gain = torch.where(is_cat_f[:, None], gain_cat, gain)
            return torch.where(ok, gain, _NEG_INF)

        # -- voting-parallel feature selection, once a tree -------------
        sel_ids = None          # (2k,) the voted features, most votes first
        tot_feat = None         # a kept feature, whose bins sum to the totals
        if voting:
            h_local = local_hist(sample_mask)
            vb = valid_base & (feature_mask[:, None] > 0)
            gains_f = gains(h_local[None], h_local[0].sum(dim=0)[None], vb)[0].amax(dim=1)
            k2 = min(2 * cfg.voting_top_k, num_features)
            # lax.top_k: descending, the lower index first on ties (-inf
            # fillers, duplicate columns)
            top_gains, top_ids = torch.sort(gains_f, descending=True, stable=True)
            top_gains, top_ids = top_gains[:k2], top_ids[:k2]
            # a -inf candidate is a filler, not a proposal: it does not vote
            ballots = (top_gains > _NEG_INF).to(torch.float32)
            votes = torch.zeros(num_features, dtype=torch.float32, device=dev).index_add_(
                0, top_ids, ballots)
            votes = psum(votes, mesh)
            # more votes first, then the lower feature id: no two scores tie
            sel_score = votes * (num_features + 1) - torch.arange(
                num_features, device=dev, dtype=torch.float32)
            sel_ids = torch.sort(sel_score, descending=True, stable=True).indices[:k2]
            sel_vec = torch.zeros(num_features, dtype=torch.float32, device=dev).index_fill_(
                0, sel_ids, 1.0)
            feature_mask = feature_mask * sel_vec
            tot_feat = torch.argmin(-sel_vec).view(1)               # the first kept feature

        def hist_for(mask, h=None):
            h = local_hist(mask) if h is None else h
            if sel_ids is not None:
                # only the voted features' histograms cross the mesh
                return torch.zeros_like(h).index_copy_(0, sel_ids, merge(h.index_select(0, sel_ids)))
            if mesh is not None:
                return merge(h)
            return h                                                 # (F, B, 3)

        def totals(h):
            # summing one kept feature's bins over a node gives the node
            # totals (every row lands in exactly one bin per feature)
            if tot_feat is None:
                return h[:, 0].sum(dim=1)                            # (k, 3)
            return h.index_select(1, tot_feat)[:, 0].sum(dim=1)

        valid_bin = valid_base & (feature_mask[:, None] > 0)         # (F, B)

        def best_splits(h, tot):
            """h (k, F, B, 3), tot (k, 3) -> per node (gain, feature, bin)."""
            gain = gains(h, tot, valid_bin).reshape(h.shape[0], -1)
            flat = gain.argmax(dim=1)          # first index on ties, like JAX
            return (gain.gather(1, flat[:, None])[:, 0],
                    flat // num_bins, flat % num_bins)

        # -- state ------------------------------------------------------
        feature = torch.full((m,), -1, dtype=torch.long, device=dev)
        thr = torch.zeros(m, dtype=torch.long, device=dev)
        left = torch.full((m,), -1, dtype=torch.long, device=dev)
        right = torch.full((m,), -1, dtype=torch.long, device=dev)
        is_cat = torch.zeros(m, dtype=torch.bool, device=dev)
        cat_bitset = torch.zeros((m, num_bins), dtype=torch.bool, device=dev)
        is_leaf = node_ids == 0
        gain = torch.zeros(m, dtype=torch.float32, device=dev)
        depth = torch.zeros(m, dtype=torch.long, device=dev)
        node_of_row = torch.zeros(n, dtype=torch.long, device=dev)
        hists = torch.zeros((m, num_features, num_bins, 3), dtype=torch.float32,
                            device=dev)
        root = hist_for(sample_mask, h_local if voting else None)
        hists[0].copy_(root)
        g0, f0, b0 = best_splits(root[None], totals(root[None]))
        best_gain = torch.where(is_leaf, g0, _NEG_INF)
        best_f = torch.where(is_leaf, f0, 0)
        best_b = torch.where(is_leaf, b0, 0)
        num_nodes = torch.ones(1, dtype=torch.long, device=dev)
        done = torch.zeros(1, dtype=torch.bool, device=dev)

        for _ in range(nl - 1):
            # the split is computed unconditionally and every update is
            # gated on `act`; trees that run out of gain keep stepping
            splittable = is_leaf & (depth < max_depth) & (best_gain > cfg.min_gain_to_split)
            cand = torch.where(splittable, best_gain, _NEG_INF)
            p = cand.argmax().view(1)
            cand_p = cand.gather(0, p)
            done = done | (cand_p <= cfg.min_gain_to_split) | (cand_p == _NEG_INF)
            act = ~done                                             # (1,)
            f = best_f.gather(0, p)
            b = best_b.gather(0, p)
            # clamp so an inactive step still indexes in bounds; node nl_id
            # has no rows yet when active, and all writes are gated when not
            nl_id = num_nodes.clamp(max=m - 2)
            nr_id = nl_id + 1
            col = bins.index_select(1, f)[:, 0]
            if cat_any:
                # the winning prefix of the node's order as a bitset over
                # bins: cat_order on the stored node histogram gives the
                # gain scan's order (engine.py:409-423)
                cat = is_cat_f.index_select(0, f)                   # (1,)
                h_pf = hists.index_select(0, p)[0].index_select(0, f)[0]    # (B, 3)
                order_f = cat_order(h_pf, fbins_t.index_select(0, f)[0])
                bitset = torch.zeros(num_bins, dtype=torch.bool, device=dev).scatter(
                    0, order_f, bin_pos <= b) & cat
                go_left = torch.where(cat, bitset.gather(0, col.long()), col <= b)
            else:
                go_left = col <= b
            in_p = (node_of_row == p) & act
            node_of_row = torch.where(
                in_p, torch.where(go_left, nl_id, nr_id), node_of_row)
            lh = hist_for(sample_mask * ((node_of_row == nl_id) & act))
            rh = hists.index_select(0, p)[0] - lh
            children = torch.cat([nl_id, nr_id])
            old = hists.index_select(0, children)
            hists.index_copy_(0, children, torch.stack(
                [torch.where(act, lh, old[0]), torch.where(act, rh, old[1])]))
            at_p = (node_ids == p) & act
            at_l = (node_ids == nl_id) & act
            at_r = (node_ids == nr_id) & act
            feature = torch.where(at_p, f, feature)
            thr = torch.where(at_p, b, thr)
            if cat_any:
                is_cat = torch.where(at_p, cat, is_cat)
                cat_bitset = torch.where(at_p[:, None], bitset, cat_bitset)
            left = torch.where(at_p, nl_id, left)
            right = torch.where(at_p, nr_id, right)
            is_leaf = (is_leaf & ~at_p) | at_l | at_r
            gain = torch.where(at_p, best_gain.gather(0, p), gain)
            depth = torch.where(at_l | at_r, depth.gather(0, p) + 1, depth)
            # refresh the cached best splits of the two new leaves
            h2 = hists.index_select(0, children)
            g2, f2, b2 = best_splits(h2, totals(h2))
            best_gain = torch.where(at_l, g2[0], torch.where(
                at_r, g2[1], torch.where(at_p, _NEG_INF, best_gain)))
            best_f = torch.where(at_l, f2[0], torch.where(at_r, f2[1], best_f))
            best_b = torch.where(at_l, b2[0], torch.where(at_r, b2[1], best_b))
            num_nodes = num_nodes + 2 * act.long()

        # leaf values (shrunk), from the final per-node totals
        tot = totals(hists)
        leaf_val = -_l1_threshold(tot[:, 0], l1) / (tot[:, 1] + l2 + 1e-12)
        leaf_val = torch.where(is_leaf, leaf_val * cfg.learning_rate, 0.0)
        tree = TreeArrays(
            feature=feature.int(),
            threshold_bin=thr.int(),
            is_categorical=is_cat,
            left=left.int(),
            right=right.int(),
            value=leaf_val.to(torch.float32),
            is_leaf=is_leaf,
            gain=gain,
            cat_bitset=cat_bitset,
        )
        return tree, leaf_val.gather(0, node_of_row), node_of_row.int()

    return grow
