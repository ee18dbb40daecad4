"""Plain reference of gradient-boosted decision trees: binning, node
histograms, split gains and leaf values in float64, a leaf-wise grower,
and the walk of a LightGBM model over raw values. It imports nothing of
the program under test; it reads the program's fitted trees only to judge
them.

Semantics are LightGBM's as the configuration states them, for the binary
log loss: bin boundaries are each column's distinct values or its
equal-count quantiles over a fixed per-column sample (`bin_construct_
sample_cnt` rows), snapped through float32 for binning on the device; a
row goes left at a numeric split when its bin is at most the split's bin
(when its value is at most the threshold, for a LightGBM model); a split's
gain is G_L^2 / H_L + G_R^2 / H_R - G^2 / H, allowed when each side has at
least `min_data_in_leaf` rows and `min_sum_hessian_in_leaf` hessian; a
leaf's value is -G / H times the learning rate; leaf-wise growth splits
the leaf of largest gain until `num_leaves` leaves. The node numbering of
a grown tree is the program's: split step s makes nodes 2s + 1 (left) and
2s + 2 (right)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

CHUNK_ROWS = 1 << 20


@dataclass
class Forest:
    """Trees in the layout the program's booster keeps: (T, M) arrays,
    M = 2 * num_leaves - 1, `feature` -1 on leaves and unused nodes,
    `value` already shrunk; plus the bin boundaries and the start score."""

    feature: np.ndarray
    thr: np.ndarray
    left: np.ndarray
    right: np.ndarray
    value: np.ndarray
    bounds: np.ndarray
    init: float


# ---- binning ------------------------------------------------------------ #

def sketch(x: np.ndarray, max_bin: int, sample_cnt: int) -> tuple[np.ndarray, np.ndarray]:
    """(bounds (F, max_bin + 1) f64, with bounds[f, b] the largest value of
    bin b and +inf closing the top bin; num_bins (F,)). Bin 0 is reserved
    for missing values."""
    n, f = x.shape
    bounds = np.full((f, max_bin + 1), np.inf)
    nbins = np.zeros(f, np.int32)
    for j in range(f):
        col = np.asarray(x[:, j], np.float64)
        col = col[np.isfinite(col)]
        if 0 < sample_cnt < len(col):
            idx = np.random.default_rng(1 + j).choice(len(col), size=sample_cnt, replace=False)
            col = col[np.sort(idx)]
        uniq = np.unique(col + 0.0)
        if len(uniq) <= max_bin:
            ub = uniq
        else:
            ub = np.unique(np.quantile(col, np.linspace(0, 1, max_bin + 1)[1:], method="higher"))
        nbins[j] = len(ub) + 1
        bounds[j, 1:len(ub) + 1] = ub
        bounds[j, len(ub)] = np.inf
    return bounds, nbins


def snap_f32(bounds: np.ndarray) -> np.ndarray:
    return np.float64(np.float32(bounds))


def bin_rows(x: torch.Tensor, bounds: np.ndarray, nbins: np.ndarray) -> torch.Tensor:
    """(n, F) bins of the values x on their device, against f64 bounds."""
    out = torch.empty(x.shape, dtype=torch.int16, device=x.device)
    for j in range(x.shape[1]):
        keys = torch.as_tensor(bounds[j, 1:max(int(nbins[j]), 2)], device=x.device)
        cnt = torch.searchsorted(keys, x[:, j].double().contiguous(), right=False)
        out[:, j] = torch.clamp(cnt + 1, 1, max(int(nbins[j]) - 1, 1)).to(torch.int16)
    return out


def init_score(y: torch.Tensor) -> float:
    p = min(max(float(y.double().mean()), 1e-12), 1 - 1e-12)
    return float(np.log(p / (1 - p)))


def grad_hess(y: torch.Tensor, margin: torch.Tensor):
    p = torch.sigmoid(margin)
    return p - y.to(p.dtype), p * (1 - p)


# ---- trees over bins ---------------------------------------------------- #

def _tensors(forest: Forest, t: int, dev):
    return [torch.as_tensor(np.asarray(a[t], np.int64), device=dev)
            for a in (forest.feature, forest.thr, forest.left, forest.right)]


def leaf_of(forest: Forest, t: int, bins: torch.Tensor) -> torch.Tensor:
    """The node each row ends at in tree t."""
    feat, thr, left, right = _tensors(forest, t, bins.device)
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    rows = torch.arange(bins.shape[0], device=bins.device)
    for _ in range(len(feat)):
        f = feat[node]
        inner = f >= 0
        if not bool(inner.any()):
            break
        col = bins[rows, f.clamp(min=0)].long()
        node = torch.where(inner, torch.where(col <= thr[node], left[node], right[node]), node)
    return node


def node_hists(forest: Forest, t: int, bins: torch.Tensor, stats: torch.Tensor,
               num_bins: int) -> torch.Tensor:
    """(M, F, B, 3) sums of stats (n, 3) over the rows that reach each
    node of tree t, level by level, in the dtype of stats."""
    feat, thr, left, right = _tensors(forest, t, bins.device)
    m, (n, f) = len(feat), bins.shape
    hist = torch.zeros((m * f * num_bins, 3), dtype=stats.dtype, device=bins.device)
    offs = torch.arange(f, device=bins.device) * num_bins
    rows = torch.arange(n, device=bins.device)
    node = torch.zeros(n, dtype=torch.int64, device=bins.device)
    while rows.numel():
        for lo in range(0, rows.numel(), CHUNK_ROWS):
            r, nd = rows[lo:lo + CHUNK_ROWS], node[lo:lo + CHUNK_ROWS]
            idx = (nd[:, None] * (f * num_bins) + offs[None, :] + bins[r].long()).reshape(-1)
            hist.index_add_(0, idx, stats[r].repeat_interleave(f, dim=0))
        fr = feat[node]
        inner = fr >= 0
        rows, node, fr = rows[inner], node[inner], fr[inner]
        col = bins[rows, fr].long()
        node = torch.where(col <= thr[node], left[node], right[node])
    return hist.view(m, f, num_bins, 3)


def gains(hist: torch.Tensor, nbins: np.ndarray, cfg: dict, band: float):
    """Split gains (M, F, B) of node histograms (M, F, B, 3); `ok` where a
    split is allowed with room: its sides clear `min_sum_hessian_in_leaf`
    by more than `band` (f32 sums of the program may part from the
    reference's that close to the limit), `near` where one side lies
    within `band` of it."""
    m, f, b, _ = hist.shape
    tot = hist[:, 0].sum(dim=1)                                    # (M, 3)
    left = hist.cumsum(dim=2)
    gl, hl, cl = left.unbind(-1)
    g, h, c = (tot[:, i, None, None] for i in range(3))
    gr, hr, cr = g - gl, h - hl, c - cl
    pos = torch.arange(b, device=hist.device)[None, :] < (
        torch.as_tensor(np.asarray(nbins, np.int64), device=hist.device)[:, None] - 1)
    lim_d, lim_h = float(cfg["min_data_in_leaf"]), float(cfg["min_sum_hessian_in_leaf"])
    rows_ok = pos & (cl >= lim_d) & (cr >= lim_d)
    near = rows_ok & (((hl - lim_h).abs() <= band) | ((hr - lim_h).abs() <= band))
    ok = rows_ok & (hl >= lim_h) & (hr >= lim_h) & ~near
    gain = gl * gl / (hl + 1e-12) + gr * gr / (hr + 1e-12) - g * g / (h + 1e-12)
    return gain, ok, near, tot


def check_tree(forest: Forest, t: int, bins: torch.Tensor, y: torch.Tensor,
               margin: torch.Tensor, nbins: np.ndarray, cfg: dict) -> dict:
    """How far tree t lies from what the reference grows at the same
    margins. Compared: `split_share`, the gain the tree's split steps
    forwent (a better split at a node, a better leaf to split, a leaf left
    unsplit), summed, over the gain of its splits; `leaf_gap_w`, the leaf
    value gaps weighted by each leaf's hessian over the leaf values
    weighted alike. Reported beside them: `split_regret`, the largest
    single gain forgone over the root's gain, `leaf_gap`, the largest leaf
    gap over the largest leaf value (both swing with the float32 noise of
    one small node), and where the worst of each lies."""
    g, h = grad_hess(y, margin.double())
    stats = torch.stack([g, h, torch.ones_like(g)], dim=1)
    hist = node_hists(forest, t, bins, stats, int(np.max(nbins)))
    band = 2.0 ** -18 * float(stats[:, 1].sum())
    gain, ok, near, tot = gains(hist, nbins, cfg, band)
    best = torch.where(ok, gain, -torch.inf).flatten(1).amax(dim=1).cpu().numpy()
    feat, thr = forest.feature[t], forest.thr[t]
    left, right, value = forest.left[t], forest.right[t], forest.value[t]
    gain_np, ok_np, near_np = (a.cpu().numpy() for a in (gain, ok, near))
    root = best[0]
    if not np.isfinite(root) or root <= 0:
        return {"split_regret": np.inf, "split_share": np.inf, "leaf_gap": np.inf,
                "leaf_gap_w": np.inf, "worst": ("root", 0)}
    # the nodes of the tree and the step that split each inner one
    inner = [p for p in _reachable(feat, left, right) if feat[p] >= 0]
    leaves = [p for p in _reachable(feat, left, right) if feat[p] < 0]
    step = {p: (int(left[p]) - 1) // 2 for p in inner}
    regret, worst, forgone = 0.0, None, 0.0
    for p in inner:
        f, b = int(feat[p]), int(thr[p])
        if not (ok_np[p, f, b] or near_np[p, f, b]):
            return {"split_regret": np.inf, "split_share": np.inf, "leaf_gap": np.inf,
                    "leaf_gap_w": np.inf, "worst": ("invalid", p)}
        lost = max(best[p] - gain_np[p, f, b], 0.0)
        forgone += lost
        if lost > regret:
            regret, worst = lost, ("split", p, step[p])
        # the leaves open at this step: made before it, not split before it
        open_ = [q for q in step.keys() | set(leaves)
                 if q <= 2 * step[p] and step.get(q, np.inf) >= step[p]]
        q = max(open_, key=lambda q: best[q])
        forgone += max(best[q] - best[p], 0.0)
        if best[q] - best[p] > regret:
            regret, worst = best[q] - best[p], ("order", p, q, step[p])
    if len(inner) < cfg["num_leaves"] - 1:
        q = max(leaves, key=lambda q: best[q])
        forgone += max(best[q], 0.0)
        if best[q] > regret:
            regret, worst = best[q], ("stopped", q)
    tot = tot.cpu().numpy()
    h_leaf = tot[leaves, 1]
    ref = -tot[leaves, 0] / (h_leaf + 1e-12) * cfg["learning_rate"]
    prog = np.asarray(value, np.float64)[leaves]
    err = np.abs(prog - ref)
    wl = int(err.argmax())
    gained = sum(max(best[p], 0.0) for p in inner)
    return {"split_regret": max(regret, 0.0) / root,
            "split_share": forgone / gained,
            "leaf_gap": float(err.max() / np.abs(ref).max()),
            "leaf_gap_w": float((h_leaf * err).sum() / (h_leaf * np.abs(ref)).sum()),
            "worst": worst,
            "worst_node": None if worst is None else
            (float(tot[worst[1], 1]), float(tot[worst[1], 2])),
            "worst_leaf": (int(leaves[wl]), float(h_leaf[wl]), float(tot[leaves[wl], 2]),
                           float(err[wl]), float(ref[wl]))}


def _reachable(feat, left, right) -> list[int]:
    out, todo = [], [0]
    while todo:
        p = todo.pop()
        out.append(p)
        if feat[p] >= 0:
            todo += [int(left[p]), int(right[p])]
    return sorted(out)


def check_fit(x: np.ndarray, y: np.ndarray, fitted: Forest, trees: list[int],
              cfg: dict, device) -> dict:
    """The reference's numbers for a fit from rows x (n, F) f32 and labels
    y: `bounds_mismatch` (bin boundaries that differ from the reference's)
    and the largest of each `check_tree` number over `trees`, each tree
    judged at the margins the fit's earlier trees give (walked here), and
    each tree's own numbers under "trees"."""
    bounds, nbins = sketch(x, cfg["max_bin"], cfg["bin_construct_sample_cnt"])
    bounds = snap_f32(bounds)
    prog = np.asarray(fitted.bounds, np.float64)
    mismatch = int((prog != bounds).sum()) if prog.shape == bounds.shape else bounds.size
    xd = torch.as_tensor(x, device=device)
    bins = bin_rows(xd, bounds, nbins)
    del xd
    yd = torch.as_tensor(np.asarray(y, np.float64), device=device)
    margin = torch.full((len(y),), init_score(yd), dtype=torch.float64, device=device)
    out = {"bounds_mismatch": mismatch, "trees": {}}
    for t in range(max(trees) + 1):
        if t in trees:
            r = check_tree(fitted, t, bins, yd, margin, nbins, cfg)
            out["trees"][t] = r
            for k, v in r.items():
                if isinstance(v, float):
                    out[k] = max(out.get(k, 0.0), v)
        vals = torch.as_tensor(np.asarray(fitted.value[t], np.float64), device=device)
        margin += vals[leaf_of(fitted, t, bins)]
    return out


# ---- the control: the reference grower at a lower precision ------------- #

def grow_fit(x: np.ndarray, y: np.ndarray, cfg: dict, rounds: int, device,
             stat_dtype=torch.bfloat16, sum_dtype=torch.float32) -> Forest:
    """`rounds` trees grown leaf-wise by the reference from rows x, with
    the gradients and hessians rounded to `stat_dtype` and every sum in
    `sum_dtype`: the control, a fit one step below float32."""
    bounds, nbins = sketch(x, cfg["max_bin"], cfg["bin_construct_sample_cnt"])
    bounds = snap_f32(bounds)
    xd = torch.as_tensor(x, device=device)
    bins = bin_rows(xd, bounds, nbins)
    del xd
    yd = torch.as_tensor(np.asarray(y, np.float64), device=device)
    init = init_score(yd)
    margin = torch.full((len(y),), init, dtype=torch.float32, device=device)
    nl = cfg["num_leaves"]
    m = 2 * nl - 1
    shape = (rounds, m)
    fo = Forest(np.full(shape, -1, np.int64), np.zeros(shape, np.int64),
                np.full(shape, -1, np.int64), np.full(shape, -1, np.int64),
                np.zeros(shape, np.float64), bounds, init)
    for t in range(rounds):
        g, h = grad_hess(yd.float(), margin)
        stats = torch.stack([g.to(stat_dtype).to(sum_dtype), h.to(stat_dtype).to(sum_dtype),
                             torch.ones_like(g, dtype=sum_dtype)], 1)
        node = _grow(bins, stats, nbins, cfg, fo, t)
        margin += torch.as_tensor(fo.value[t], dtype=torch.float32, device=device)[node]
    return fo


def _grow(bins, stats, nbins, cfg, fo: Forest, t: int) -> torch.Tensor:
    n, f = bins.shape
    nb = int(np.max(nbins))
    offs = torch.arange(f, device=bins.device) * nb

    def hist_of(rows):
        hist = torch.zeros((f * nb, 3), dtype=stats.dtype, device=bins.device)
        for lo in range(0, rows.numel(), CHUNK_ROWS):
            r = rows[lo:lo + CHUNK_ROWS]
            hist.index_add_(0, (offs[None, :] + bins[r].long()).reshape(-1),
                            stats[r].repeat_interleave(f, dim=0))
        return hist.view(1, f, nb, 3)

    def best_of(hist):
        gain, ok, _, tot = gains(hist, nbins, cfg, 0.0)
        flat = torch.where(ok, gain, -torch.inf).flatten()
        i = int(flat.argmax())
        return float(flat[i]), i // nb, i % nb, tot[0].cpu().numpy()

    node = torch.zeros(n, dtype=torch.int64, device=bins.device)
    best = {0: best_of(hist_of(torch.arange(n, device=bins.device)))}
    for s in range(cfg["num_leaves"] - 1):
        p = max(best, key=lambda q: best[q][0])
        gp, fp, bp, _ = best[p]
        if not gp > cfg.get("min_gain_to_split", 0.0):
            break
        rows = (node == p).nonzero()[:, 0]
        go_left = bins[rows, fp].long() <= bp
        lid, rid = 2 * s + 1, 2 * s + 2
        node[rows[go_left]] = lid
        node[rows[~go_left]] = rid
        fo.feature[t, p], fo.thr[t, p] = fp, bp
        fo.left[t, p], fo.right[t, p] = lid, rid
        best[lid] = best_of(hist_of(rows[go_left]))
        best[rid] = best_of(hist_of(rows[~go_left]))
        best[p] = (-np.inf,) + best[p][1:]
    for q, (_, _, _, tot) in best.items():
        if fo.feature[t, q] < 0:
            fo.value[t, q] = -tot[0] / (tot[1] + 1e-12) * cfg["learning_rate"]
    return node


# ---- a LightGBM model over raw values ----------------------------------- #

def walk_lgbm(trees, x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """Raw scores (n,) of a LightGBM binary model (`inputs.lgbm_model.Trees`)
    over values x (n, F): value <= threshold goes left; the leaf values are
    added tree by tree in `dtype`, and values and thresholds compare in it."""
    dev = x.device
    xs = x.to(dtype)
    out = torch.zeros(x.shape[0], dtype=dtype, device=dev)
    rows = torch.arange(x.shape[0], device=dev)
    for t in range(trees.split_feature.shape[0]):
        sf = torch.as_tensor(trees.split_feature[t], device=dev)
        th = torch.as_tensor(trees.threshold[t], device=dev).to(dtype)
        lc = torch.as_tensor(trees.left_child[t], device=dev)
        rc = torch.as_tensor(trees.right_child[t], device=dev)
        lv = torch.as_tensor(trees.leaf_value[t], device=dev).to(dtype)
        node = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
        for _ in range(sf.numel()):
            inner = node >= 0
            if not bool(inner.any()):
                break
            nd = node.clamp(min=0)
            go = xs[rows, sf[nd]] <= th[nd]
            node = torch.where(inner, torch.where(go, lc[nd], rc[nd]), node)
        out = out + lv[~node]
    return out
