"""Booster: the trained GBDT model — array-of-trees SoA + batched predict.

Counterpart of mmlspark_tpu/gbdt/booster.py. Reference:
src/lightgbm/src/main/scala/LightGBMBooster.scala:15-181 (model string,
predict) and TrainUtils.scala:74-121 (boosting loop).

Training (`Booster.train`) bins on the host and moves the bin matrix to
the fit's device once, or with `device_binning` moves the raw values and
bins them there (`BinMapper.transform_device`), then runs the boosting loop
of fused.py on that device; the trees come back in one transfer at the end.
A Booster remembers the torch device it was trained on (`Booster.device`)
and scores there; `Booster.to(device)` moves it. Scoring is the batched
gather-walk (`_traverse_fn`) on that device, the fused bin -> traverse
program (`device_predict_fn`, raw f32 values to margins on the device, the
same walk), or the host walk (`_predict_raw_host`, native C++ with a numpy
path) for small batches; all add the trees' values in tree order in
float32, so they agree bit for bit.

The fit covers every objective, multiclass included, on one device, under
gbdt, goss, rf and dart, with bagging, feature sampling, early stopping on
validation data, warm start from `init_model`, categorical features
(`categorical_indexes`: many-vs-many subset splits) and any `max_bin`
(bins stored as int32 where uint8 cannot hold them, with the reference's
warning); its random draws are `jax.random`'s bits (core/prng.py), so a
seeded fit grows the JAX package's trees. Checkpoints, the mesh and voting
raise NotImplementedError naming the ROADMAP item that ports them. The
JSON model format (`to_text`/`from_text`) is the JAX package's, field for
field, so models move between the two packages; the torch device is not
part of it.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..core.kernels import resolve_device
from .binning import BinMapper, bin_on_device
from .engine import GrowConfig
from .objectives import get_leaf_renewal, get_objective, get_validation_loss, init_raw_score

__all__ = ["Booster", "TrainOptions", "booster_from_arrays"]

_FORMAT_VERSION = 2   # v2: many-vs-many categorical subset splits (cat_sets)

_TREE_FIELDS = ("feature", "threshold_bin", "is_categorical", "left", "right",
                "value", "gain", "cat_bitset")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md Queue 1, {item!r}")


@dataclass
class TrainOptions:
    """Training hyperparameters (reference: the 19 params of
    src/lightgbm/src/main/scala/LightGBMParams.scala:11-149), the JAX
    package's TrainOptions plus `device`."""

    objective: str = "regression"
    boosting_type: str = "gbdt"       # gbdt | rf | dart | goss
    tree_learner: str = "data_parallel"
    top_k: int = 20
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_bin: int = 255
    bin_construct_sample_cnt: int = 200_000
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_seed: int = 2
    top_rate: float = 0.2
    other_rate: float = 0.1
    drop_rate: float = 0.1
    drop_seed: int = 4
    alpha: float = 0.9
    tweedie_variance_power: float = 1.5
    fair_c: float = 1.0
    num_class: int = 1
    boost_from_average: bool = True
    is_unbalance: bool = False
    early_stopping_round: int = 0
    deterministic: bool = False       # one device: every fit is exact already
    categorical_indexes: tuple[int, ...] = ()
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    device_binning: bool = False
    # device storage dtype of the binned matrix: "int32" or "uint8" (the
    # histogram kernel reads it narrow: 4x fewer bytes per pass)
    bin_dtype: str = "int32"
    init_model: "Booster | None" = None
    checkpoint_dir: "str | None" = None
    checkpoint_every_n: int = 0
    seed: int = 0
    # torch device of the fit; "cuda" raises when no card is present
    device: str = "cuda"


def _check_supported(opts: TrainOptions, mesh) -> None:
    """Reject every option the port does not run yet, before any work."""
    tl = str(opts.tree_learner)
    if tl not in ("serial", "data", "data_parallel", "voting", "voting_parallel"):
        raise ValueError(
            f"tree_learner={tl!r} is not supported; use data_parallel or "
            "voting_parallel (LightGBMParams.scala:12-14)")
    if opts.boosting_type not in ("gbdt", "rf", "dart", "goss"):
        raise ValueError(
            f"boosting_type={opts.boosting_type!r} is not supported; "
            "use gbdt, rf, dart, or goss (LightGBMParams.scala:56-60)")
    if opts.checkpoint_dir:
        raise _not_ported("checkpoint_dir", "checkpoints")
    if mesh is not None or tl.startswith("voting"):
        raise _not_ported("mesh and voting-parallel training", "distributed GBDT")
    if opts.bin_dtype not in ("int32", "uint8"):
        raise ValueError(f"bin_dtype must be 'int32' or 'uint8', got {opts.bin_dtype!r}")


def _scale_tree(t: dict[str, np.ndarray], scale: float) -> dict[str, np.ndarray]:
    """The tree with its leaf values times `scale` (float32 values, the
    scale rounded to float32, as numpy multiplies them)."""
    return {**t, "value": np.asarray(t["value"]) * scale}


def _threshold_values(mapper: BinMapper, feature, thr_bin, is_cat) -> np.ndarray:
    """Raw-space thresholds of the numeric splits — one vectorized
    (feature, bin) lookup over all (tree, node) pairs; categorical nodes
    have no single raw threshold (NaN), leaves 0."""
    ub = np.asarray(mapper.upper_bounds, np.float64)        # (F, B)
    split = feature >= 0
    fidx = np.where(split, feature, 0)
    bidx = np.minimum(thr_bin, ub.shape[1] - 1)
    return np.where(split, np.where(is_cat, np.nan, ub[fidx, bidx]), 0.0)


@dataclass
class Booster:
    """Immutable trained model. Trees are stacked SoA arrays (T, M) on the
    host; `device` is where the batched traversal runs."""

    feature: np.ndarray          # (T, M) int32
    threshold_bin: np.ndarray    # (T, M) int32
    threshold_value: np.ndarray  # (T, M) float64 — raw-space numeric threshold
    is_categorical: np.ndarray   # (T, M) bool
    left: np.ndarray             # (T, M) int32
    right: np.ndarray            # (T, M) int32
    value: np.ndarray            # (T, M) float32 (shrunk leaf values)
    gain: np.ndarray             # (T, M) float32
    tree_class: np.ndarray       # (T,) int32 — class id per tree (multiclass)
    # (T, M, Bc) bool — bins routed LEFT at categorical nodes; Bc=1
    # placeholder for models with no categorical splits
    cat_bitset: np.ndarray
    bin_mapper: BinMapper
    objective: str = "regression"
    num_class: int = 1
    init_score: float = 0.0
    best_iteration: int = -1
    feature_names: list[str] = field(default_factory=list)
    class_labels: list[float] | None = None   # original classifier label values
    device: str = "cuda"
    _predict_cache: dict = field(default_factory=dict, repr=False, compare=False)

    # ------------------------------------------------------------------ #
    # training                                                           #
    # ------------------------------------------------------------------ #

    @staticmethod
    def train(
        x: np.ndarray,
        y: np.ndarray,
        opts: TrainOptions,
        weights: np.ndarray | None = None,
        valid: tuple[np.ndarray, np.ndarray] | None = None,
        mesh=None,
        feature_names: list[str] | None = None,
        log: Callable[[str], None] | None = None,
    ) -> "Booster":
        from .fused import FusedTrainSpec, make_fused_dart_fn, make_fused_train_fn
        from .sparse import as_features, is_sparse

        _check_supported(opts, mesh)
        obj_fn = get_objective(opts.objective, alpha=opts.alpha,
                               tweedie_variance_power=opts.tweedie_variance_power,
                               fair_c=opts.fair_c)
        device = resolve_device(opts.device)
        x = as_features(x)  # CSR stays sparse until binning (binned-dense path)
        y = np.asarray(y, dtype=np.float64)
        n, f = x.shape
        k = opts.num_class if opts.objective == "multiclass" else 1
        # warm start: the warm model's bins, and its scores on this device
        warm = None if opts.init_model is None else opts.init_model.to(device)
        if warm is not None:
            mapper = warm.bin_mapper
        else:
            mapper = BinMapper(
                max_bin=opts.max_bin,
                categorical_indexes=tuple(opts.categorical_indexes),
                bin_construct_sample_cnt=opts.bin_construct_sample_cnt,
            ).fit(x)
        num_bins = max(int(mapper.num_bins.max(initial=2)), 2)
        use_u8 = opts.bin_dtype == "uint8"
        if use_u8 and num_bins > 256:
            # before either binning branch narrows, which would wrap; the
            # reference's warning and int32 storage (booster.py:231-245)
            warnings.warn(
                f"bin_dtype='uint8' requested but the bin mapper produces "
                f"{num_bins} bins (> 256); storing bins as int32",
                stacklevel=2,
            )
            if log:
                log(f"bin_dtype='uint8' unavailable at {num_bins} bins; using int32")
            use_u8 = False
        if opts.device_binning and not mapper.category_maps and not is_sparse(x):
            # the device compares in f32: snap a copy of the boundaries
            # through f32 first, so that scoring (host f64 searchsorted)
            # routes against the thresholds the training matrix was binned
            # with (booster.py:205-215 of the reference)
            mapper = copy.copy(mapper)
            mapper.upper_bounds = np.float64(np.float32(mapper.upper_bounds))
            bins_dev = mapper.transform_device(x, device).to(
                torch.uint8 if use_u8 else torch.int32)
        else:
            # narrowed on the host: a quarter of the bytes to the card
            bins_dev = torch.as_tensor(
                mapper.transform(x).astype(np.uint8 if use_u8 else np.int32), device=device)

        w = np.ones(n, np.float64) if weights is None else np.asarray(weights, np.float64)
        if opts.is_unbalance and opts.objective == "binary":
            # reference is_unbalance: scale positive class by neg/pos ratio
            npos = max(float((y == 1).sum()), 1.0)
            nneg = max(float((y == 0).sum()), 1.0)
            w = np.where(y == 1, w * nneg / npos, w)
        base_mask = torch.as_tensor(w.astype(np.float32), device=device)

        rf = opts.boosting_type == "rf"
        cfg = GrowConfig(
            num_leaves=opts.num_leaves,
            max_depth=opts.max_depth,
            max_bin=opts.max_bin,
            min_data_in_leaf=float(opts.min_data_in_leaf),
            min_sum_hessian_in_leaf=opts.min_sum_hessian_in_leaf,
            lambda_l1=opts.lambda_l1,
            lambda_l2=opts.lambda_l2,
            min_gain_to_split=opts.min_gain_to_split,
            learning_rate=1.0 if rf else opts.learning_rate,
            deterministic=opts.deterministic,
            cat_smooth=opts.cat_smooth,
            cat_l2=opts.cat_l2,
            max_cat_threshold=opts.max_cat_threshold,
        )
        cat_mask = np.zeros(f, bool)
        cat_mask[[int(i) for i in opts.categorical_indexes]] = True
        renewal = get_leaf_renewal(opts.objective, alpha=opts.alpha)
        renew_alpha, renew_weighted = renewal if renewal else (None, False)
        if k > 1:
            init = 0.0
            y_fit = np.eye(k)[y.astype(int)]                        # (n, K)
            pred0 = torch.zeros((n, k), dtype=torch.float32, device=device)
        else:
            init = (warm.init_score if warm is not None else
                    init_raw_score(opts.objective, y, w, opts.boost_from_average, opts.alpha))
            y_fit = y
            pred0 = torch.full((n,), init, dtype=torch.float32, device=device)
        trees: list[dict[str, np.ndarray]] = []
        tree_classes: list[int] = []
        if warm is not None:
            tree_classes = [int(c) for c in warm.tree_class]
            if rf:
                # rf trees are independent of pred: keep pred at init, and
                # undo the 1/T_prev scale of the saved trees so that the
                # final 1/T_total rescale is right (reference :322-329)
                n_prev = max(warm.num_trees // k, 1)
                trees = [_scale_tree(warm._tree_dict(t), float(n_prev))
                         for t in range(warm.num_trees)]
            else:
                raw = warm.predict_raw(x)
                pred0 = torch.as_tensor(raw, dtype=torch.float32, device=device).reshape(
                    pred0.shape)
                trees = [warm._tree_dict(t) for t in range(warm.num_trees)]
        start_iter = len(trees) // k

        # a nonzero master `seed` derives the per-purpose seeds (LightGBM's
        # Config; reference :338-350)
        bag_seed, feat_seed, drop_seed = (
            opts.bagging_seed, opts.feature_fraction_seed, opts.drop_seed)
        if opts.seed:
            dr = np.random.default_rng(opts.seed)
            bag_seed, feat_seed, drop_seed = (int(dr.integers(2**31)) for _ in range(3))

        # early stopping: rf trees are independent, and single-class dart
        # rescales its trees after the fit, so neither stops early
        single_dart = opts.boosting_type == "dart" and k == 1
        es_asked = valid is not None and opts.early_stopping_round > 0
        es_active = es_asked and not (rf or single_dart)
        if es_asked and not es_active and log:
            log(f"early stopping is not supported for boosting_type={opts.boosting_type}; ignored")
        val, val_loss_fn, best_iter = None, None, -1
        if es_active:
            xv = as_features(valid[0])
            yv = np.asarray(valid[1], np.float64)
            val_bins = torch.as_tensor(mapper.transform(xv).astype(np.int32), device=device)
            if warm is not None:
                # the validation margins start from the warm model's trees
                val_raw = torch.as_tensor(warm.predict_raw(xv), dtype=torch.float32,
                                          device=device)
            elif k > 1:
                val_raw = torch.zeros((len(yv), k), dtype=torch.float32, device=device)
            else:
                val_raw = torch.full((len(yv),), init, dtype=torch.float32, device=device)
            y_val = (torch.as_tensor(yv.astype(np.int64), device=device) if k > 1
                     else torch.as_tensor(yv, dtype=torch.float32, device=device))
            val = (val_bins, y_val, val_raw)
            val_loss_fn = get_validation_loss(
                opts.objective, alpha=opts.alpha,
                tweedie_variance_power=opts.tweedie_variance_power)

        # the round index restarts at 0 after a warm start (no checkpoints)
        num_rounds = opts.num_iterations - start_iter
        if num_rounds > 0:
            spec = FusedTrainSpec(
                num_rounds=num_rounds, num_class=k,
                # multiclass dart runs the gbdt loop: its drop algebra is
                # single-model (reference :396-397, :432-435)
                boosting_type="gbdt" if opts.boosting_type == "dart" and k > 1
                else opts.boosting_type,
                bagging_fraction=opts.bagging_fraction, bagging_freq=opts.bagging_freq,
                feature_fraction=opts.feature_fraction, top_rate=opts.top_rate,
                other_rate=opts.other_rate,
                early_stopping_round=opts.early_stopping_round if es_active else 0,
                drop_rate=opts.drop_rate, renew_alpha=renew_alpha,
                renew_weighted=renew_weighted)
            y_dev = torch.as_tensor(y_fit, dtype=torch.float32, device=device)
            if log:
                log(f"boosting: {num_rounds} rounds x {k} class(es) of "
                    f"{opts.boosting_type} on {device}")
            if single_dart:
                fused = make_fused_dart_fn(f, num_bins, cfg, mapper.num_bins, cat_mask,
                                           obj_fn, spec, device=device)
                t_stack, w_dev, _ = fused(bins_dev, y_dev, base_mask, pred0,
                                          drop_seed, bag_seed, feat_seed)
                tree_weights = w_dev.cpu().numpy().astype(np.float64)
                kept = num_rounds
            else:
                fused = make_fused_train_fn(f, num_bins, cfg, mapper.num_bins, cat_mask,
                                            obj_fn, spec, device=device,
                                            val_loss_fn=val_loss_fn)
                # one key for every draw (reference :462)
                seed = opts.seed if opts.seed else opts.bagging_seed
                t_stack, _, (best_dev, stopped_dev) = fused(bins_dev, y_dev, base_mask, pred0,
                                                             seed, val)
                tree_weights = None
                kept = int(t_stack.feature.shape[0])
                if es_active:
                    r_best = int(best_dev)
                    if bool(stopped_dev) and r_best >= 0:
                        kept = r_best + 1
                        if log:
                            log(f"early stop after round {r_best + start_iter} "
                                f"(kept {kept}/{num_rounds} rounds)")
                    best_iter = start_iter + r_best if r_best >= 0 else -1
            t_host = {name: getattr(t_stack, name).cpu().numpy() for name in _TREE_FIELDS}
            for r in range(kept):
                for cls in range(k):
                    idx = (r, cls) if k > 1 else (r,)
                    tree = {name: t_host[name][idx] for name in _TREE_FIELDS}
                    if tree_weights is not None:
                        tree = _scale_tree(tree, float(tree_weights[r]))
                    trees.append(tree)
                    tree_classes.append(cls)
        if rf and trees:
            scale = 1.0 / max(len(trees) // k, 1)   # rf averages its trees
            trees = [_scale_tree(t, scale) for t in trees]
        out = Booster._from_tree_dicts(
            trees, tree_classes, mapper, opts, init, feature_names or [],
            device=str(device))
        out.best_iteration = best_iter
        return out

    # ------------------------------------------------------------------ #
    # construction helpers                                               #
    # ------------------------------------------------------------------ #

    def _tree_dict(self, t: int) -> dict[str, np.ndarray]:
        return {name: getattr(self, name)[t] for name in _TREE_FIELDS}

    @staticmethod
    def _from_tree_dicts(
        trees: list[dict[str, np.ndarray]],
        tree_classes: list[int],
        mapper: BinMapper,
        opts: TrainOptions,
        init: float,
        feature_names: list[str],
        device: str = "cuda",
    ) -> "Booster":
        num_class = opts.num_class if opts.objective == "multiclass" else 1
        if not trees:
            m = 2 * opts.num_leaves - 1
            z = lambda dt, fill=0: np.full((0, m), fill, dt)  # noqa: E731
            return Booster(
                feature=z(np.int32, -1), threshold_bin=z(np.int32),
                threshold_value=z(np.float64), is_categorical=z(bool),
                left=z(np.int32, -1), right=z(np.int32, -1),
                value=z(np.float32), gain=z(np.float32),
                cat_bitset=np.zeros((0, m, 1), bool),
                tree_class=np.zeros(0, np.int32), bin_mapper=mapper,
                objective=opts.objective, num_class=num_class,
                init_score=init, feature_names=feature_names, device=device,
            )
        stack = lambda key: np.stack([np.asarray(t[key]) for t in trees])  # noqa: E731
        feature = stack("feature").astype(np.int32)
        thr_bin = stack("threshold_bin").astype(np.int32)
        is_cat = stack("is_categorical").astype(bool)
        # per-node category bitsets, padded to the widest, collapsed to a
        # width-1 placeholder when the model has no categorical splits
        bitsets = [np.asarray(t["cat_bitset"], bool) for t in trees]
        bc = max(b.shape[-1] for b in bitsets)
        cat_bitset = np.stack([
            np.pad(b, ((0, 0), (0, bc - b.shape[-1]))) for b in bitsets
        ])
        if not is_cat.any():
            cat_bitset = cat_bitset[:, :, :1]
        return Booster(
            feature=feature,
            threshold_bin=thr_bin,
            threshold_value=_threshold_values(mapper, feature, thr_bin, is_cat),
            is_categorical=is_cat,
            cat_bitset=cat_bitset,
            left=stack("left").astype(np.int32),
            right=stack("right").astype(np.int32),
            value=stack("value").astype(np.float32),
            gain=stack("gain").astype(np.float32),
            tree_class=np.asarray(tree_classes, np.int32),
            bin_mapper=mapper,
            objective=opts.objective,
            num_class=num_class,
            init_score=init,
            feature_names=feature_names,
            device=device,
        )

    def to(self, device: "str | torch.device") -> "Booster":
        """The same model scoring on `device` (PyTorch's idiom). A "cuda"
        device that is not present raises RuntimeError."""
        return dataclasses.replace(
            self, device=str(resolve_device(device)), _predict_cache={})

    # ------------------------------------------------------------------ #
    # prediction                                                         #
    # ------------------------------------------------------------------ #

    @property
    def num_trees(self) -> int:
        return int(self.feature.shape[0])

    @property
    def num_features(self) -> int:
        return self.bin_mapper.num_features

    def _tree_params(self, dev: torch.device) -> dict[str, torch.Tensor]:
        """The tree SoA on `dev` in blocks of up to 64 trees: (blocks, block,
        M) fields (bitset (blocks, block, M * Bc)), the last block padded
        with leaf-only trees that `_walk` never adds."""
        t_total = self.num_trees
        block = min(64, max(t_total, 1))
        pad = (-t_total) % block

        def blocked(a, dtype, fill=0):
            a = np.asarray(a)
            if pad:
                a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
            a = np.ascontiguousarray(a).reshape((-1, block) + a.shape[1:])
            return torch.as_tensor(a, device=dev).to(dtype)

        return dict(
            feature=blocked(self.feature, torch.long, -1),
            thr=blocked(self.threshold_bin, torch.long),
            cat=blocked(self.is_categorical, torch.bool),
            bitset=blocked(self.cat_bitset.reshape(t_total, -1), torch.bool),
            left=blocked(self.left, torch.long, -1),
            right=blocked(self.right, torch.long, -1),
            value=blocked(self.value, torch.float32),
            cls=blocked(self.tree_class, torch.long),
        )

    def _walk(self, trees: dict[str, torch.Tensor], bins: torch.Tensor) -> torch.Tensor:
        """Margins of binned rows (n, F) on their device from `_tree_params`:
        the trees of a block walk together (one gather per step for the
        whole block), `max_steps` steps deep (a fixed bound); then each
        tree's values are added in tree order, one f32 add a tree, so the
        sum matches the host walk bit for bit (a reduction kernel would fix
        no order)."""
        dev = bins.device
        n = bins.shape[0]
        k = self.num_class
        t_total = self.num_trees
        max_steps = int(self.feature.shape[1] // 2 + 1)  # deepest leaf-wise chain
        bc = int(self.cat_bitset.shape[-1])
        cols = bins.long().t()                                   # (F, n)
        out = (torch.zeros((n, k), dtype=torch.float32, device=dev) if k > 1
               else torch.full((n,), self.init_score, dtype=torch.float32, device=dev))
        num_blocks, block = trees["feature"].shape[:2]
        for bi in range(num_blocks):
            feature, thr, cat = trees["feature"][bi], trees["thr"][bi], trees["cat"][bi]
            bitset, left, right = trees["bitset"][bi], trees["left"][bi], trees["right"][bi]
            node = torch.zeros((block, n), dtype=torch.long, device=dev)
            for _ in range(max_steps):
                feat = feature.gather(1, node)
                # explicit clamps: JAX clamps out-of-range gathers itself
                col = cols.gather(0, feat.clamp(min=0))
                go_left = torch.where(cat.gather(1, node),
                                      bitset.gather(1, node * bc + col.clamp(max=bc - 1)),
                                      col <= thr.gather(1, node))
                node = torch.where(feat < 0, node, torch.where(
                    go_left, left.gather(1, node), right.gather(1, node)))
            vals = trees["value"][bi].gather(1, node)            # (block, n)
            for j in range(min(block, t_total - bi * block)):
                if k > 1:
                    # one add into the tree's class column (a 0-d index
                    # tensor would read back to the host)
                    out.index_add_(1, trees["cls"][bi, j:j + 1], vals[j][:, None])
                else:
                    out = out + vals[j]
        return out

    def _traverse_fn(self):
        """Batched traversal over binned inputs on `self.device`:
        bins (n, F) -> margins (n,) or (n, K), by `_walk`."""
        dev = resolve_device(self.device)
        key = ("traverse", str(dev))
        if key not in self._predict_cache:
            trees = self._tree_params(dev)
            self._predict_cache[key] = lambda bins: self._walk(trees, bins)
        return self._predict_cache[key]

    def device_predict_fn(self):
        """(params, fn): the fused decode -> bin -> traverse scoring program
        (reference booster.py:969). `fn(params, x)` takes raw values (n, F)
        (numpy or a tensor, cast to f32) and returns the margins as a tensor
        on the booster's device; params hold the binning keys, `nb` and the
        blocked tree SoA as tensors there, so they move to the card once.

        Binning is one `torch.searchsorted` per (row, feature) over
        ADJUSTED f32 boundary keys: key = the f32 value below f32(ub) where
        f32(ub) rounded up, else f32(ub). For f32-representable x,
        key < x <=> ub < x, so the bins equal the host's f64
        searchsorted(ub, x, 'left') bit for bit; the walk is `_walk`, as in
        `_traverse_fn`. So for such x the margins equal
        `predict_raw(device="device")` bit for bit. Categorical features
        are refused."""
        mapper = self.bin_mapper
        if mapper.category_maps:
            raise ValueError("device predict does not support categorical features")
        dev = resolve_device(self.device)
        ub64 = np.asarray(mapper.upper_bounds[:, 1:max(mapper.total_bins, 2)], np.float64)
        ub32 = ub64.astype(np.float32)
        rounded_up = ub32.astype(np.float64) > ub64
        # +inf padding keeps the key +inf and never counts; a finite ub
        # beyond the f32 range maps to the largest f32
        keys = np.where(rounded_up, np.nextafter(ub32, np.float32(-np.inf)), ub32)
        params = dict(keys=torch.as_tensor(keys, device=dev),
                      nb=torch.as_tensor(mapper.num_bins, dtype=torch.int32, device=dev),
                      trees=self._tree_params(dev))

        def fn(params, x):
            xt = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, np.float32))
            xt = xt.to(device=params["keys"].device, dtype=torch.float32)
            bins = bin_on_device(params["keys"], params["nb"], xt)
            return self._walk(params["trees"], bins)

        return params, fn

    # Below this row count one walk on the host costs less than the device
    # dispatches (the latency-path analogue of LightGBM's per-row CPU
    # predict, LightGBMBooster.scala:21-113); both paths agree bit for bit.
    HOST_PREDICT_MAX_ROWS = 512

    def _predict_raw_host(self, bins: np.ndarray) -> np.ndarray:
        n = bins.shape[0]
        k = self.num_class
        max_steps = int(self.feature.shape[1] // 2 + 1)
        # native per-row scoring (mmlspark_tpu_torch/native), bit-identical
        # to the numpy walk below; the prepared closure caches the immutable
        # tree arrays' ctypes marshalling
        fn = self._predict_cache.get("host_fn")
        if fn is None:
            from ..native import make_tree_predictor

            fn = make_tree_predictor(
                self.feature, self.threshold_bin, self.is_categorical,
                self.left, self.right, self.value, self.tree_class,
                k, max_steps, self.init_score, self.cat_bitset,
            )
            self._predict_cache["host_fn"] = fn or False
        if fn:
            return fn(np.asarray(bins, np.int32))
        out = (np.zeros((n, k), np.float32) if k > 1
               else np.full((n,), self.init_score, np.float32))
        for t in range(self.num_trees):
            node = self._walk_tree(t, bins, max_steps)
            val = self.value[t][node].astype(np.float32)
            if k > 1:
                out[:, int(self.tree_class[t])] += val
            else:
                out = out + val
        return out

    def _walk_tree(self, t: int, bins: np.ndarray, max_steps: int) -> np.ndarray:
        """Leaf node index of every row in tree t (numpy)."""
        n = bins.shape[0]
        rows = np.arange(n)
        feature, thr = self.feature[t], self.threshold_bin[t]
        cat, left, right = self.is_categorical[t], self.left[t], self.right[t]
        bitset = self.cat_bitset[t]
        bc = bitset.shape[-1]
        node = np.zeros(n, np.int64)
        for _ in range(max_steps):
            f = np.maximum(feature[node], 0)
            col = bins[rows, f]
            go_left = np.where(cat[node],
                               bitset[node, np.minimum(col, bc - 1)],
                               col <= thr[node])
            leaf = feature[node] < 0
            node = np.where(leaf, node,
                            np.where(go_left, left[node], right[node]))
        return node

    def truncated(self, num_iteration: int) -> "Booster":
        """The model's first `num_iteration` boosting rounds (one tree a
        round, K under multiclass); num_iteration <= 0 or None means all,
        as in LightGBM. Views are cached, the 8 most recently used."""
        if num_iteration is None or int(num_iteration) <= 0:
            return self
        key = ("truncated", int(num_iteration))
        if key in self._predict_cache:
            view = self._predict_cache.pop(key)
            self._predict_cache[key] = view
            return view
        per_round = self.num_class if self.objective == "multiclass" else 1
        t = min(int(num_iteration) * per_round, self.num_trees)
        view = dataclasses.replace(
            self,
            feature=self.feature[:t], threshold_bin=self.threshold_bin[:t],
            threshold_value=self.threshold_value[:t],
            is_categorical=self.is_categorical[:t],
            cat_bitset=self.cat_bitset[:t],
            left=self.left[:t], right=self.right[:t],
            value=self.value[:t], gain=self.gain[:t],
            tree_class=self.tree_class[:t],
            best_iteration=-1,
            _predict_cache={},
        )
        self._predict_cache[key] = view
        stale = [c for c in self._predict_cache
                 if isinstance(c, tuple) and c and c[0] == "truncated"][:-8]
        for c in stale:
            del self._predict_cache[c]
        return view

    def predict_leaf(self, x: np.ndarray) -> np.ndarray:
        """Per-row leaf node index of every tree -> (n, T) int32, by the
        host walk (reference: LightGBM predict(pred_leaf=True))."""
        from .sparse import as_features

        bins = self.bin_mapper.transform(as_features(x)).astype(np.int32)
        max_steps = int(self.feature.shape[1] // 2 + 1)
        out = np.zeros((bins.shape[0], self.num_trees), np.int32)
        for t in range(self.num_trees):
            out[:, t] = self._walk_tree(t, bins, max_steps)
        return out

    def predict_raw(self, x: np.ndarray, device: str | None = None,
                    num_iteration: int | None = None) -> np.ndarray:
        """Raw margin scores: (n,) or (n, K) for multiclass, as numpy.

        `device` keeps the JAX package's meaning — the ROUTE, not the torch
        device: None = auto (host walk for batches of HOST_PREDICT_MAX_ROWS
        rows or fewer, batched traversal otherwise), "host" = the host walk,
        "device" = the batched traversal. The traversal runs on the torch
        device the booster holds (`Booster.device`, set at training or by
        `Booster.to`). `num_iteration` scores with the first N rounds."""
        from .sparse import as_features

        if num_iteration is not None:
            return self.truncated(num_iteration).predict_raw(x, device=device)
        x = as_features(x)
        if self.num_trees == 0:
            shape = (len(x), self.num_class) if self.num_class > 1 else (len(x),)
            return np.full(shape, self.init_score, np.float32)
        if device is None:
            device = "host" if len(x) <= self.HOST_PREDICT_MAX_ROWS else "device"
        if device not in ("host", "device"):
            raise ValueError(f"device must be None, 'host' or 'device', got {device!r}")
        binned = self.bin_mapper.transform(x).astype(np.int32)
        if device == "host":
            return self._predict_raw_host(binned)
        run = self._traverse_fn()
        return run(torch.as_tensor(binned, device=resolve_device(self.device))).cpu().numpy()

    def transform_score(self, raw: np.ndarray) -> np.ndarray:
        """Raw margins -> transformed prediction (sigmoid / softmax / exp
        per objective — reference LightGBMBooster.score semantics), in
        float64 on the host."""
        raw = np.asarray(raw, np.float64)
        if self.objective == "binary":
            return 1.0 / (1.0 + np.exp(-raw))
        if self.objective == "multiclass":
            e = np.exp(raw - raw.max(axis=-1, keepdims=True))
            return e / e.sum(axis=-1, keepdims=True)
        if self.objective in ("poisson", "gamma", "tweedie"):
            return np.exp(raw)
        return raw

    def predict(self, x: np.ndarray, device: str | None = None,
                num_iteration: int | None = None) -> np.ndarray:
        """Probability / transformed prediction (reference
        LightGBMBooster.score semantics)."""
        return self.transform_score(
            self.predict_raw(x, device=device, num_iteration=num_iteration))

    def feature_importances(self, importance_type: str = "split") -> np.ndarray:
        """Reference: LightGBMBooster getFeatureImportances(split|gain)."""
        imp = np.zeros(self.num_features, np.float64)
        mask = self.feature >= 0
        if importance_type == "split":
            np.add.at(imp, self.feature[mask], 1.0)
        elif importance_type == "gain":
            np.add.at(imp, self.feature[mask], self.gain[mask])
        else:
            raise ValueError("importance_type must be 'split' or 'gain'")
        return imp

    # ------------------------------------------------------------------ #
    # persistence                                                        #
    # ------------------------------------------------------------------ #

    def to_text(self) -> str:
        """Portable JSON model (reference saveNativeModel,
        LightGBMBooster.scala:115-124), the JAX package's format field for
        field. Categorical subset splits serialize sparsely: `cat_sets`
        lists `[tree, node, [left bins...]]` for categorical nodes only."""
        cat_sets = []
        for t, m in zip(*np.nonzero(self.is_categorical & (self.feature >= 0))):
            bins_left = np.nonzero(self.cat_bitset[t, m])[0]
            cat_sets.append([int(t), int(m), [int(b) for b in bins_left]])
        payload = {
            "format": "mmlspark_tpu.gbdt",
            "version": _FORMAT_VERSION,
            "objective": self.objective,
            "num_class": self.num_class,
            "init_score": self.init_score,
            "best_iteration": self.best_iteration,
            "feature_names": self.feature_names,
            "class_labels": self.class_labels,
            "tree_class": self.tree_class.tolist(),
            "trees": {
                "feature": self.feature.tolist(),
                "threshold_bin": self.threshold_bin.tolist(),
                "threshold_value": self.threshold_value.tolist(),
                "is_categorical": self.is_categorical.tolist(),
                "left": self.left.tolist(),
                "right": self.right.tolist(),
                "value": self.value.tolist(),
                "gain": self.gain.tolist(),
                "cat_bitset_width": int(self.cat_bitset.shape[-1]),
                "cat_sets": cat_sets,
            },
            "bin_mapper": self.bin_mapper.to_dict(),
        }
        return json.dumps(payload)

    @staticmethod
    def from_text(text: str, device: str = "cuda") -> "Booster":
        """Parse `to_text` output (of either package). The model scores on
        `device`; a loaded model defaults to the card."""
        d = json.loads(text)
        if d.get("format") != "mmlspark_tpu.gbdt":
            raise ValueError("not a mmlspark_tpu gbdt model")
        t = d["trees"]
        arr = lambda key, dt: np.asarray(t[key], dtype=dt)  # noqa: E731
        feature = arr("feature", np.int32)
        thr_bin = arr("threshold_bin", np.int32)
        is_cat = arr("is_categorical", bool)
        n_t, m = feature.shape
        mapper = BinMapper.from_dict(d["bin_mapper"])
        # bitset width must cover EVERY bin any categorical column can
        # produce (the traversal clamps col to bc-1), so take it from the
        # mapper, not from the split bins
        full_bc = int(max(np.asarray(mapper.num_bins).max(initial=1), 1))
        if "cat_sets" in t:
            bc = max(int(t.get("cat_bitset_width", 1)), full_bc if is_cat.any() else 1)
            cat_bitset = np.zeros((n_t, m, bc), bool)
            for tt, mm, bins_left in t["cat_sets"]:
                cat_bitset[int(tt), int(mm), np.asarray(bins_left, int)] = True
        else:
            # version-1 files: one-vs-rest categorical splits on a single
            # bin; the equivalent subset is the singleton bitset
            bc = full_bc if is_cat.any() else 1
            cat_bitset = np.zeros((n_t, m, bc), bool)
            for tt, mm in zip(*np.nonzero(is_cat & (feature >= 0))):
                cat_bitset[tt, mm, thr_bin[tt, mm]] = True
        return Booster(
            feature=feature,
            threshold_bin=thr_bin,
            threshold_value=arr("threshold_value", np.float64),
            is_categorical=is_cat,
            cat_bitset=cat_bitset,
            left=arr("left", np.int32),
            right=arr("right", np.int32),
            value=arr("value", np.float32),
            gain=arr("gain", np.float32),
            tree_class=np.asarray(d["tree_class"], np.int32),
            bin_mapper=mapper,
            objective=d["objective"],
            num_class=int(d["num_class"]),
            init_score=float(d["init_score"]),
            best_iteration=int(d.get("best_iteration", -1)),
            feature_names=list(d.get("feature_names", [])),
            class_labels=d.get("class_labels"),
            device=device,
        )

    def save_native_model(self, path: str, format: str = "json") -> None:
        """Write the model to disk in the JSON format. LightGBM's model.txt
        (`format="lightgbm"`) is a later slice."""
        if format == "lightgbm":
            raise _not_ported("LightGBM text export", "LightGBM text import and export")
        if format != "json":
            raise ValueError(f"format must be 'json' or 'lightgbm', got {format!r}")
        with open(path, "w") as fh:
            fh.write(self.to_text())

    @staticmethod
    def load_native_model(path: str, device: str = "cuda") -> "Booster":
        """Load a model saved in the JSON format. LightGBM model.txt files
        are a later slice."""
        with open(path) as fh:
            text = fh.read()
        if not text.lstrip().startswith("{"):
            raise _not_ported("LightGBM text import", "LightGBM text import and export")
        return Booster.from_text(text, device=device)


def booster_from_arrays(trees: dict[str, np.ndarray], bin_mapper: dict,
                        meta: dict[str, Any], device: str = "cuda") -> Booster:
    """A Booster from another package's weights: a GBDT's weights are its
    tree arrays and its bin boundaries.

    trees: the (T, M) arrays `feature`, `threshold_bin`, `is_categorical`,
           `left`, `right`, `value`, `gain`, the (T, M, Bc) `cat_bitset` and
           the (T,) `tree_class`, as the JAX Booster holds them;
    bin_mapper: `BinMapper.to_dict()`;
    meta: `objective`, `num_class`, `init_score`, `class_labels` (and
          optionally `feature_names`, `best_iteration`)."""
    mapper = BinMapper.from_dict(bin_mapper)
    feature = np.asarray(trees["feature"], np.int32)
    thr_bin = np.asarray(trees["threshold_bin"], np.int32)
    is_cat = np.asarray(trees["is_categorical"], bool)
    labels = meta.get("class_labels")
    return Booster(
        feature=feature,
        threshold_bin=thr_bin,
        threshold_value=_threshold_values(mapper, feature, thr_bin, is_cat),
        is_categorical=is_cat,
        cat_bitset=np.asarray(trees["cat_bitset"], bool),
        left=np.asarray(trees["left"], np.int32),
        right=np.asarray(trees["right"], np.int32),
        value=np.asarray(trees["value"], np.float32),
        gain=np.asarray(trees["gain"], np.float32),
        tree_class=np.asarray(trees["tree_class"], np.int32),
        bin_mapper=mapper,
        objective=str(meta["objective"]),
        num_class=int(meta.get("num_class", 1)),
        init_score=float(meta.get("init_score", 0.0)),
        best_iteration=int(meta.get("best_iteration", -1)),
        feature_names=list(meta.get("feature_names") or []),
        class_labels=None if labels is None else [float(c) for c in labels],
        device=device,
    )
