"""Booster: the trained GBDT model — array-of-trees SoA + batched predict.

Counterpart of mmlspark_tpu/gbdt/booster.py. Reference:
src/lightgbm/src/main/scala/LightGBMBooster.scala:15-181 (model string,
predict) and TrainUtils.scala:74-121 (boosting loop).

Training (`Booster.train`) bins on the host and moves the bin matrix to
the fit's device once, or with `device_binning` moves the raw values and
bins them there (`BinMapper.transform_device`), then runs the boosting loop
of fused.py on that device; the trees come back in one transfer at the end.
Inside an AutoML sweep (gbdt/shared_bins.py) a fit whose rows were seeded
takes the shared mapper and gathers its bins from the full binned matrix on
the device instead.
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
seeded fit grows the JAX package's trees. With `checkpoint_dir` and
`checkpoint_every_n` the loop runs in chunks of rounds with a snapshot
after each (resilience/elastic.py), and a fit resumes at the newest
verified snapshot with the trees an uninterrupted fit grows, byte for
byte. With a `mesh` of several shards (parallel/mesh.py, one process a
shard) every rank calls `train` on the whole table, pads the rows to a
multiple of the shards and fits on its own block of them, merging the
histograms across the mesh; every rank returns the same model, and
`tree_learner="voting_parallel"` runs the voting learner there. The JSON
model format (`to_text`/`from_text`) is
the JAX package's, field for field, so models move between the two
packages; the torch device is not part of it. LightGBM's own model.txt
is read (`from_lightgbm_text`) and written (`to_lightgbm_text`) as the
JAX package reads and writes it.
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
from ..parallel.mesh import shard_bounds
from .binning import BinMapper, bin_on_device
from .engine import GrowConfig
from .objectives import get_leaf_renewal, get_objective, get_validation_loss, init_raw_score

__all__ = ["Booster", "TrainOptions", "booster_from_arrays"]

_FORMAT_VERSION = 2   # v2: many-vs-many categorical subset splits (cat_sets)

_TREE_FIELDS = ("feature", "threshold_bin", "is_categorical", "left", "right",
                "value", "gain", "cat_bitset")


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
    # bit-exact histogram merge on a mesh (LightGBM's `deterministic`);
    # one device is exact already
    deterministic: bool = False
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


def _check_supported(opts: TrainOptions) -> None:
    """Reject every option the port does not run, before any work."""
    tl = str(opts.tree_learner)
    if tl not in ("serial", "data", "data_parallel", "voting", "voting_parallel"):
        raise ValueError(
            f"tree_learner={tl!r} is not supported; use data_parallel or "
            "voting_parallel (LightGBMParams.scala:12-14)")
    if opts.boosting_type not in ("gbdt", "rf", "dart", "goss"):
        raise ValueError(
            f"boosting_type={opts.boosting_type!r} is not supported; "
            "use gbdt, rf, dart, or goss (LightGBMParams.scala:56-60)")
    if opts.bin_dtype not in ("int32", "uint8"):
        raise ValueError(f"bin_dtype must be 'int32' or 'uint8', got {opts.bin_dtype!r}")


def _fit_device(device: str, mesh) -> torch.device:
    """The fit's device: a mesh rank that owns a card (NCCL) fits on it
    when the fit asks for "cuda" without an index."""
    dev = resolve_device(device)
    if (mesh is not None and mesh.device is not None and dev.index is None
            and mesh.device.type == dev.type):
        return mesh.device
    return dev


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

        _check_supported(opts)
        if str(opts.tree_learner).startswith("voting") and mesh is None and log:
            log("tree_learner=voting_parallel has no effect without a mesh "
                "(use_mesh=True); training data_parallel")
        obj_fn = get_objective(opts.objective, alpha=opts.alpha,
                               tweedie_variance_power=opts.tweedie_variance_power,
                               fair_c=opts.fair_c)
        device = _fit_device(opts.device, mesh)
        x = as_features(x)  # CSR stays sparse until binning (binned-dense path)
        y = np.asarray(y, dtype=np.float64)
        n, f = x.shape
        k = opts.num_class if opts.objective == "multiclass" else 1
        # warm start: the warm model's bins, and its scores on this device
        warm = None if opts.init_model is None else opts.init_model.to(device)
        shared_hit = None
        if warm is not None:
            mapper = warm.bin_mapper
        else:
            # AutoML sweeps seed a SharedBinContext: when this fit's rows
            # are a slice of the seeded full table under the same binning
            # config and device, reuse its mapper + device-resident binned
            # matrix (a gather there) instead of re-sketching and re-binning
            from .shared_bins import lookup_shared_bins, note_bin_build

            shared_hit = lookup_shared_bins(x, opts, device)
            if shared_hit is not None:
                mapper = shared_hit.mapper
            else:
                mapper = BinMapper(
                    max_bin=opts.max_bin,
                    categorical_indexes=tuple(opts.categorical_indexes),
                    bin_construct_sample_cnt=opts.bin_construct_sample_cnt,
                ).fit(x)
                note_bin_build()
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
        # a mesh pads the rows to a multiple of its shards (weight 0, bin 0)
        # and this rank fits on its block [lo, hi) of them (reference
        # :220-225, P(DATA)); without one the block is every row
        n_pad, lo, hi = shard_bounds(n, mesh) if mesh is not None else (n, 0, n)

        def block(a: np.ndarray) -> np.ndarray:
            """This rank's rows of a per-row host array, zero on the pad."""
            a = np.asarray(a)
            if n_pad != n:
                a = np.concatenate([a, np.zeros((n_pad - n,) + a.shape[1:], a.dtype)])
            return a[lo:hi]

        bin_dtype = np.uint8 if use_u8 else np.int32
        if opts.device_binning and not mapper.category_maps and not is_sparse(x):
            # the device compares in f32: snap a copy of the boundaries
            # through f32 first, so that scoring (host f64 searchsorted)
            # routes against the thresholds the training matrix was binned
            # with (booster.py:205-215 of the reference)
            mapper = copy.copy(mapper)
            mapper.upper_bounds = np.float64(np.float32(mapper.upper_bounds))
            bins_dev = mapper.transform_device(x[lo:min(hi, n)], device).to(
                torch.uint8 if use_u8 else torch.int32)
            if hi > n:
                bins_dev = torch.cat([bins_dev, bins_dev.new_zeros((hi - max(lo, n), f))])
        elif shared_hit is not None:
            # binning is row-wise, so the gathered rows of the shared
            # full-table matrix ARE this rank's block of the fit's bins
            bins_dev = shared_hit.device_bins(lo, min(hi, n)).to(
                torch.uint8 if use_u8 else torch.int32)
            if hi > n:
                bins_dev = torch.cat([bins_dev, bins_dev.new_zeros((hi - max(lo, n), f))])
        else:
            # narrowed on the host: a quarter of the bytes to the card
            bins_dev = torch.as_tensor(block(mapper.transform(x).astype(bin_dtype)),
                                       device=device)

        w = np.ones(n, np.float64) if weights is None else np.asarray(weights, np.float64)
        if opts.is_unbalance and opts.objective == "binary":
            # reference is_unbalance: scale positive class by neg/pos ratio
            npos = max(float((y == 1).sum()), 1.0)
            nneg = max(float((y == 0).sum()), 1.0)
            w = np.where(y == 1, w * nneg / npos, w)
        base_mask = torch.as_tensor(block(w.astype(np.float32)), device=device)

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
            voting_top_k=opts.top_k if str(opts.tree_learner).startswith("voting") else 0,
            deterministic=opts.deterministic,
            cat_smooth=opts.cat_smooth,
            cat_l2=opts.cat_l2,
            max_cat_threshold=opts.max_cat_threshold,
        )
        cat_mask = np.zeros(f, bool)
        cat_mask[[int(i) for i in opts.categorical_indexes]] = True
        renewal = get_leaf_renewal(opts.objective, alpha=opts.alpha)
        renew_alpha, renew_weighted = renewal if renewal else (None, False)
        rows = hi - lo
        if k > 1:
            init = 0.0
            y_fit = np.eye(k)[y.astype(int)]                        # (n, K)
            pred0 = torch.zeros((rows, k), dtype=torch.float32, device=device)
        else:
            init = (warm.init_score if warm is not None else
                    init_raw_score(opts.objective, y, w, opts.boost_from_average, opts.alpha))
            y_fit = y
            pred0 = torch.full((rows,), init, dtype=torch.float32, device=device)
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
                raw = block(warm.predict_raw(x))
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

        # the round index restarts at 0 after a warm start; a checkpointed
        # fit passes the rounds already done as the loop's round_offset
        num_rounds = opts.num_iterations - start_iter
        # multiclass dart runs the gbdt loop: its drop algebra is
        # single-model (reference :396-397, :432-435)
        spec_boosting = "gbdt" if opts.boosting_type == "dart" else opts.boosting_type
        ckpt = None
        ck_every = int(opts.checkpoint_every_n or 0)
        # single-class dart has no checkpoints, as in the reference (:543-590)
        if opts.checkpoint_dir and ck_every > 0 and num_rounds > 0 and not single_dart:
            if es_active:
                if log:
                    log("checkpointing disabled: early stopping carries cross-round "
                        "state inside the boosting loop")
            else:
                from ..resilience.elastic import TrainingCheckpointer

                ckpt = TrainingCheckpointer(opts.checkpoint_dir)
                if mesh is not None:
                    mesh.barrier()
        fit_done = 0
        # on a mesh of several ranks every rank resumes from the snapshots,
        # and only shard 0's rank writes them (behind a barrier)
        shared = mesh is not None and mesh.size > 1
        writer = not shared or mesh.shard_index == 0
        if ckpt is not None:
            restored = _restore_snapshot(ckpt, opts, k, start_iter, log)
            if shared:
                _same_on_every_rank(-1 if restored is None else restored[1], mesh, device,
                                    "rounds restored from the checkpoint")
            if restored is not None:
                snap, fit_done = restored
                fit_done = min(fit_done, num_rounds)
                trees = [snap._tree_dict(t) for t in range(snap.num_trees)]
                tree_classes = [int(c) for c in snap.tree_class]
                if not rf and fit_done > 0:
                    # the carry again: predict_raw adds init and then each
                    # tree's f32 value in tree order, as the loop's
                    # `pred + rowvals` did, so the margins are the same bits
                    raw = block(snap.predict_raw(x))
                    pred0 = torch.as_tensor(raw, dtype=torch.float32, device=device).reshape(
                        pred0.shape)

        def append_round_trees(t_stack, rounds, tree_weights=None):
            t_host = {name: getattr(t_stack, name).cpu().numpy() for name in _TREE_FIELDS}
            for r in range(rounds):
                for cls in range(k):
                    idx = (r, cls) if k > 1 else (r,)
                    tree = {name: t_host[name][idx] for name in _TREE_FIELDS}
                    if tree_weights is not None:
                        tree = _scale_tree(tree, float(tree_weights[r]))
                    trees.append(tree)
                    tree_classes.append(cls)

        if fit_done < num_rounds:
            def build(rounds):
                spec = FusedTrainSpec(
                    num_rounds=rounds, num_class=k, boosting_type=spec_boosting,
                    bagging_fraction=opts.bagging_fraction, bagging_freq=opts.bagging_freq,
                    feature_fraction=opts.feature_fraction, top_rate=opts.top_rate,
                    other_rate=opts.other_rate,
                    early_stopping_round=opts.early_stopping_round if es_active else 0,
                    drop_rate=opts.drop_rate, renew_alpha=renew_alpha,
                    renew_weighted=renew_weighted)
                if single_dart:
                    return make_fused_dart_fn(f, num_bins, cfg, mapper.num_bins, cat_mask,
                                              obj_fn, spec, device=device, mesh=mesh)
                return make_fused_train_fn(f, num_bins, cfg, mapper.num_bins, cat_mask,
                                           obj_fn, spec, device=device,
                                           val_loss_fn=val_loss_fn, mesh=mesh)

            y_dev = torch.as_tensor(block(y_fit), dtype=torch.float32, device=device)
            # one key for every draw (reference :462)
            seed = opts.seed if opts.seed else opts.bagging_seed
            if log:
                log(f"boosting: {num_rounds} rounds x {k} class(es) of "
                    f"{opts.boosting_type} on {device}")
            if single_dart:
                t_stack, w_dev, _ = build(num_rounds)(bins_dev, y_dev, base_mask, pred0,
                                                      drop_seed, bag_seed, feat_seed)
                append_round_trees(t_stack, num_rounds, w_dev.cpu().numpy().astype(np.float64))
            elif ckpt is None:
                t_stack, _, (best_dev, stopped_dev) = build(num_rounds)(
                    bins_dev, y_dev, base_mask, pred0, seed, val)
                kept = int(t_stack.feature.shape[0])
                if es_active:
                    r_best = int(best_dev)
                    if bool(stopped_dev) and r_best >= 0:
                        kept = r_best + 1
                        if log:
                            log(f"early stop after round {r_best + start_iter} "
                                f"(kept {kept}/{num_rounds} rounds)")
                    best_iter = start_iter + r_best if r_best >= 0 else -1
                append_round_trees(t_stack, kept)
            else:
                from ..resilience.elastic import preempt_now

                # chunks start on bagging-period edges: the gbdt bag
                # refreshes when it % bagging_freq == 0 and is carried
                # otherwise, and the carried bag lives only on the device
                # (rf and goss draw afresh every round, so any edge works)
                gbdt_bagging = (spec_boosting == "gbdt" and opts.bagging_fraction < 1.0
                                and opts.bagging_freq > 0)
                align = opts.bagging_freq if gbdt_bagging else 1
                chunk = max((ck_every // align) * align, align)
                if log:
                    log(f"checkpoint every {chunk} rounds"
                        + (f" (resumed at round {start_iter + fit_done})" if fit_done else ""))
                pred, fused, built = pred0, None, -1
                while fit_done < num_rounds:
                    rounds = min(chunk, num_rounds - fit_done)
                    if rounds != built:
                        fused, built = build(rounds), rounds
                    t_stack, pred, _ = fused(bins_dev, y_dev, base_mask, pred, seed,
                                             round_offset=fit_done)
                    append_round_trees(t_stack, rounds)
                    fit_done += rounds
                    path = (_write_snapshot(ckpt, trees, tree_classes, mapper, opts, init,
                                            feature_names, fit_done, start_iter, k)
                            if writer else None)
                    if shared:
                        mesh.barrier()
                        _preempt_on_any_rank(mesh, device, path)
                    else:
                        preempt_now(None, lambda: path, "gbdt-train")
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
    def from_tree_dicts(
        trees: "list[dict[str, np.ndarray]]",
        tree_classes: "list[int]",
        mapper: BinMapper,
        opts: TrainOptions,
        init: float,
        feature_names: "list[str]",
        device: str = "cuda",
    ) -> "Booster":
        """Assemble a Booster from per-tree dicts grown outside
        `Booster.train` (the `parallel.dp.TreeBuilder.to_dict` layout), as
        the elastic fit does (resilience/elastic_fleet.py): it scores and
        serializes like a trained one, on `device`."""
        return Booster._from_tree_dicts(
            trees, tree_classes, mapper, opts, init, feature_names, device=device)

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

    # objectives whose transform_score is the identity: their f64
    # predictions are an exact widening of the f32 margins
    IDENTITY_OBJECTIVES = (
        "regression", "l1", "l2", "huber", "fair", "quantile", "mape")

    def device_predict_fn(self, device: "str | None" = None):
        """(params, fn): the fused decode -> bin -> traverse scoring program
        (reference booster.py:969). `fn(params, x)` takes raw values (n, F)
        (numpy or a tensor, cast to f32) and returns the margins as a tensor
        on the device of `params`; params hold the binning keys, `nb` and
        the blocked tree SoA as tensors on `device` (the booster's own by
        default), so they move to the card once.

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
        dev = resolve_device(device or self.device)
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

    def device_predict_shardings(self, mesh, params=None):
        """The `device_predict_fn` params each rank of `mesh` holds (the
        reference's placement of them, booster.py:1100): everything whole
        on every rank, since every row's traversal reads the whole binning
        table (keys, nb) and every tree array, while the rows themselves
        split over the data axis (the fusion engine's block of rows).
        Stating the placement keeps the scoring path's params pinned even
        if the engine's default ever changes."""
        if params is None:
            params, _ = self.device_predict_fn()
        return params

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
        """Write the model to disk: the JSON format (default) or LightGBM's
        own model.txt (`format="lightgbm"`), the reference's
        saveNativeModel surface (LightGBMClassifier.py shim)."""
        if format not in ("json", "lightgbm"):
            raise ValueError(f"format must be 'json' or 'lightgbm', got {format!r}")
        text = self.to_text() if format == "json" else self.to_lightgbm_text()
        with open(path, "w") as fh:
            fh.write(text)

    @staticmethod
    def load_native_model(path: str, device: str = "cuda") -> "Booster":
        """Load a saved model, the JSON format or a LightGBM `model.txt`
        (told apart by the first character), to score on `device` — the
        reference's loadNativeModelFromFile (LightGBMBooster.scala:115-124)."""
        with open(path) as fh:
            text = fh.read()
        if text.lstrip().startswith("{"):
            return Booster.from_text(text, device=device)
        return Booster.from_lightgbm_text(text, device=device)

    # our objective name -> the name LightGBM writes/reads in model files
    # (these all share the identity-or-documented output transform on both
    # sides, so a roundtrip applies the same exp/sigmoid/softmax)
    _TO_LGBM = {
        "regression": "regression", "l2": "regression",
        "l1": "regression_l1", "huber": "huber", "fair": "fair",
        "poisson": "poisson", "quantile": "quantile", "mape": "mape",
        "gamma": "gamma", "tweedie": "tweedie",
    }

    def to_lightgbm_text(self) -> str:
        """Serialize in LightGBM's OWN model.txt format (the reference's
        saveNativeModel artifact, LightGBMBooster.scala:115-124) — the
        emitted file is loadable by actual LightGBM and by
        `from_lightgbm_text`, with identical predictions.

        The traversal semantics map exactly for numeric splits: node
        thresholds come from `threshold_value` (raw space), missing
        handling is encoded as missing_type=NaN + default_left
        (decision_type=10), matching this booster's NaN->missing-bin->left
        rule. ±inf inputs bin by comparison on both sides (-inf left of
        every threshold, +inf right), so they predict identically under
        real LightGBM and this booster; only NaN takes the missing path.
        `init_score` is folded into tree 0's leaf values (LightGBM
        files carry no separate init; every row hits exactly one leaf per
        tree, so the sum is unchanged).

        Categorical subset splits use LightGBM's own on-file encoding:
        decision_type bit 0 set, threshold = index into this tree's
        cat_boundaries, and cat_threshold packing the LEFT category VALUES
        as uint32 bitset words (bit v set -> raw category v goes left).
        Values outside any bitset route right on both sides (this
        booster's other-bin, LightGBM's unseen-category rule). Requires
        integer-valued non-negative categories — anything else has no
        LightGBM file representation and is refused."""
        # bin -> raw category value per categorical feature (for export)
        cat_inv: dict[int, dict[int, int]] = {}
        if bool(np.any(self.is_categorical[self.feature >= 0])):
            for j, cmap in self.bin_mapper.category_maps.items():
                inv = {}
                for v, b in cmap.items():
                    if not (float(v).is_integer() and v >= 0 and v < 2**31):
                        raise ValueError(
                            f"feature {j} has non-integer/negative category "
                            f"value {v!r}; LightGBM's categorical bitset "
                            "encoding cannot represent it"
                        )
                    inv[int(b)] = int(v)
                cat_inv[int(j)] = inv
        if self.objective not in ("binary", "multiclass") and \
                self.objective not in self._TO_LGBM:
            raise ValueError(
                f"objective {self.objective!r} has no LightGBM file-format "
                "name; export would lose the output transform"
            )
        k = self.num_class
        names = self.feature_names or [
            f"Column_{j}" for j in range(self.num_features)
        ]
        out = [
            "tree",
            "version=v3",
            f"num_class={k}",
            f"num_tree_per_iteration={k if self.objective == 'multiclass' else 1}",
            "label_index=0",
            f"max_feature_idx={self.num_features - 1}",
            ("objective=binary sigmoid:1" if self.objective == "binary"
             else f"objective=multiclass num_class:{k}"
             if self.objective == "multiclass"
             else f"objective={self._TO_LGBM[self.objective]}"),
            "feature_names=" + " ".join(names),
            "feature_infos=" + " ".join(["none"] * self.num_features),
            "",
        ]
        for t in range(self.num_trees):
            feature, left, right = self.feature[t], self.left[t], self.right[t]
            # renumber reachable nodes into LightGBM convention: internal
            # nodes 0..L-2 in preorder, leaf l -> child id -(l+1)
            internal: list[int] = []
            leaves: list[int] = []
            stack = [0]
            while stack:
                n = stack.pop()
                if feature[n] < 0:
                    leaves.append(n)
                else:
                    internal.append(n)
                    stack.append(int(right[n]))
                    stack.append(int(left[n]))
            imap = {n: i for i, n in enumerate(internal)}
            lmap = {n: i for i, n in enumerate(leaves)}

            def child(n: int) -> int:
                return imap[n] if feature[n] >= 0 else -(lmap[n] + 1)

            leaf_vals = [float(self.value[t][n]) for n in leaves]
            if t == 0 and self.objective != "multiclass" and self.init_score:
                leaf_vals = [v + float(self.init_score) for v in leaf_vals]
            # categorical nodes: threshold = per-tree cat split index;
            # bitset words pack the LEFT category values
            thresholds: list[str] = []
            decisions: list[str] = []
            cat_bounds = [0]
            cat_words: list[int] = []
            for n in internal:
                if bool(self.is_categorical[t][n]):
                    j = int(feature[n])
                    vals = [cat_inv[j][int(b)]
                            for b in np.nonzero(self.cat_bitset[t][n])[0]
                            if int(b) in cat_inv.get(j, {})]
                    if not vals or bool(self.cat_bitset[t][n][0]):
                        raise ValueError(
                            f"tree {t} node {n}: categorical left set routes "
                            "the other/unseen bin left — LightGBM's finite "
                            "bitset cannot express 'unseen goes left'"
                        )
                    n_words = max(v for v in vals) // 32 + 1
                    words = [0] * n_words
                    for v in vals:
                        words[v // 32] |= 1 << (v % 32)
                    thresholds.append(str(len(cat_bounds) - 1))
                    decisions.append("1")
                    cat_bounds.append(cat_bounds[-1] + n_words)
                    cat_words.extend(words)
                else:
                    thresholds.append(repr(float(self.threshold_value[t][n])))
                    decisions.append("10")
            num_cat = len(cat_bounds) - 1
            out += [f"Tree={t}", f"num_leaves={len(leaves)}",
                    f"num_cat={num_cat}"]
            if internal:
                out += [
                    "split_feature=" + " ".join(
                        str(int(feature[n])) for n in internal),
                    "split_gain=" + " ".join(
                        repr(float(self.gain[t][n])) for n in internal),
                    "threshold=" + " ".join(thresholds),
                    "decision_type=" + " ".join(decisions),
                    "left_child=" + " ".join(
                        str(child(int(left[n]))) for n in internal),
                    "right_child=" + " ".join(
                        str(child(int(right[n]))) for n in internal),
                ]
                if num_cat:
                    out += [
                        "cat_boundaries=" + " ".join(str(b) for b in cat_bounds),
                        "cat_threshold=" + " ".join(str(w) for w in cat_words),
                    ]
            out += [
                "leaf_value=" + " ".join(repr(v) for v in leaf_vals),
                "shrinkage=1",
                "",
            ]
        out += ["end of trees", ""]
        return "\n".join(out)

    @staticmethod
    def from_lightgbm_text(text: str, device: str = "cuda") -> "Booster":
        """Parse LightGBM's OWN native model.txt format.

        This grounds tree semantics in the reference implementation's
        artifact: a model trained by actual LightGBM (what the reference's
        saveNativeModel emits, LightGBMBooster.scala:115-124) loads here
        and must reproduce its predictions (tests/test_lightgbm_format.py
        pins this with a hand-computed fixture).

        Numeric splits are `value <= threshold -> left`. The raw-space
        thresholds become this booster's bin boundaries (one bin per
        distinct threshold per feature), making the binned traversal
        EXACTLY equivalent to LightGBM's raw comparisons — no precision
        loss on finite values; ±inf also bins by comparison (-inf left,
        +inf right of every threshold), matching LightGBM's
        `value <= threshold` routing. Missing handling: NaN maps to this
        framework's missing bin, which always sorts LEFT. Nodes whose
        missing routing this booster cannot reproduce are REJECTED rather
        than silently mispredicting: missing_type=NaN with
        default_left=false (NaN would go right) and missing_type=Zero
        (zero-band values route by default_left, not by comparison). With
        missing_type=None (bits 2-3 == 0) LightGBM coerces NaN to 0.0
        before comparing, which can also differ from missing-bin-left —
        only relevant for NaN inputs.

        Categorical splits (decision_type bit 0) load natively: each
        node's cat_threshold bitset words decode to the raw category
        values routed LEFT; the union per feature synthesizes the
        category map (one bin per value), so the per-node bin bitsets
        reproduce LightGBM's value-level routing exactly. Values absent
        from every bitset — including unseen-at-predict categories — land
        in the other-bin and route RIGHT, LightGBM's rule. NaN
        categorical inputs route right here (LightGBM's missing handling
        for categories treats them as no-match).

        Still rejected: `average_output` (rf) models and linear trees —
        both would change predictions silently if ignored. The pinned
        hand-computed fixture lives in tests/test_external_truth.py.

        The model scores on `device`, as `from_text`'s does. Its bin
        boundaries are the file's f64 thresholds: the host walk and
        `predict_raw` bin in f64, and the fused device program
        (`device_predict_fn`) equals them on f32-representable values."""
        header, tree_blocks = _parse_lightgbm_sections(text)
        if "average_output" in header:
            raise ValueError(
                "average_output (rf) LightGBM models are not supported — "
                "this booster sums leaf values; loading one would "
                "mispredict by the tree count"
            )
        if header.get("linear_tree", "0") not in ("0", "") or any(
            "leaf_const" in blk or "leaf_coeff" in blk for blk in tree_blocks
        ):
            raise ValueError("linear-tree LightGBM models are not supported")
        obj_tokens = header.get("objective", "regression").split()
        objective = obj_tokens[0]
        # LightGBM's binary output transform is 1/(1+exp(-sigmoid*raw));
        # this booster applies plain sigmoid (sigmoid=1). A non-unit
        # sigmoid parameter would silently scale every probability, so
        # reject it (reject-rather-than-mispredict policy).
        for tok in obj_tokens[1:]:
            if tok.startswith("sigmoid:") and float(tok.split(":", 1)[1]) != 1.0:
                raise ValueError(
                    f"objective parameter {tok!r} != sigmoid:1 would change "
                    "the probability transform; refusing to load"
                )
        obj_map = {
            "binary": "binary", "regression": "regression",
            "regression_l2": "regression", "regression_l1": "l1",
            "multiclass": "multiclass", "huber": "huber", "fair": "fair",
            "poisson": "poisson", "quantile": "quantile",
            "gamma": "gamma", "tweedie": "tweedie", "mape": "mape",
        }
        if objective not in obj_map:
            raise ValueError(f"unsupported LightGBM objective {objective!r}")
        objective = obj_map[objective]
        num_class = int(header.get("num_class", 1))
        max_feature = int(header.get("max_feature_idx", 0))
        f = max_feature + 1
        feature_names = header.get("feature_names", "").split()

        # collect per-feature thresholds (numeric) and left-routed category
        # values (categorical) -> synthesized bin boundaries / category maps
        def _cat_left_values(blk, i):
            """Decode node i's cat_threshold bitset words -> left values."""
            bounds = blk.get("cat_boundaries", [])
            words = blk.get("cat_threshold", [])
            ci = int(blk["threshold"][i])
            if not (0 <= ci < len(bounds) - 1) or bounds[ci + 1] > len(words):
                raise ValueError(
                    "malformed categorical split: cat_boundaries/"
                    "cat_threshold do not cover the node's split index"
                )
            vals = []
            for wi in range(bounds[ci], bounds[ci + 1]):
                w = int(words[wi])
                base = 32 * (wi - bounds[ci])
                for b in range(32):
                    if (w >> b) & 1:
                        vals.append(base + b)
            return vals

        thresholds: dict[int, set] = {}
        cat_vals: dict[int, set] = {}
        for blk in tree_blocks:
            # single-leaf (constant) trees carry no split arrays at all
            for i, (feat, thr, dt) in enumerate(
                zip(blk.get("split_feature", []),
                    blk.get("threshold", []),
                    blk.get("decision_type", []))
            ):
                dt = int(dt)
                feat = int(feat)
                if dt & 1:
                    # categorical: union the left values; routing of any
                    # value not in some node's set is right, our other-bin
                    cat_vals.setdefault(feat, set()).update(
                        _cat_left_values(blk, i)
                    )
                    continue
                # decision_type bits: 0 categorical, 1 default_left,
                # 2-3 missing_type (0 none, 1 zero, 2 nan)
                missing_type = (dt >> 2) & 3
                if missing_type == 2 and not (dt & 2):
                    raise ValueError(
                        "node routes missing (NaN) RIGHT "
                        "(missing_type=NaN, default_left=false); this "
                        "booster's missing bin always sorts left — refusing "
                        "to load a model it would mispredict"
                    )
                if missing_type == 1:
                    raise ValueError(
                        "missing_type=Zero (zero_as_missing) nodes route "
                        "the zero band by default_left, not by threshold "
                        "comparison — refusing to load a model this "
                        "booster would mispredict on zero values"
                    )
                thresholds.setdefault(feat, set()).add(float(thr))
        mixed = set(thresholds) & set(cat_vals)
        if mixed:
            raise ValueError(
                f"features {sorted(mixed)} have both numeric and categorical "
                "splits in the same model file"
            )
        per_feat = {j: sorted(s) for j, s in thresholds.items()}
        max_t = max((len(v) for v in per_feat.values()), default=0)
        mapper = BinMapper(
            max_bin=max(max_t + 1, 2,
                        *(len(v) for v in cat_vals.values())) if cat_vals
            else max(max_t + 1, 2),
            categorical_indexes=tuple(sorted(cat_vals)),
        )
        mapper.num_features = f
        bounds = np.full((f, max_t + 2), np.inf, np.float64)
        nbins = np.full(f, 1, np.int32)
        for j, ts in per_feat.items():
            bounds[j, 1 : 1 + len(ts)] = ts
            nbins[j] = len(ts) + 2       # missing bin + one per threshold + top
        cat_maps = {
            j: {float(v): i + 1 for i, v in enumerate(sorted(s))}
            for j, s in cat_vals.items()
        }
        for j, cmap in cat_maps.items():
            nbins[j] = len(cmap) + 1     # other-bin + one per left value
        mapper.category_maps = cat_maps
        mapper.upper_bounds = bounds
        mapper.num_bins = nbins

        # node-layout conversion: LightGBM internal i -> node i, leaf l ->
        # node (L-1+l); child c >= 0 is internal, c < 0 is leaf -(c+1)
        m = max(2 * blk["num_leaves"] - 1 for blk in tree_blocks)
        t_count = len(tree_blocks)
        bc = max((len(cm) + 1 for cm in cat_maps.values()), default=1)
        feature = np.full((t_count, m), -1, np.int32)
        thr_bin = np.zeros((t_count, m), np.int32)
        thr_val = np.zeros((t_count, m), np.float64)
        is_cat_arr = np.zeros((t_count, m), bool)
        cat_bitset = np.zeros((t_count, m, bc), bool)
        left = np.full((t_count, m), -1, np.int32)
        right = np.full((t_count, m), -1, np.int32)
        value = np.zeros((t_count, m), np.float32)
        gain = np.zeros((t_count, m), np.float32)
        for t, blk in enumerate(tree_blocks):
            nl = blk["num_leaves"]

            def node_of(c: int, nl=nl) -> int:
                return c if c >= 0 else nl - 1 + (-c - 1)

            if nl == 1:                  # single-leaf tree (constant)
                value[t, 0] = blk["leaf_value"][0]
                continue
            for i in range(nl - 1):
                j = int(blk["split_feature"][i])
                feature[t, i] = j
                dt = int(blk["decision_type"][i])
                if dt & 1:
                    is_cat_arr[t, i] = True
                    thr_val[t, i] = np.nan
                    cmap = cat_maps[j]
                    for v in _cat_left_values(blk, i):
                        cat_bitset[t, i, cmap[float(v)]] = True
                else:
                    thr = float(blk["threshold"][i])
                    # bin index of threshold: 1 + position in the sorted list
                    thr_bin[t, i] = 1 + per_feat[j].index(thr)
                    thr_val[t, i] = thr
                left[t, i] = node_of(int(blk["left_child"][i]))
                right[t, i] = node_of(int(blk["right_child"][i]))
                if blk.get("split_gain"):
                    gain[t, i] = blk["split_gain"][i]
            for leaf, lv in enumerate(blk["leaf_value"]):
                value[t, nl - 1 + leaf] = lv

        return Booster(
            feature=feature, threshold_bin=thr_bin, threshold_value=thr_val,
            is_categorical=is_cat_arr,
            cat_bitset=cat_bitset,
            left=left, right=right, value=value, gain=gain,
            tree_class=np.asarray(
                [t % num_class for t in range(t_count)], np.int32
            ),
            bin_mapper=mapper,
            objective=objective,
            num_class=num_class if objective == "multiclass" else 1,
            init_score=0.0,              # LightGBM bakes init into leaf values
            feature_names=feature_names,
            class_labels=[0.0, 1.0] if objective == "binary" else None,
            device=device,
        )


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


def _parse_lightgbm_sections(text: str):
    """Split a LightGBM model.txt into (header dict, [tree dict, ...])."""
    header: dict[str, str] = {}
    tree_blocks: list[dict] = []
    cur: dict | None = None
    _vec_int = ("split_feature", "left_child", "right_child", "decision_type",
                "cat_boundaries", "cat_threshold")
    _vec_float = ("threshold", "leaf_value", "split_gain",
                  "leaf_const", "leaf_coeff")
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("Tree="):
            cur = {}
            tree_blocks.append(cur)
            continue
        if line in ("end of trees", "") or line.startswith(("tree", "pandas_")):
            continue
        if "=" not in line:
            # bare flag lines ("average_output") matter: they change
            # prediction semantics, so record their presence
            if cur is None and line and " " not in line:
                header[line] = "1"
            continue
        key, val = line.split("=", 1)
        if cur is None:
            header[key] = val
        elif key == "num_leaves":
            cur[key] = int(val)
        elif key in _vec_int:
            cur[key] = [int(v) for v in val.split()] if val else []
        elif key in _vec_float:
            cur[key] = [float(v) for v in val.split()] if val else []
        # other per-tree keys (leaf_weight, internal_value, shrinkage, ...)
        # are bookkeeping the traversal doesn't need
    if not tree_blocks:
        raise ValueError("no Tree= sections found; not a LightGBM model file")
    for blk in tree_blocks:
        if "num_leaves" not in blk or "leaf_value" not in blk:
            raise ValueError("malformed LightGBM tree block")
    return header, tree_blocks


# ---- preemption-tolerant chunked training (resilience/elastic.py) ---- #

def _same_on_every_rank(value: int, mesh, device, what: str) -> None:
    """Raise unless every rank of the mesh holds the same `value` (a
    tensor on the fit's device: NCCL reduces card tensors only)."""
    from ..parallel.collectives import pmax, pmin

    t = torch.tensor([float(value)], device=device)
    lo, hi = float(pmin(t, mesh)[0]), float(pmax(t, mesh)[0])
    if lo != hi:
        raise RuntimeError(f"the ranks of the mesh disagree on the {what}: {lo:g} .. {hi:g}")


def _preempt_on_any_rank(mesh, device, path) -> None:
    """Preemption on a mesh: if any rank's guard is draining, every rank
    stops at this chunk's end (one rank leaving would block the others in
    their next collective). Shard 0's rank wrote the snapshot."""
    from ..parallel.collectives import pmax
    from ..resilience.elastic import Preempted, get_active_guard, preempt_now

    guard = get_active_guard()
    draining = guard is not None and guard.should_checkpoint()
    if not float(pmax(torch.tensor([float(draining)], device=device), mesh)[0]):
        return
    if draining:
        preempt_now(guard, lambda: path, "gbdt-train")
    raise Preempted("gbdt-train preempted on another rank of the mesh; resumable "
                    "checkpoint written by shard 0's rank", checkpoint_path=path)


def _ckpt_config(opts: TrainOptions, k: int, start_iter: int) -> dict:
    """The fit identity a snapshot must match to be resumable: a snapshot
    from a different config would silently change the model. The JAX
    package's fields, so either package resumes the other's snapshots."""
    return {
        "objective": opts.objective, "boosting_type": opts.boosting_type,
        "num_class": int(k), "seed": int(opts.seed),
        "bagging_seed": int(opts.bagging_seed),
        "num_iterations": int(opts.num_iterations),
        "num_leaves": int(opts.num_leaves),
        "learning_rate": float(opts.learning_rate),
        "start_iter": int(start_iter),
    }


def _write_snapshot(ckpt, trees, tree_classes, mapper, opts, init,
                    feature_names, fit_done: int, start_iter: int,
                    k: int) -> str:
    """Snapshot the booster so far (the JSON model text round-trips f32
    values exactly). rf trees are stored UNSCALED: the 1/T averaging
    happens once at the end of the fit, and an unscale-rescale round trip
    is not f32-exact."""
    snap = Booster._from_tree_dicts(
        trees, tree_classes, mapper, opts, init, feature_names or [])
    doc = {"kind": "gbdt", "fit_rounds_done": int(fit_done),
           "config": _ckpt_config(opts, k, start_iter),
           "model": snap.to_text()}
    return ckpt.save(json.dumps(doc).encode("utf-8"),
                     tag=f"round-{start_iter + fit_done:06d}",
                     meta={"rounds_done": int(fit_done),
                           **_ckpt_config(opts, k, start_iter)})


def _restore_snapshot(ckpt, opts, k: int, start_iter: int, log):
    """The newest verified snapshot matching this fit's config, parsed
    back into (booster scoring on the fit's device, rounds_done), or None
    to start from round 0."""
    loaded = ckpt.load_latest()
    if loaded is None:
        return None
    payload, entry = loaded
    try:
        doc = json.loads(payload.decode("utf-8"))
        if doc.get("kind") != "gbdt":
            raise ValueError(f"kind {doc.get('kind')!r}")
        if doc.get("config") != _ckpt_config(opts, k, start_iter):
            raise ValueError("config mismatch")
        snap = Booster.from_text(doc["model"], device=opts.device)
        fit_done = int(doc["fit_rounds_done"])
    except (ValueError, KeyError, TypeError) as e:
        if log:
            log(f"ignoring checkpoint {entry['file']}: {e}")
        return None
    if log:
        log(f"resumed from {entry['file']}: {fit_done} rounds already trained")
    return snap, fit_done
