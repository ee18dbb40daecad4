"""Partition-invariant data-parallel shard math for elastic training.

A copy of mmlspark_tpu/parallel/dp.py (numpy only), so the port imports
nothing of the JAX package.

The elastic fleet (resilience/elastic_fleet.py) trains one model across
P worker PROCESSES whose count changes mid-fit. The whole byte-
reproducibility story rests on the invariants in this module, which is
deliberately pure math — no processes, no sockets, no clocks — so every
invariant is unit-testable in microseconds:

  * Rows map to a FIXED number V of **virtual shards** by a blake2b hash
    of the row id (the same partition-invariance trick as
    `streaming.shuffle.stable_hash`, proven there by the P=1 vs P=4
    byte-compare). V never changes during a fit; only the
    shard -> worker ownership map does.
  * Workers compute one partial per OWNED VIRTUAL SHARD (a gradient sum
    for the DNN, a g/h/count histogram for the GBDT) and never pre-merge
    across shards: float addition is non-associative, so worker-local
    merges would bake the worker count into the bits.
  * The driver folds partials in fixed shard order 0..V-1
    (`fold_partials`) — the float accumulation order is a function of V
    alone, never of P. This is the cross-process analogue of
    `parallel.collectives.psum_ordered` (the in-mesh deterministic
    reduction).
  * The global batch order (`global_batch_order`) is drawn from a
    driver-owned `np.random.default_rng(seed)` shuffle stream that P
    never enters.

Together: any membership schedule — kill a worker, add three, every N
steps — replays the exact same float program as the undisturbed P=1 run.
"""

from __future__ import annotations

import base64
import hashlib
import io

import numpy as np

__all__ = [
    "V_DEFAULT",
    "virtual_shard_of",
    "shard_assignment",
    "owner_of_shard",
    "shards_of_member",
    "fold_partials",
    "global_batch_order",
    "encode_array",
    "decode_array",
    "hist_partial",
    "best_split",
    "leaf_value",
    "TreeBuilder",
    "walk_tree_dict",
]

# enough virtual shards that any plausible worker count divides the work
# usefully, few enough that per-shard partials stay cheap to ship
V_DEFAULT = 32


# --------------------------------------------------------------------- #
# row -> virtual shard -> worker                                        #
# --------------------------------------------------------------------- #


def virtual_shard_of(row_id: int, num_virtual: int = V_DEFAULT) -> int:
    """Virtual shard of a row id: blake2b of the decimal string, mod V.

    Deliberately identical in shape to `streaming.shuffle.stable_hash`:
    content-addressed, stable across processes and Python hash
    randomization, and independent of everything except (row_id, V)."""
    h = hashlib.blake2b(str(int(row_id)).encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big") % int(num_virtual)


def shard_assignment(n_rows: int, num_virtual: int = V_DEFAULT) -> np.ndarray:
    """(n_rows,) int32 virtual shard of every row — computed identically
    on the driver and every worker from (n_rows, V) alone."""
    n = int(n_rows)
    return np.fromiter(
        (virtual_shard_of(i, num_virtual) for i in range(n)),
        dtype=np.int32, count=n)


def owner_of_shard(shard: int, world_size: int) -> int:
    """Rank (index into the SORTED member list) owning a virtual shard."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    return int(shard) % int(world_size)


def shards_of_member(rank: int, world_size: int,
                     num_virtual: int = V_DEFAULT) -> list[int]:
    """Virtual shards owned by `rank` in a world of `world_size`.

    Round-robin by shard id: for ANY world size the ownership lists
    partition 0..V-1 exactly (each shard owned once — the property the
    P=1 vs P=4 byte-compare in tests/test_elastic_fleet.py pins)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    return [s for s in range(int(num_virtual))
            if owner_of_shard(s, world_size) == rank]


def fold_partials(partials: "dict[int, np.ndarray]",
                  num_virtual: int = V_DEFAULT) -> np.ndarray:
    """Merge per-virtual-shard partials in FIXED shard order 0..V-1.

    The accumulation order — and therefore every float rounding step —
    is a function of V alone. Shards absent from `partials` (no rows in
    this batch) are skipped; skipping is itself deterministic because
    emptiness depends only on the row->shard map and the batch."""
    total: "np.ndarray | None" = None
    for s in range(int(num_virtual)):
        p = partials.get(s)
        if p is None:
            continue
        total = np.array(p, copy=True) if total is None else total + p
    if total is None:
        raise ValueError("fold_partials: no partials present")
    return total


def global_batch_order(n_rows: int, batch_size: int, epochs: int,
                       seed: int) -> np.ndarray:
    """(steps, batch_size) int64 global batch order for the whole fit.

    Drawn from the driver-owned shuffle stream exactly like
    nn/trainer.py (`np.random.default_rng(seed)`, one permutation per
    epoch, full batches only). P is not an argument: the order cannot
    depend on it."""
    n, bs = int(n_rows), min(int(batch_size), int(n_rows))
    rng = np.random.default_rng(int(seed))
    steps_per_epoch = (n - bs) // bs + 1 if n >= bs else 0
    out = []
    for _ in range(int(epochs)):
        perm = rng.permutation(n)
        for k in range(steps_per_epoch):
            out.append(perm[k * bs:(k + 1) * bs])
    if not out:
        return np.zeros((0, bs), np.int64)
    return np.stack(out).astype(np.int64)


# --------------------------------------------------------------------- #
# wire codec                                                            #
# --------------------------------------------------------------------- #


def encode_array(a: np.ndarray) -> str:
    """ndarray -> base64(.npy bytes): dtype/shape-faithful, pickle-free."""
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def decode_array(s: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(s.encode("ascii"))),
                   allow_pickle=False)


# --------------------------------------------------------------------- #
# GBDT: per-shard histograms, driver split math                         #
# --------------------------------------------------------------------- #


def hist_partial(bins: np.ndarray, grad: np.ndarray, hess: np.ndarray,
                 node: np.ndarray, node_ids: "list[int]",
                 num_bins: int) -> np.ndarray:
    """(len(node_ids), F, num_bins, 3) float64 g/h/count histogram over
    the given rows (one virtual shard's rows, ascending row id).

    Built with `np.bincount` over a flattened (node, feature, bin) index
    — bincount accumulates in input order, so the bits depend only on
    the shard's row set, never on which worker ran it. float64 on
    purpose: the merged histogram is the split-decision input and the
    fold must stay exact-order deterministic, not approximately equal."""
    node_ids_arr = np.asarray(sorted(int(i) for i in node_ids), np.int64)
    s_count, f_count, b_count = len(node_ids_arr), bins.shape[1], int(num_bins)
    mask = np.isin(node, node_ids_arr)
    if not mask.any():
        return np.zeros((s_count, f_count, b_count, 3), np.float64)
    b_sub = bins[mask]
    slot = np.searchsorted(node_ids_arr, node[mask])
    g_sub = np.asarray(grad, np.float64)[mask]
    h_sub = np.asarray(hess, np.float64)[mask]
    # flattened row-major (slot, feature, bin) index per (row, feature)
    idx = ((slot[:, None] * f_count + np.arange(f_count)[None, :]) * b_count
           + b_sub).ravel()
    size = s_count * f_count * b_count
    out = np.zeros((s_count, f_count, b_count, 3), np.float64)
    out[..., 0] = np.bincount(
        idx, weights=np.repeat(g_sub, f_count), minlength=size,
    ).reshape(s_count, f_count, b_count)
    out[..., 1] = np.bincount(
        idx, weights=np.repeat(h_sub, f_count), minlength=size,
    ).reshape(s_count, f_count, b_count)
    out[..., 2] = np.bincount(idx, minlength=size).reshape(
        s_count, f_count, b_count)
    return out


def best_split(hist_node: np.ndarray, parent: "tuple[float, float, float]",
               *, lambda_l2: float = 0.0, min_data_in_leaf: float = 1.0,
               min_sum_hessian: float = 1e-3,
               min_gain: float = 0.0) -> "dict | None":
    """Best (feature, bin) split of one node from its merged histogram.

    hist_node: (F, B, 3) float64 g/h/count. parent: exact (G, H, C) the
    driver tracks from the split that created this node. Left = rows
    with bin <= threshold_bin (the numeric-split convention of
    gbdt/booster.py `_walk_tree`). Gain is the standard second-order
    formula; ties break on (feature, bin) ascending so the decision is
    a pure function of the histogram bits."""
    g_tot, h_tot, c_tot = (float(parent[0]), float(parent[1]),
                           float(parent[2]))
    gl = np.cumsum(hist_node[..., 0], axis=1)
    hl = np.cumsum(hist_node[..., 1], axis=1)
    cl = np.cumsum(hist_node[..., 2], axis=1)
    gr, hr, cr = g_tot - gl, h_tot - hl, c_tot - cl
    lam = float(lambda_l2)
    # empty-side candidates divide by zero hessian; they are masked out
    # by `ok` below, so the inf/nan intermediates never escape
    with np.errstate(divide="ignore", invalid="ignore"):
        parent_score = g_tot * g_tot / (h_tot + lam)
        gain = 0.5 * (gl * gl / (hl + lam) + gr * gr / (hr + lam)
                      - parent_score)
    ok = ((cl >= float(min_data_in_leaf)) & (cr >= float(min_data_in_leaf))
          & (hl >= float(min_sum_hessian)) & (hr >= float(min_sum_hessian)))
    # the last bin's "left" is everything: never a real split
    ok[:, -1] = False
    gain = np.where(ok, gain, -np.inf)
    flat = int(np.argmax(gain))           # first max: (feature, bin) order
    f, b = divmod(flat, gain.shape[1])
    best = float(gain[f, b])
    if not np.isfinite(best) or best <= float(min_gain):
        return None
    return {
        "feature": int(f), "bin": int(b), "gain": best,
        "left": (float(gl[f, b]), float(hl[f, b]), float(cl[f, b])),
        "right": (float(gr[f, b]), float(hr[f, b]), float(cr[f, b])),
    }


def leaf_value(g: float, h: float, *, lambda_l2: float = 0.0,
               learning_rate: float = 1.0) -> float:
    """Shrinkage-scaled leaf output -lr * G / (H + lambda_l2)."""
    return float(-float(learning_rate) * float(g)
                 / (float(h) + float(lambda_l2)))


class TreeBuilder:
    """Driver-side depth-wise tree under construction, in the exact node
    array layout `Booster._from_tree_dicts` consumes (feature == -1 marks
    a leaf; left/right are node indices; `value` is the lr-scaled leaf
    output)."""

    def __init__(self, num_nodes: int):
        m = int(num_nodes)
        self.feature = np.full(m, -1, np.int32)
        self.threshold_bin = np.zeros(m, np.int32)
        self.is_categorical = np.zeros(m, bool)
        self.left = np.full(m, -1, np.int32)
        self.right = np.full(m, -1, np.int32)
        self.value = np.zeros(m, np.float32)
        self.gain = np.zeros(m, np.float32)
        self._next = 1                      # node 0 is the root

    def alloc_pair(self) -> "tuple[int, int]":
        if self._next + 2 > self.feature.shape[0]:
            raise ValueError("TreeBuilder: out of node capacity")
        l, r = self._next, self._next + 1
        self._next += 2
        return l, r

    def set_split(self, node: int, feature: int, threshold_bin: int,
                  left: int, right: int, gain: float) -> None:
        self.feature[node] = feature
        self.threshold_bin[node] = threshold_bin
        self.left[node], self.right[node] = left, right
        self.gain[node] = gain

    def set_leaf(self, node: int, value: float) -> None:
        self.feature[node] = -1
        self.value[node] = value

    def to_dict(self) -> "dict[str, np.ndarray]":
        m = self.feature.shape[0]
        return {
            "feature": self.feature.copy(),
            "threshold_bin": self.threshold_bin.copy(),
            "is_categorical": self.is_categorical.copy(),
            "left": self.left.copy(),
            "right": self.right.copy(),
            "value": self.value.copy(),
            "gain": self.gain.copy(),
            "cat_bitset": np.zeros((m, 1), bool),
        }


def walk_tree_dict(tree: "dict[str, np.ndarray]",
                   bins: np.ndarray) -> np.ndarray:
    """Leaf value of every row under one tree dict — the numeric-only
    mirror of `Booster._walk_tree`, used by workers to rebuild raw
    predictions from a shipped model after a re-shard."""
    feature = np.asarray(tree["feature"], np.int32)
    thr = np.asarray(tree["threshold_bin"], np.int32)
    left = np.asarray(tree["left"], np.int32)
    right = np.asarray(tree["right"], np.int32)
    value = np.asarray(tree["value"], np.float64)
    n = bins.shape[0]
    rows = np.arange(n)
    node = np.zeros(n, np.int64)
    max_steps = int(feature.shape[0] // 2 + 1)
    for _ in range(max_steps):
        f = np.maximum(feature[node], 0)
        go_left = bins[rows, f] <= thr[node]
        leaf = feature[node] < 0
        node = np.where(leaf, node,
                        np.where(go_left, left[node], right[node]))
    return value[node]
