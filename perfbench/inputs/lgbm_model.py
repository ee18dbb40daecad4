"""A LightGBM binary model of the Higgs schema, made from a seed and
written as LightGBM's own model.txt.

The thresholds are bin boundaries sketched from data, as a model fitted
at `max_bin` has them: each feature's equal-count quantiles of a sample of
rows (its distinct values where it has fewer). Each tree grows leaf-wise
at random: a uniformly chosen leaf splits on a uniformly chosen feature
at one of that feature's boundaries, until it has `leaves` leaves; leaf
values are N(0, 0.05). Internal nodes and leaves are numbered as LightGBM
numbers them (a split keeps the leaf's index on the left and gives the
new leaf the next index on the right)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Trees:
    """(T, L - 1) split_feature, threshold (f64), left_child, right_child
    (a child < 0 is leaf ~child), and (T, L) leaf_value (f64)."""

    split_feature: np.ndarray
    threshold: np.ndarray
    left_child: np.ndarray
    right_child: np.ndarray
    leaf_value: np.ndarray


def boundaries(sample: np.ndarray, max_bin: int) -> list[np.ndarray]:
    """Each column's bin boundaries: its distinct values where it has at
    most max_bin - 1 of them, else its max_bin - 1 equal-count quantiles."""
    out = []
    for col in np.asarray(sample, np.float64).T:
        uniq = np.unique(col)
        if len(uniq) <= max_bin - 1:
            out.append(uniq[:-1] if len(uniq) > 1 else uniq)
            continue
        qs = np.linspace(0, 1, max_bin + 1)[1:-1]
        out.append(np.unique(np.quantile(col, qs, method="higher")))
    return out


def random_trees(bounds: list[np.ndarray], trees: int, leaves: int, seed: int) -> Trees:
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    f = len(bounds)
    sf = np.zeros((trees, leaves - 1), np.int64)
    thr = np.zeros((trees, leaves - 1), np.float64)
    lc = np.zeros((trees, leaves - 1), np.int64)
    rc = np.zeros((trees, leaves - 1), np.int64)
    for t in range(trees):
        # parent[leaf] = (internal node, is_left); the root leaf has none
        parent = {0: None}
        for i in range(leaves - 1):
            leaf = int(rng.integers(i + 1))
            feat = int(rng.integers(f))
            sf[t, i] = feat
            thr[t, i] = float(bounds[feat][int(rng.integers(len(bounds[feat])))])
            new = i + 1
            lc[t, i], rc[t, i] = ~leaf, ~new
            if parent[leaf] is not None:
                node, is_left = parent[leaf]
                (lc if is_left else rc)[t, node] = i
            parent[leaf], parent[new] = (i, True), (i, False)
    values = rng.normal(0.0, 0.05, size=(trees, leaves))
    return Trees(sf, thr, lc, rc, values)


def to_text(model: Trees, feature_names: list[str]) -> str:
    """LightGBM's model.txt of a binary model (numeric splits, no missing
    values: decision_type 2, i.e. default_left with missing_type None)."""
    t_count, nl1 = model.split_feature.shape
    head = [
        "tree", "version=v3", "num_class=1", "num_tree_per_iteration=1",
        "label_index=0", f"max_feature_idx={len(feature_names) - 1}",
        "objective=binary sigmoid:1",
        "feature_names=" + " ".join(feature_names),
        "feature_infos=" + " ".join("none" for _ in feature_names), "",
    ]
    body = []
    for t in range(t_count):
        body += [
            f"Tree={t}", f"num_leaves={nl1 + 1}", "num_cat=0",
            "split_feature=" + " ".join(str(int(v)) for v in model.split_feature[t]),
            "split_gain=" + " ".join("1" for _ in range(nl1)),
            "threshold=" + " ".join(repr(float(v)) for v in model.threshold[t]),
            "decision_type=" + " ".join("2" for _ in range(nl1)),
            "left_child=" + " ".join(str(int(v)) for v in model.left_child[t]),
            "right_child=" + " ".join(str(int(v)) for v in model.right_child[t]),
            "leaf_value=" + " ".join(repr(float(v)) for v in model.leaf_value[t]),
            "is_linear=0", "shrinkage=1", "", "",
        ]
    return "\n".join(head + body + ["end of trees", ""])
