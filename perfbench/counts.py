"""Operations and bytes of the work a cell asks for, from its shapes and,
where the work depends on the data, from the benchmark's own walk of the
trees over the bins. Each `*_seconds` is a least time on one H100: the
larger of the operations over the peak rate and the bytes over the peak
bandwidth (peaks.py), summed over the pieces of the work.

The kernel bounds copy PERF.md's kernel table: K1 reads the bins of the
rows it keeps, every row's three f32 stats (to see which rows are kept)
and writes its (F, B, 3) f32 output once, at three f32 operations a kept
(row, feature); K2 reads q, k and v and writes out and lse once, at two
products of 2 * D operations a (query, key) pair, in bf16."""

from __future__ import annotations

import numpy as np

from perfbench import peaks

STAT_BYTES = 12          # grad, hess and count, f32, a row


def least(ops: float, nbytes: float, flops_per_s: float) -> float:
    """The larger of the operations at `flops_per_s` and the bytes at the
    card's memory bandwidth."""
    return max(ops / flops_per_s, nbytes / peaks.HBM_BYTES_PER_S)


# ---- K1 and the GBDT fit ------------------------------------------------ #

def k1_launch_seconds(kept_rows: float, rows: int, features: int, bins: int,
                      bin_bytes: int = 1) -> float:
    """K1's least time for one histogram of `kept_rows` of `rows`."""
    nbytes = kept_rows * features * bin_bytes + rows * STAT_BYTES + features * bins * 3 * 4
    return least(kept_rows * features * 3, nbytes, peaks.F32_FLOPS_PER_S)


def fit_seconds(rows: int, features: int, rounds: int, smaller_child_rows: float,
                bin_bytes: int = 1, raw_bytes: int = 4) -> float:
    """Least time of one fit that starts from host rows: the raw f32 rows
    up to the card once (PCIe), read once and binned (bins written once);
    a gradient pass and a score update a round (read margin and label,
    write grad and hess; read and write the margin and read the row's
    leaf value); and, for each split, a histogram of its smaller child
    (LightGBM's subtraction gives the other), `smaller_child_rows` summed
    over every split of every tree, plus one root histogram a tree."""
    upload = rows * features * raw_bytes / peaks.PCIE_BYTES_PER_S
    binning = least(rows * features, rows * features * (raw_bytes + bin_bytes),
                    peaks.F32_FLOPS_PER_S)
    per_round = least(rows * 8, rows * (8 + 8 + 12), peaks.F32_FLOPS_PER_S)
    hist_rows = smaller_child_rows + rounds * rows
    hist = least(hist_rows * features * 3, hist_rows * (features * bin_bytes + STAT_BYTES),
                 peaks.F32_FLOPS_PER_S)
    return upload + binning + rounds * per_round + hist


def node_rows(feature: np.ndarray, thr: np.ndarray, left: np.ndarray, right: np.ndarray,
              bins) -> np.ndarray:
    """Rows that reach each node of one tree in the Booster's layout
    (feature -1 on leaves; bins <= thr go left), by walking `bins`
    (a torch tensor (n, F)) level by level. Returns (M,) int64."""
    import torch

    dev = bins.device
    m = len(feature)
    feat = torch.as_tensor(np.asarray(feature, np.int64), device=dev)
    th = torch.as_tensor(np.asarray(thr, np.int64), device=dev)
    lt = torch.as_tensor(np.asarray(left, np.int64), device=dev)
    rt = torch.as_tensor(np.asarray(right, np.int64), device=dev)
    counts = torch.zeros(m, dtype=torch.int64, device=dev)
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=dev)
    for _ in range(m):
        counts += torch.bincount(node, minlength=m)
        f = feat[node]
        inner = f >= 0
        if not bool(inner.any()):
            break
        node = node[inner]
        col = bins[inner.nonzero()[:, 0], f[inner]].long()
        node = torch.where(col <= th[node], lt[node], rt[node])
    return counts.cpu().numpy()


def smaller_child_rows(feature, left, right, counts: np.ndarray) -> float:
    """Rows of the smaller child, summed over a tree's splits."""
    inner = np.asarray(feature) >= 0
    l, r = np.asarray(left)[inner], np.asarray(right)[inner]
    return float(np.minimum(counts[l], counts[r]).sum())


# ---- GBDT scoring ------------------------------------------------------- #

def score_call_seconds(rows: int, features: int, node_visits: float) -> float:
    """Least time of one scoring call from host f32 rows: the rows up to
    the card once (PCIe), read once on the card, one comparison a node
    that a row visits in a tree, the f32 margin written and read back."""
    upload = rows * features * 4 / peaks.PCIE_BYTES_PER_S
    readback = rows * 4 / peaks.PCIE_BYTES_PER_S
    return upload + least(node_visits, rows * features * 4 + rows * 4,
                          peaks.F32_FLOPS_PER_S) + readback


# ---- the encoder and K2 ------------------------------------------------- #

def encoder_flops_per_token(num_layers: int, d_model: int, d_ff: int, tokens: int,
                            num_outputs: int) -> float:
    """Multiply-adds x 2 a token of the pre-LN encoder: q, k, v and out
    projections, the two MLP products, attention's two products over
    `tokens` keys, and the head (on the pooled row, a share a token)."""
    gemms = 4 * d_model * d_model + 2 * d_model * d_ff
    attention = 2 * tokens * d_model
    return 2 * num_layers * (gemms + attention) + 2 * d_model * num_outputs / tokens


def k2_launch_seconds(batch: int, tokens: int, heads: int, head_dim: int,
                      elt_bytes: int = 2) -> float:
    """K2's least time for one launch, non-causal self-attention in bf16."""
    qkvo = 4 * batch * tokens * heads * head_dim * elt_bytes
    lse = batch * heads * tokens * 4
    ops = 4 * batch * heads * tokens * tokens * head_dim
    return least(ops, qkvo + lse, peaks.BF16_FLOPS_PER_S)


# ---- kernels by name in the device trace -------------------------------- #

K1_PATTERN = r"hist_kernel"                 # csrc/hist_kernel.cu
K2_PATTERN = r"flash_fwd"                   # csrc/flash_attn.cu
GEMM_PATTERN = r"(?i)gemm|xmma|cutlass|nvjet|cublas"
