"""Feature binning: continuous/categorical values -> small integer bins.

Reference: lib_lightgbm's BinMapper (invoked through `LGBM_DatasetCreateFromMat`
at src/lightgbm/src/main/scala/LightGBMUtils.scala:326-394) builds per-feature
histogram bins on the native side; categorical slots come from column metadata
(`LightGBMUtils.scala:63-88` getCategoricalIndexes).

A copy of the host path of mmlspark_tpu/gbdt/binning.py: binning is a
one-time host-side preprocessing pass (numpy), because it is data-dependent
(quantile sketch over distinct values) and runs once per fit. The *output* —
a dense (n, F) int32 bin matrix — is exactly what the device-side histogram
kernel wants: static shape, small cardinality. `transform_device` bins
numeric features on a torch device instead: one binary search per cell
against the boundaries in float32 (`bin_on_device`, which the fused
bin -> traverse scoring program of booster.py shares).

Bin layout per feature (LightGBM-compatible semantics):
  - numeric: bins are right-closed intervals; `upper_bounds[f, b]` is the
    largest raw value mapped to bin b. Missing (NaN) maps to its own bin 0
    and bin 0 sorts "left" in every split (missing goes left by default).
  - categorical: raw value v (non-negative int-ish) maps to a bin by
    frequency rank; unseen/overflow categories map to bin 0 (the "other"
    bin). Splits on categorical features are many-vs-many bin SUBSETS
    chosen by the engine's sorted-prefix search (engine.py); the other-bin
    always routes right.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["BinMapper", "MISSING_BIN", "bin_on_device"]

# Bin 0 is reserved: NaN/missing for numeric features, "other" for categorical.
MISSING_BIN = 0


@dataclass
class BinMapper:
    """Per-feature quantile binning (numeric) / frequency binning (categorical)."""

    max_bin: int = 255
    categorical_indexes: tuple[int, ...] = ()
    # LightGBM `bin_construct_sample_cnt` (default 200000): boundaries are
    # sketched from a deterministic per-column sample once a column exceeds
    # this many finite values — the sketch cost stops scaling with n.
    # Categorical frequency maps always use the full column (their cost is
    # one np.unique, and sampling could drop rare categories entirely).
    bin_construct_sample_cnt: int = 200_000
    # fitted state
    num_features: int = 0
    num_bins: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    upper_bounds: np.ndarray = field(default_factory=lambda: np.zeros((0, 0)))
    category_maps: dict[int, dict[float, int]] = field(default_factory=dict)

    @property
    def total_bins(self) -> int:
        return int(self.num_bins.max(initial=1))

    def fit(self, x) -> "BinMapper":
        """Accepts a dense (n, F) matrix or a CSR input (CSRMatrix / scipy).

        The sparse path feeds one dense column at a time into the identical
        per-feature sketch, so sparse and dense fits are bit-identical
        (the reference's generateSparseDataset produces the same BinMapper
        as its dense path inside lib_lightgbm, LightGBMUtils.scala:358-394)."""
        from .sparse import as_features, is_sparse

        if is_sparse(x):
            x = as_features(x)
            f = x.shape[1]
            columns = x.iter_columns()
        else:
            x = np.asarray(x, dtype=np.float64)
            f = x.shape[1]
            columns = (x[:, j] for j in range(f))
        self.num_features = f
        cat = set(int(i) for i in self.categorical_indexes)
        # +1 for the reserved missing/other bin
        bounds = np.full((f, self.max_bin + 1), np.inf, dtype=np.float64)
        nbins = np.zeros(f, dtype=np.int32)
        for j, col in enumerate(columns):
            finite = col[np.isfinite(col)]
            if j in cat:
                vals, counts = np.unique(finite, return_counts=True)
                order = np.argsort(-counts, kind="stable")
                kept = vals[order][: self.max_bin]
                self.category_maps[j] = {float(v): i + 1 for i, v in enumerate(kept)}
                nbins[j] = len(kept) + 1
                continue
            sample_cnt = int(self.bin_construct_sample_cnt)
            if 0 < sample_cnt < len(finite):
                # deterministic per-column sample: dense and CSR fits see
                # identical columns, so the sketch stays path-independent
                idx = np.random.default_rng(1 + j).choice(
                    len(finite), size=sample_cnt, replace=False)
                finite = finite[np.sort(idx)]
            # canonicalize -0.0 -> +0.0: CSR inputs drop signed zeros, and
            # boundaries must serialize identically for sparse/dense parity
            uniq = np.unique(finite + 0.0)
            if len(uniq) == 0:
                nbins[j] = 1
                continue
            if len(uniq) <= self.max_bin:
                # one bin per distinct value; boundary = the value itself
                ub = uniq
            else:
                # quantile sketch: equal-count boundaries over the sample
                qs = np.linspace(0, 1, self.max_bin + 1)[1:]
                ub = np.unique(np.quantile(finite, qs, method="higher"))
            nbins[j] = len(ub) + 1
            bounds[j, 1 : len(ub) + 1] = ub
            bounds[j, len(ub)] = np.inf  # top bin catches everything above
        self.upper_bounds = bounds
        self.num_bins = nbins
        return self

    def transform(self, x, memory_budget_mb: float | None = None) -> np.ndarray:
        """Raw (n, F) float matrix (dense or CSR) -> (n, F) int32 bin matrix.

        CSR inputs are densified in row chunks sized by `memory_budget_mb`
        (the binned-dense strategy: only the int32 bin matrix is ever fully
        materialized, never the raw float64 matrix)."""
        from .sparse import DEFAULT_MEMORY_BUDGET_MB, as_features, is_sparse

        if is_sparse(x):
            csr = as_features(x)
            budget = memory_budget_mb or DEFAULT_MEMORY_BUDGET_MB
            step = csr.chunk_rows(budget)
            out = np.zeros(csr.shape, dtype=np.int32)
            for start in range(0, csr.shape[0], step):
                stop = min(start + step, csr.shape[0])
                out[start:stop] = self.transform(csr.to_dense(start, stop))
            return out
        x = np.asarray(x, dtype=np.float64)
        n, f = x.shape
        if f != self.num_features:
            raise ValueError(f"expected {self.num_features} features, got {f}")
        out = np.zeros((n, f), dtype=np.int32)
        cat = set(self.category_maps)
        # native dataset-build path (the generateDenseDataset analogue,
        # mmlspark_tpu_torch/native): numeric features binned in C++ when the
        # toolchain is available — bit-identical to the numpy path below
        from ..native import bin_numeric as _native_bin

        is_cat_arr = np.zeros(f, np.uint8)
        for j in cat:
            is_cat_arr[j] = 1
        did_native = _native_bin(
            x, np.asarray(self.upper_bounds, np.float64),
            np.asarray(self.num_bins, np.int32), is_cat_arr, out,
        )
        for j in range(f):
            col = x[:, j]
            if j in cat:
                cmap = self.category_maps[j]
                if not cmap:
                    continue
                keys = np.fromiter(cmap.keys(), np.float64, len(cmap))
                bins_of = np.fromiter(cmap.values(), np.int32, len(cmap))
                order = np.argsort(keys)
                keys, bins_of = keys[order], bins_of[order]
                safe = np.where(np.isfinite(col), col, np.inf)
                idx = np.searchsorted(keys, safe)
                idx_c = np.minimum(idx, len(keys) - 1)
                hit = (idx < len(keys)) & (keys[idx_c] == safe)
                out[:, j] = np.where(hit, bins_of[idx_c], MISSING_BIN)
                continue
            if did_native:
                continue  # numeric features already binned in C++
            nb = int(self.num_bins[j])
            if nb <= 1:
                continue
            ub = self.upper_bounds[j, 1:nb]
            # searchsorted over right-closed bin upper bounds; NaN -> bin 0.
            # ±inf bins by COMPARISON (-inf -> lowest bin, +inf -> top bin),
            # matching LightGBM's `value <= threshold` routing — only NaN
            # takes the missing bin.
            binned = np.searchsorted(ub, col, side="left") + 1
            binned = np.clip(binned, 1, nb - 1)
            binned[np.isnan(col)] = MISSING_BIN
            out[:, j] = binned
        return out

    def transform_device(self, x, device: "str | torch.device" = "cuda") -> "torch.Tensor":
        """Numeric binning on `device`: (n, F) raw values -> the (n, F)
        int32 bin matrix as a tensor there, equal bit for bit to the JAX
        package's `transform_device` (mmlspark_tpu/gbdt/binning.py:187).

        The values and the boundaries compare in float32, so a value that
        straddles a boundary distinguishable only in float64 may land one
        bin off the host `transform`; `Booster.train(device_binning=True)`
        snaps the boundaries through float32 first, so that both agree.
        Categorical features are refused."""
        import torch

        from ..core.kernels import resolve_device

        if self.category_maps:
            raise ValueError("device binning does not support categorical features")
        dev = resolve_device(device)
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.num_features:
            raise ValueError(f"expected (n, {self.num_features}) features, got {x.shape}")
        ub = np.asarray(self.upper_bounds[:, 1:max(self.total_bins, 2)], np.float32)
        return bin_on_device(torch.as_tensor(ub, device=dev),
                             torch.as_tensor(self.num_bins, dtype=torch.int32, device=dev),
                             torch.as_tensor(x, device=dev))

    # -- serialization (used by Booster.save_native_model) -----------------
    def to_dict(self) -> dict:
        return {
            "max_bin": self.max_bin,
            "bin_construct_sample_cnt": self.bin_construct_sample_cnt,
            "categorical_indexes": list(self.categorical_indexes),
            "num_features": self.num_features,
            "num_bins": self.num_bins.tolist(),
            "upper_bounds": self.upper_bounds.tolist(),
            "category_maps": {str(k): {str(v): b for v, b in m.items()} for k, m in self.category_maps.items()},
        }

    @staticmethod
    def from_dict(d: dict) -> "BinMapper":
        bm = BinMapper(
            max_bin=int(d["max_bin"]),
            categorical_indexes=tuple(d.get("categorical_indexes", ())),
            bin_construct_sample_cnt=int(
                d.get("bin_construct_sample_cnt", 200_000)),
        )
        bm.num_features = int(d["num_features"])
        bm.num_bins = np.asarray(d["num_bins"], dtype=np.int32)
        bm.upper_bounds = np.asarray(d["upper_bounds"], dtype=np.float64)
        bm.category_maps = {
            int(k): {float(v): int(b) for v, b in m.items()} for k, m in d.get("category_maps", {}).items()
        }
        return bm


def bin_on_device(keys: "torch.Tensor", nb: "torch.Tensor", x: "torch.Tensor") -> "torch.Tensor":
    """Bins of the f32 values x (n, F) against per-feature f32 keys (F, K),
    nondecreasing along K, on their device: count(keys < x) + 1 by
    `torch.searchsorted(right=False)`, clipped to [1, nb - 1]; NaN goes to
    MISSING_BIN and a feature with nb <= 1 bins every row to 0, as the host
    transform does. Returns (n, F) int32."""
    import torch

    xt = x.t().contiguous()                                             # (F, n)
    cnt = torch.searchsorted(keys.contiguous(), xt, right=False, out_int32=True)
    top = torch.clamp(nb - 1, min=1)[:, None]
    b = torch.minimum(torch.clamp(cnt + 1, min=1), top)
    b = torch.where(torch.isnan(xt), MISSING_BIN, b)
    b = torch.where(nb[:, None] <= 1, 0, b)
    return b.to(torch.int32).t().contiguous()
