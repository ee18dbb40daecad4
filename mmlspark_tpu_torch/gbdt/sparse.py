"""Sparse (CSR) feature ingestion for the GBDT engine.

Reference: the LightGBM path consumes CSR directly — `generateSparseDataset`
(src/lightgbm/src/main/scala/LightGBMUtils.scala:358-394) and `CSRUtils.scala`
marshal SparseVector rows into `LGBM_DatasetCreateFromCSRSpark`.

A copy of mmlspark_tpu/gbdt/sparse.py (SURVEY.md §7 "sparse inputs"): the
device kernels want dense, statically-shaped arrays, so sparse input is
**binned dense** — the raw
float64 matrix is never fully materialized; instead rows are densified in
bounded-memory chunks and immediately quantized to the (n, F) int32 bin
matrix the histogram kernels consume (4 bytes/cell instead of 8, and the
float chunk is the only transient). Binning a column at a time keeps the
quantile sketch bit-identical to the dense path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

__all__ = ["CSRMatrix", "is_sparse", "as_features"]

# transient dense-chunk budget for CSR -> binned conversion
DEFAULT_MEMORY_BUDGET_MB = 256.0


@dataclass
class CSRMatrix:
    """Minimal row-compressed matrix: the framework's SparseVector-dataset
    equivalent. Wraps (data, indices, indptr, shape) — the exact triplet the
    reference marshals through SWIG (LightGBMUtils.scala:358-394)."""

    data: np.ndarray      # (nnz,) float64
    indices: np.ndarray   # (nnz,) int — column of each value
    indptr: np.ndarray    # (n+1,) int — row start offsets
    shape: tuple[int, int]

    def __post_init__(self):
        self.data = np.asarray(self.data, np.float64)
        self.indices = np.asarray(self.indices, np.int64)
        self.indptr = np.asarray(self.indptr, np.int64)
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        if len(self.indptr) != self.shape[0] + 1:
            raise ValueError(
                f"indptr length {len(self.indptr)} != rows+1 ({self.shape[0] + 1})"
            )

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_scipy(m: Any) -> "CSRMatrix":
        csr = m.tocsr() if hasattr(m, "tocsr") else m
        return CSRMatrix(csr.data, csr.indices, csr.indptr, tuple(csr.shape))

    @staticmethod
    def from_dense(x: np.ndarray) -> "CSRMatrix":
        x = np.asarray(x, np.float64)
        mask = x != 0.0
        rows_nnz = mask.sum(axis=1)
        indptr = np.concatenate([[0], np.cumsum(rows_nnz)])
        rr, cc = np.nonzero(mask)
        return CSRMatrix(x[rr, cc], cc, indptr, x.shape)

    # -- container protocol (lets a CSRMatrix sit in a Table column) -------
    def __len__(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(len(self.data))

    def __getitem__(self, key):
        """Row selection: int -> dense 1-d row; slice / index array / bool
        mask -> CSRMatrix (Table.gather/slice/rows all route here)."""
        n = self.shape[0]
        if np.isscalar(key) or (isinstance(key, np.ndarray) and key.ndim == 0):
            i = int(key)
            i = i + n if i < 0 else i
            if not 0 <= i < n:
                raise IndexError(f"row {key} out of range for {n} rows")
            return self.to_dense(i, i + 1)[0]
        if isinstance(key, slice):
            key = np.arange(*key.indices(n))
        idx = np.asarray(key)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        idx = idx.astype(np.int64)
        idx = np.where(idx < 0, idx + n, idx)  # Python-style wraparound
        if len(idx) and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"row index out of range for {n} rows")
        counts = self.indptr[idx + 1] - self.indptr[idx]
        out_indptr = np.concatenate([[0], np.cumsum(counts)])
        # vectorized take: for each selected row, an arange of its nnz span
        total = int(counts.sum())
        if total:
            # position within the output minus the output row start gives the
            # offset into the source row's span
            row_of = np.repeat(np.arange(len(idx)), counts)
            within = np.arange(total) - out_indptr[row_of]
            take = self.indptr[idx][row_of] + within
        else:
            take = np.zeros(0, np.int64)
        return CSRMatrix(self.data[take], self.indices[take], out_indptr,
                         (len(idx), self.shape[1]))

    @staticmethod
    def vstack(a: "CSRMatrix", b: "CSRMatrix") -> "CSRMatrix":
        """Row-wise concatenation without densifying (Table.concat path)."""
        if a.shape[1] != b.shape[1]:
            raise ValueError(f"column mismatch: {a.shape[1]} vs {b.shape[1]}")
        return CSRMatrix(
            np.concatenate([a.data, b.data]),
            np.concatenate([a.indices, b.indices]),
            np.concatenate([a.indptr, a.indptr[-1] + b.indptr[1:]]),
            (a.shape[0] + b.shape[0], a.shape[1]),
        )

    # -- densification -----------------------------------------------------
    def to_dense(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        """Densify rows [start, stop) — the bounded transient used by the
        chunked binning pass."""
        stop = self.shape[0] if stop is None else min(stop, self.shape[0])
        nrows = max(stop - start, 0)
        out = np.zeros((nrows, self.shape[1]), np.float64)
        lo, hi = self.indptr[start], self.indptr[stop]
        if hi > lo:
            row_of = np.repeat(
                np.arange(nrows),
                (self.indptr[start + 1 : stop + 1] - self.indptr[start:stop]),
            )
            out[row_of, self.indices[lo:hi]] = self.data[lo:hi]
        return out

    def column(self, j: int) -> np.ndarray:
        """Full dense column j (one column of transient memory, O(n)) — feeds
        the per-feature quantile sketch so sparse binning is bit-identical to
        dense binning."""
        col = np.zeros(self.shape[0], np.float64)
        sel = self.indices == j
        if sel.any():
            row_of = np.repeat(
                np.arange(self.shape[0]), np.diff(self.indptr)
            )[sel]
            col[row_of] = self.data[sel]
        return col

    def iter_columns(self) -> Iterator[np.ndarray]:
        """Yield dense columns in order with ONE csc-style sort up front
        (avoids rescanning nnz per feature)."""
        order = np.argsort(self.indices, kind="stable")
        sorted_cols = self.indices[order]
        sorted_vals = self.data[order]
        row_of = np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))[order]
        starts = np.searchsorted(sorted_cols, np.arange(self.shape[1] + 1))
        for j in range(self.shape[1]):
            col = np.zeros(self.shape[0], np.float64)
            lo, hi = starts[j], starts[j + 1]
            col[row_of[lo:hi]] = sorted_vals[lo:hi]
            yield col

    def chunk_rows(self, memory_budget_mb: float = DEFAULT_MEMORY_BUDGET_MB) -> int:
        """Rows per dense chunk that keep the float64 transient under budget."""
        bytes_per_row = max(self.shape[1], 1) * 8
        return max(int(memory_budget_mb * 1e6 // bytes_per_row), 1)


def is_sparse(x: Any) -> bool:
    """CSRMatrix or anything CSR-duck-typed (scipy.sparse.csr_matrix/csr_array)."""
    return all(hasattr(x, a) for a in ("data", "indices", "indptr", "shape"))


def as_features(x: Any) -> "np.ndarray | CSRMatrix":
    """Normalize a features input: CSR stays sparse (binned-dense path),
    everything else becomes a float64 ndarray."""
    if isinstance(x, CSRMatrix):
        return x
    if is_sparse(x):
        return CSRMatrix.from_scipy(x)
    x = np.asarray(x, np.float64)
    return x
