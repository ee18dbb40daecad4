"""Columnar Table abstraction — the framework's DataFrame equivalent.

The reference (eisber/mmlspark) builds everything on Spark DataFrames with
column metadata (categorical metadata in `core/schema/src/main/scala/
Categoricals.scala`, score-column bookkeeping in `SparkSchema.scala`,
image/binary schemas in `ImageSchemaUtils.scala` / `BinaryFileSchema.scala`).

A copy of mmlspark_tpu/core/schema.py: a `Table` is an ordered mapping of
column name -> host-resident column (numpy ndarray for rectangular data,
python list for ragged/object data), plus per-column metadata. Numeric
columns move to the device as torch tensors only inside compute stages.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

__all__ = [
    "ColumnMeta",
    "Table",
    "CATEGORY_VALUES",
    "SCORE_KIND",
    "IMAGE_SPEC",
    "as_scalar",
    "find_unused_column_name",
]

# Metadata keys (mirror the roles of the reference's metadata namespaces).
CATEGORY_VALUES = "category_values"  # Categoricals.scala: MML categorical metadata
SCORE_KIND = "score_kind"            # SparkSchema.scala: scores/scored-labels bookkeeping
IMAGE_SPEC = "image_spec"            # ImageSchemaUtils.scala: height/width/channels


class ColumnMeta(dict):
    """Free-form per-column metadata dictionary.

    Mirrors Spark column Metadata (reference `Categoricals.scala`,
    `SparkSchema.scala`) without the JSON ceremony: plain dict with a few
    well-known keys (CATEGORY_VALUES, SCORE_KIND, IMAGE_SPEC).
    """

    def copy(self) -> "ColumnMeta":
        return ColumnMeta(_copy.deepcopy(dict(self)))


def _as_column(values: Any) -> Any:
    """Normalize input into a column: numpy array, or list for ragged/object.
    torch tensors pass through untouched so stages can keep device-resident
    columns on a Table."""
    if isinstance(values, torch.Tensor):
        return values
    if isinstance(values, np.ndarray):
        return values
    if all(hasattr(values, a) for a in ("data", "indices", "indptr", "shape")):
        # CSR matrix (scipy or gbdt.sparse.CSRMatrix): keep sparse — the
        # GBDT binned-dense path consumes it without densifying. The hasattr
        # probe mirrors gbdt.sparse.is_sparse, inlined to keep this hot
        # constructor import-free for dense tables.
        from ..gbdt.sparse import as_features

        return as_features(values)
    if isinstance(values, (list, tuple)):
        vals = list(values)
        if vals and all(isinstance(v, (int, float, bool, np.number)) for v in vals):
            return np.asarray(vals)
        return vals
    # scalars / iterables
    try:
        arr = np.asarray(values)
        if arr.dtype == object:
            return list(values)
        return arr
    except Exception:
        return list(values)


class Table:
    """Ordered columnar batch: the unit flowing through pipelines.

    Equivalent role to a Spark ``Dataset[Row]`` in the reference; columns are
    numpy arrays (possibly multi-dimensional: a (n, d) array is a "vector
    column") or python lists (strings, bytes, ragged sequences, dicts).
    """

    __slots__ = ("_cols", "_meta")

    def __init__(
        self,
        columns: Mapping[str, Any] | None = None,
        meta: Mapping[str, Mapping[str, Any]] | None = None,
    ):
        self._cols: dict[str, Any] = {}
        self._meta: dict[str, ColumnMeta] = {}
        if columns:
            for name, vals in columns.items():
                self._cols[name] = _as_column(vals)
        if meta:
            for name, m in meta.items():
                self._meta[name] = ColumnMeta(m)
        self._check_lengths()

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, Any]]) -> "Table":
        cols: dict[str, list] = {}
        for row in rows:
            for k, v in row.items():
                cols.setdefault(k, []).append(v)
        n = len(rows)
        for k, v in cols.items():
            if len(v) != n:
                raise ValueError(f"column {k!r} missing in some rows")
        return Table(cols)

    def _check_lengths(self) -> None:
        lengths = {name: len(col) for name, col in self._cols.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged table: column lengths differ: {lengths}")

    # -- basic accessors ---------------------------------------------------
    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    @property
    def num_rows(self) -> int:
        if not self._cols:
            return 0
        return len(next(iter(self._cols.values())))

    def __len__(self) -> int:
        return self.num_rows

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> Any:
        if name not in self._cols:
            raise KeyError(f"no column {name!r}; have {self.columns}")
        return self._cols[name]

    def column(self, name: str) -> Any:
        return self[name]

    def meta(self, name: str) -> ColumnMeta:
        return self._meta.get(name, ColumnMeta())

    def rows(self) -> Iterable[dict[str, Any]]:
        names = self.columns
        for i in range(self.num_rows):
            yield {n: self._cols[n][i] for n in names}

    def to_dict(self) -> dict[str, Any]:
        return dict(self._cols)

    # -- functional updates (Tables are treated as immutable by stages) ----
    def with_column(self, name: str, values: Any, meta: Mapping | None = None) -> "Table":
        # ColumnMeta is treated as immutable by stages, so sharing (not
        # deep-copying) existing metadata is safe and O(1).
        cols = dict(self._cols)
        cols[name] = _as_column(values)
        metas = dict(self._meta)
        if meta is not None:
            metas[name] = ColumnMeta(meta)
        elif name in metas:
            del metas[name]  # new values invalidate old column metadata
        out = Table.__new__(Table)
        out._cols, out._meta = cols, metas
        out._check_lengths()
        return out

    def with_columns(self, columns: Mapping[str, Any]) -> "Table":
        """Add/replace several columns in ONE functional update — a chain
        of with_column would copy the column dict and re-validate lengths
        once per column (measurable on the serving hot path, where a
        request fans out into one column per JSON key)."""
        cols = dict(self._cols)
        metas = dict(self._meta)
        for name, values in columns.items():
            cols[name] = _as_column(values)
            metas.pop(name, None)  # new values invalidate old metadata
        out = Table.__new__(Table)
        out._cols, out._meta = cols, metas
        out._check_lengths()
        return out

    def with_meta(self, name: str, meta: Mapping) -> "Table":
        if name not in self._cols:
            raise KeyError(name)
        metas = dict(self._meta)
        metas[name] = ColumnMeta(meta)
        out = Table.__new__(Table)
        out._cols, out._meta = dict(self._cols), metas
        return out

    def drop(self, *names: str) -> "Table":
        cols = {k: v for k, v in self._cols.items() if k not in names}
        metas = {k: v for k, v in self._meta.items() if k not in names}
        return Table(cols, metas)

    def select(self, *names: str) -> "Table":
        missing = [n for n in names if n not in self._cols]
        if missing:
            raise KeyError(f"columns not found: {missing}")
        return Table(
            {n: self._cols[n] for n in names},
            {n: self._meta[n] for n in names if n in self._meta},
        )

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        new_names = [mapping.get(k, k) for k in self._cols]
        dupes = {n for n in new_names if new_names.count(n) > 1}
        if dupes:
            raise ValueError(f"rename would collide on columns: {sorted(dupes)}")
        cols = {mapping.get(k, k): v for k, v in self._cols.items()}
        metas = {mapping.get(k, k): v for k, v in self._meta.items()}
        return Table(cols, metas)

    def take(self, n: int) -> "Table":
        return self.slice(0, min(n, self.num_rows))

    def slice(self, start: int, stop: int) -> "Table":
        cols = {k: v[start:stop] for k, v in self._cols.items()}
        return Table(cols, self._meta)

    def gather(self, indices: Any) -> "Table":
        """Row gather by integer index array (bool masks also accepted)."""
        idx = np.asarray(indices)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        elif idx.size == 0:
            idx = idx.astype(np.intp)
        cols: dict[str, Any] = {}
        for k, v in self._cols.items():
            if isinstance(v, np.ndarray) or hasattr(v, "indptr"):
                cols[k] = v[idx]
            else:
                cols[k] = [v[i] for i in idx.tolist()]
        return Table(cols, self._meta)

    def filter(self, predicate: Callable[[dict], bool]) -> "Table":
        mask = np.asarray([bool(predicate(r)) for r in self.rows()])
        return self.gather(mask)

    def concat(self, other: "Table") -> "Table":
        if set(self.columns) != set(other.columns):
            raise ValueError(
                f"column mismatch: {sorted(self.columns)} vs {sorted(other.columns)}"
            )
        cols: dict[str, Any] = {}
        for k in self.columns:
            a, b = self._cols[k], other._cols[k]
            if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
                cols[k] = np.concatenate([a, b], axis=0)
            elif hasattr(a, "indptr") and hasattr(b, "indptr"):
                from ..gbdt.sparse import CSRMatrix

                cols[k] = CSRMatrix.vstack(a, b)  # stays sparse
            elif hasattr(a, "indptr") or hasattr(b, "indptr"):
                raise ValueError(
                    f"column {k!r} is sparse on one side and dense on the "
                    "other; convert one side before concat"
                )
            else:
                cols[k] = list(a) + list(b)
        return Table(cols, self._meta)

    def shuffle(self, seed: int = 0) -> "Table":
        rng = np.random.default_rng(seed)
        return self.gather(rng.permutation(self.num_rows))

    def split(self, fraction: float, seed: int = 0) -> tuple["Table", "Table"]:
        """Random split into (left, right) with |left| ~= fraction * n."""
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.num_rows)
        cut = int(round(fraction * self.num_rows))
        return self.gather(perm[:cut]), self.gather(perm[cut:])

    # -- fluent ML sugar (reference core/spark FluentAPI.scala:13-30) ------
    def ml_transform(self, *stages) -> "Table":
        """`table.ml_transform(s1, s2, ...)` = run transformers in order
        (reference `df.mlTransform(stage)`)."""
        current = self
        for stage in stages:
            current = stage.transform(current)
        return current

    def ml_fit(self, estimator):
        """`table.ml_fit(est)` = est.fit(table) (reference `df.mlFit`)."""
        return estimator.fit(self)

    # -- misc --------------------------------------------------------------
    def __repr__(self) -> str:
        parts = []
        for name, col in self._cols.items():
            if isinstance(col, np.ndarray):
                parts.append(f"{name}: {col.dtype}{list(col.shape[1:]) or ''}")
            else:
                parts.append(f"{name}: object")
        return f"Table[{self.num_rows} rows]({', '.join(parts)})"

    def equals(self, other: "Table", rtol: float = 1e-5, atol: float = 1e-6) -> bool:
        """Tolerant equality, role of reference DataFrameEquality
        (core/test/base/TestBase.scala:208-277)."""
        if set(self.columns) != set(other.columns) or len(self) != len(other):
            return False
        for k in self.columns:
            a, b = self._cols[k], other._cols[k]
            if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
                if a.shape != b.shape:
                    return False
                if np.issubdtype(a.dtype, np.floating):
                    if not np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True):
                        return False
                elif not np.array_equal(a, b):
                    return False
            else:
                if list(a) != list(b):
                    return False
        return True


def as_scalar(v: Any) -> Any:
    """Normalize a cell to a plain Python scalar (numpy/torch 0-d -> item)."""
    return v.item() if hasattr(v, "item") else v


def find_unused_column_name(prefix: str, table: Table) -> str:
    """Reference: core/schema DatasetExtensions.findUnusedColumnName."""
    name = prefix
    i = 1
    while name in table:
        name = f"{prefix}_{i}"
        i += 1
    return name
