"""Constrained random Table generation for tests.

Reference: core/test/datagen — `GenerateDataset.scala`, `GenerateRow.scala`,
`DatasetConstraints.scala`, `DatasetOptions.scala`: random typed DataFrames
under declared constraints, feeding schema/serialization tests. Here a
`ColumnSpec` list drives a seeded generator producing a columnar `Table`.

A copy of mmlspark_tpu/utils/datagen.py: the same `np.random.Generator`
draws in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from ..core.schema import CATEGORY_VALUES, Table

__all__ = ["ColumnSpec", "digits_to_images", "generate_table", "holdout_split", "load_label_csv", "random_specs"]

_KINDS = ("double", "int", "bool", "string", "category", "vector")


@dataclass
class ColumnSpec:
    """Constraints for one generated column (DatasetConstraints analogue)."""

    name: str
    kind: str = "double"              # double | int | bool | string | category | vector
    low: float = -100.0               # numeric range (DatasetOptions bounds)
    high: float = 100.0
    null_fraction: float = 0.0        # NaN rate (numeric) / None rate (string)
    cardinality: int = 5              # distinct levels for category columns
    length: int = 8                   # string length / vector width
    values: Sequence[Any] | None = None  # explicit level set (overrides cardinality)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown column kind {self.kind!r}; use one of {_KINDS}")
        if not 0.0 <= self.null_fraction <= 1.0:
            raise ValueError("null_fraction must be in [0, 1]")


_ALPHABET = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def _one_column(spec: ColumnSpec, n: int, rng: np.random.Generator):
    """null_fraction semantics per kind: double/vector -> NaN cells; int ->
    promotes to float64 with NaN (numpy ints can't hold nulls); string/
    category/bool -> None entries (object column)."""
    meta = None
    null_mask = (rng.random(n) < spec.null_fraction) if spec.null_fraction else None
    if spec.kind == "double":
        col = rng.uniform(spec.low, spec.high, size=n)
        if null_mask is not None:
            col[null_mask] = np.nan
    elif spec.kind == "int":
        col = rng.integers(int(spec.low), int(spec.high) + 1, size=n)
        if null_mask is not None:
            col = col.astype(np.float64)
            col[null_mask] = np.nan
    elif spec.kind == "bool":
        col = rng.random(n) < 0.5
        if null_mask is not None:
            col = [None if m else bool(v) for v, m in zip(col, null_mask)]
    elif spec.kind == "string":
        col = ["".join(rng.choice(_ALPHABET, size=spec.length)) for _ in range(n)]
        if null_mask is not None:
            col = [None if m else v for v, m in zip(col, null_mask)]
    elif spec.kind == "category":
        levels = list(spec.values) if spec.values is not None else [
            f"level_{i}" for i in range(spec.cardinality)
        ]
        col = [levels[int(i)] for i in rng.integers(0, len(levels), size=n)]
        if null_mask is not None:
            col = [None if m else v for v, m in zip(col, null_mask)]
        meta = {CATEGORY_VALUES: levels}
    else:  # vector
        col = rng.uniform(spec.low, spec.high, size=(n, spec.length))
        if null_mask is not None:
            col[null_mask] = np.nan
    return col, meta


def generate_table(specs: Sequence[ColumnSpec], n_rows: int, seed: int = 0) -> Table:
    """Random Table honoring every spec (GenerateDataset.scala analogue)."""
    rng = np.random.default_rng(seed)
    cols: dict[str, Any] = {}
    metas: dict[str, Any] = {}
    for spec in specs:
        col, meta = _one_column(spec, n_rows, rng)
        cols[spec.name] = col
        if meta:
            metas[spec.name] = meta
    return Table(cols, metas)


def random_specs(n_cols: int, seed: int = 0,
                 kinds: Sequence[str] = _KINDS) -> list[ColumnSpec]:
    """A random mix of column specs — the fully-random dataset mode
    (GenerateDataset's random space over DatasetOptions)."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_cols):
        kind = str(rng.choice(list(kinds)))
        specs.append(ColumnSpec(
            name=f"col_{i}_{kind}",
            kind=kind,
            low=float(rng.integers(-50, 0)),
            high=float(rng.integers(1, 50)),
            null_fraction=float(rng.choice([0.0, 0.0, 0.1])),
            cardinality=int(rng.integers(2, 6)),
            length=int(rng.integers(2, 10)),
        ))
    return specs


def digits_to_images(x) -> np.ndarray:
    """The 8x8 digits feature matrix (N, 64; ink strength 0-16) as
    (N, 8, 8, 3) float32 images in [0, 255] — the INPUT CONTRACT of the
    zoo's resnet20_digits bundle (tools/build_zoo.py trains on exactly
    this conversion; change it there and here together, or the stocked
    weights silently score garbage)."""
    img = np.repeat(
        np.asarray(x, np.float64).reshape(-1, 8, 8)[..., None], 3, axis=-1)
    return (img * (255.0 / 16.0)).astype(np.float32)


def load_label_csv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """A vendored benchmark CSV (feature columns + 'Label') as (x, y)."""
    from ..core.table_io import read_csv

    t = read_csv(path)
    y = np.asarray(t["Label"], np.float64)
    x = np.stack([np.asarray(t[c], np.float64)
                  for c in t.columns if c != "Label"], axis=1)
    return x, y


def holdout_split(n: int, seed: int = 0,
                  frac: float = 0.8) -> tuple[np.ndarray, np.ndarray]:
    """THE train/holdout contract of the stocked zoo and its gates:
    tools/build_zoo.py trains on the first 80% of seed-0's permutation,
    and every consumer (examples 03/04, tests/test_zoo_content.py) must
    evaluate on the complementary rows — re-deriving this split locally
    risks silently scoring training rows as 'holdout'."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    cut = int(frac * n)
    return order[:cut], order[cut:]
