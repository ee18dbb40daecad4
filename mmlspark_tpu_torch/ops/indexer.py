"""Categorical value indexing.

Reference: `src/value-indexer/` — ValueIndexer.scala:54-185 (typed
distinct -> sorted index with null handling), IndexToValue.scala:26+.
The fitted index is recorded as column metadata (CATEGORY_VALUES), the role
of the reference's MML categorical metadata (core/schema/Categoricals.scala).

A copy of mmlspark_tpu/ops/indexer.py (host numpy code).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.params import Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import CATEGORY_VALUES, Table, as_scalar, host_array
from ..core.serialize import register_stage

__all__ = ["ValueIndexer", "ValueIndexerModel", "IndexToValue"]


def _is_null(v: Any) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    if isinstance(v, np.floating) and np.isnan(v):
        return True
    return False


@register_stage
class ValueIndexer(Estimator):
    """Index distinct values of a column into [0, n). Nulls/NaNs map to the
    last index, mirroring ValueIndexer.scala:38-52 null handling."""

    input_col = Param(None, "column to index", required=True, ptype=str)
    output_col = Param(None, "indexed output column", required=True, ptype=str)

    def _fit(self, table: Table) -> "ValueIndexerModel":
        col = table[self.get("input_col")]
        vals = [as_scalar(v) for v in col]
        non_null = sorted({v for v in vals if not _is_null(v)})
        has_null = any(_is_null(v) for v in vals)
        m = ValueIndexerModel()
        m.set(input_col=self.get("input_col"), output_col=self.get("output_col"))
        m.levels = list(non_null)
        m.has_null = bool(has_null)
        return m


@register_stage
class ValueIndexerModel(Model):
    input_col = Param(None, "column to index", required=True, ptype=str)
    output_col = Param(None, "indexed output column", required=True, ptype=str)

    levels: list = []
    has_null: bool = False

    def _transform(self, table: Table) -> Table:
        lookup = {v: i for i, v in enumerate(self.levels)}
        null_index = len(self.levels)
        out = np.empty(table.num_rows, dtype=np.int32)
        for i, v in enumerate(table[self.get("input_col")]):
            key = as_scalar(v)
            if _is_null(key):
                out[i] = null_index
            elif key in lookup:
                out[i] = lookup[key]
            else:
                raise ValueError(
                    f"ValueIndexerModel: unseen value {key!r} in column "
                    f"{self.get('input_col')!r}"
                )
        meta_levels = list(self.levels) + ([None] if self.has_null else [])
        return table.with_column(
            self.get("output_col"), out, meta={CATEGORY_VALUES: meta_levels}
        )

    def _save_state(self) -> dict[str, Any]:
        return {"levels": list(self.levels), "has_null": self.has_null}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.levels = state["levels"]
        self.has_null = state["has_null"]


@register_stage
class IndexToValue(Transformer):
    """Invert an indexed column back to original values using CATEGORY_VALUES
    metadata. Reference: value-indexer/IndexToValue.scala:26+."""

    input_col = Param(None, "indexed column", required=True, ptype=str)
    output_col = Param(None, "output column", required=True, ptype=str)

    def _transform(self, table: Table) -> Table:
        meta = table.meta(self.get("input_col"))
        levels = meta.get(CATEGORY_VALUES)
        if levels is None:
            raise ValueError(
                f"IndexToValue: column {self.get('input_col')!r} has no "
                f"{CATEGORY_VALUES} metadata"
            )
        idx = host_array(table[self.get("input_col")], np.int64)
        values = [levels[i] if 0 <= i < len(levels) else None for i in idx]
        return table.with_column(self.get("output_col"), values)
