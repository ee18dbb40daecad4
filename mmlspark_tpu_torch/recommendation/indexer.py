"""RecommendationIndexer — map raw user/item values to dense int ids.

Reference: src/recommendation/src/main/scala/RecommendationIndexer.scala:
16-130 (string indexer pair + inverse transform for recommendations).

A copy of mmlspark_tpu/recommendation/indexer.py (host only).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.params import Param
from ..core.pipeline import Estimator, Model
from ..core.schema import Table, as_scalar
from ..core.serialize import register_stage

__all__ = ["RecommendationIndexer", "RecommendationIndexerModel"]


@register_stage
class RecommendationIndexer(Estimator):
    user_input_col = Param(None, "raw user column", required=True, ptype=str)
    user_output_col = Param(None, "indexed user column", required=True, ptype=str)
    item_input_col = Param(None, "raw item column", required=True, ptype=str)
    item_output_col = Param(None, "indexed item column", required=True, ptype=str)
    rating_col = Param(None, "rating column (passed through)", ptype=str)

    def _fit(self, table: Table) -> "RecommendationIndexerModel":
        users = sorted({as_scalar(v) for v in table[self.get("user_input_col")]})
        items = sorted({as_scalar(v) for v in table[self.get("item_input_col")]})
        m = RecommendationIndexerModel(
            user_input_col=self.get("user_input_col"),
            user_output_col=self.get("user_output_col"),
            item_input_col=self.get("item_input_col"),
            item_output_col=self.get("item_output_col"),
        )
        m.user_levels = users
        m.item_levels = items
        return m


@register_stage
class RecommendationIndexerModel(Model):
    user_input_col = Param(None, "raw user column", required=True, ptype=str)
    user_output_col = Param(None, "indexed user column", required=True, ptype=str)
    item_input_col = Param(None, "raw item column", required=True, ptype=str)
    item_output_col = Param(None, "indexed item column", required=True, ptype=str)

    user_levels: list = []
    item_levels: list = []

    @property
    def n_users(self) -> int:
        """Full user vocabulary size (for SAR.set_indexer_model)."""
        return len(self.user_levels)

    @property
    def n_items(self) -> int:
        """Full item vocabulary size (for SAR.set_indexer_model)."""
        return len(self.item_levels)

    def _transform(self, table: Table) -> Table:
        u_map = {v: i for i, v in enumerate(self.user_levels)}
        i_map = {v: i for i, v in enumerate(self.item_levels)}
        u = np.asarray([u_map[as_scalar(v)] for v in table[self.get("user_input_col")]],
                       np.float64)
        it = np.asarray([i_map[as_scalar(v)] for v in table[self.get("item_input_col")]],
                        np.float64)
        return (table.with_column(self.get("user_output_col"), u)
                .with_column(self.get("item_output_col"), it))

    def recover_user(self, idx: int) -> Any:
        return self.user_levels[int(idx)]

    def recover_item(self, idx: int) -> Any:
        return self.item_levels[int(idx)]

    def inverse_transform_items(self, item_ids) -> list:
        """Recommendation id lists -> raw item values
        (RecommendationIndexer.scala inverse transform)."""
        return [[self.item_levels[int(i)] for i in row] for row in item_ids]

    def _save_state(self) -> dict[str, Any]:
        return {"user_levels": list(self.user_levels),
                "item_levels": list(self.item_levels)}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.user_levels = state["user_levels"]
        self.item_levels = state["item_levels"]
