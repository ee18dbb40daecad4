"""Map a single-column stage over many columns.

Reference: `src/multi-column-adapter/MultiColumnAdapter.scala:17+` — clones a
base stage per (input, output) column pair and chains them.

A copy of mmlspark_tpu/ops/adapter.py (host numpy code).
"""

from __future__ import annotations

from typing import Any

from ..core.params import Param
from ..core.pipeline import Estimator, Model, PipelineStage, Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["MultiColumnAdapter", "MultiColumnAdapterModel"]


@register_stage
class MultiColumnAdapter(Estimator):
    base_stage = Param(None, "single-column stage to replicate", required=True)
    input_cols = Param(None, "input columns", required=True, ptype=(list, tuple))
    output_cols = Param(None, "output columns", required=True, ptype=(list, tuple))

    def _cloned_stages(self) -> list[PipelineStage]:
        base: PipelineStage = self.get("base_stage")
        ins, outs = self.get("input_cols"), self.get("output_cols")
        if len(ins) != len(outs):
            raise ValueError("input_cols and output_cols must align")
        return [base.copy({"input_col": i, "output_col": o}) for i, o in zip(ins, outs)]

    def _fit(self, table: Table) -> "MultiColumnAdapterModel":
        fitted: list[Transformer] = []
        current = table
        for stage in self._cloned_stages():
            if isinstance(stage, Estimator):
                model = stage.fit(current)
            else:
                model = stage  # transformer: nothing to fit
            fitted.append(model)
            current = model.transform(current)
        m = MultiColumnAdapterModel()
        m.set(stages=fitted)
        return m

    def _save_state(self) -> dict[str, Any]:
        return {"base_stage": self.get("base_stage")}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(base_stage=state["base_stage"])

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("base_stage", None)
        return d


@register_stage
class MultiColumnAdapterModel(Model):
    stages = Param(None, "fitted per-column stages", ptype=(list, tuple))

    def _transform(self, table: Table) -> Table:
        current = table
        for stage in self.get("stages") or []:
            current = stage.transform(current)
        return current

    def _save_state(self) -> dict[str, Any]:
        return {"stages": list(self.get("stages") or [])}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(stages=state["stages"])

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("stages", None)
        return d
