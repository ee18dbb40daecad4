"""Imputation.

Reference: `src/clean-missing-data/CleanMissingData.scala:46-157` —
mean/median/custom fill over selected columns.

A copy of mmlspark_tpu/ops/missing.py; `CleanMissingDataModel`'s
`device_kernel` (its kernel in a fused segment, core/fusion.py) runs in
torch.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.params import Param
from ..core.pipeline import Estimator, Model
from ..core.schema import Table, host_array
from ..core.serialize import register_stage

__all__ = ["CleanMissingData", "CleanMissingDataModel"]

MEAN = "Mean"
MEDIAN = "Median"
CUSTOM = "Custom"


@register_stage
class CleanMissingData(Estimator):
    input_cols = Param(None, "columns to clean", required=True, ptype=(list, tuple))
    output_cols = Param(None, "output columns", required=True, ptype=(list, tuple))
    cleaning_mode = Param(
        MEAN,
        "Mean | Median | Custom",
        ptype=str,
        validator=lambda v: v in (MEAN, MEDIAN, CUSTOM),
    )
    custom_value = Param(None, "fill value for Custom mode", ptype=(int, float))

    def _fit(self, table: Table) -> "CleanMissingDataModel":
        ins, outs = self.get("input_cols"), self.get("output_cols")
        if len(ins) != len(outs):
            raise ValueError("input_cols and output_cols must align")
        mode = self.get("cleaning_mode")
        fills: list[float] = []
        for c in ins:
            col = host_array(table[c], np.float64)
            valid = col[~np.isnan(col)]
            if mode == MEAN:
                fills.append(float(valid.mean()) if valid.size else 0.0)
            elif mode == MEDIAN:
                fills.append(float(np.median(valid)) if valid.size else 0.0)
            else:
                if self.get("custom_value") is None:
                    raise ValueError("Custom mode requires custom_value")
                fills.append(float(self.get("custom_value")))
        m = CleanMissingDataModel()
        m.set(input_cols=list(ins), output_cols=list(outs))
        m.fill_values = fills
        return m


@register_stage
class CleanMissingDataModel(Model):
    input_cols = Param(None, "columns to clean", required=True, ptype=(list, tuple))
    output_cols = Param(None, "output columns", required=True, ptype=(list, tuple))

    fill_values: list = []

    def _transform(self, table: Table) -> Table:
        out = table
        for c, o, fill in zip(
            self.get("input_cols"), self.get("output_cols"), self.fill_values
        ):
            col = host_array(table[c])
            if col.dtype == np.float32:
                # keep float32 columns float32 (fill rounds to the column
                # dtype) — the layout the device path uses, so fused and
                # staged runs produce the same bytes
                filled = np.where(np.isnan(col), np.float32(fill), col)
            else:
                col = col.astype(np.float64)
                filled = np.where(np.isnan(col), fill, col)
            out = out.with_column(o, filled)
        return out

    def device_kernel(self):
        """Fusion kernel: `where(isnan(x), fill, x)` elementwise. Only
        float32 columns fuse — the staged path computes float64 columns in
        float64, and the fill value is generally not representable in
        float32, so a device (f32) run could not be byte-identical."""
        import torch

        from ..core.fusion import DeviceKernel

        ins = tuple(self.get("input_cols"))
        outs = tuple(self.get("output_cols"))
        fills = [np.float32(f) for f in self.fill_values]

        def fn(params, cols):
            result = {}
            for c, o, fill in zip(ins, outs, fills):
                x = cols[c]
                result[o] = x.masked_fill(torch.isnan(x), float(fill))
            return result

        def ready(table: Table):
            for c in ins:
                col = table[c]
                if col.dtype != np.float32:
                    return (f"column {c!r} is {col.dtype} (float64 fill "
                            "values are not representable on device)")
            return True

        return DeviceKernel(
            fn=fn, input_cols=ins, output_cols=outs,
            name="CleanMissingData",
            out_dtypes={o: np.float32 for o in outs}, ready=ready)

    def _save_state(self) -> dict[str, Any]:
        return {"fill_values": list(self.fill_values)}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.fill_values = state["fill_values"]
