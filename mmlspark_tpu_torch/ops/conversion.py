"""Column type coercion.

Reference: `src/data-conversion/DataConversion.scala:23+` — convert columns
to boolean/byte/short/int/long/float/double/string/date with a format.

A copy of mmlspark_tpu/ops/conversion.py; `device_kernel` (the stage's
kernel in a fused segment, core/fusion.py) runs in torch.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["DataConversion"]

_NUMPY_TYPES = {
    "boolean": np.bool_,
    "byte": np.int8,
    "short": np.int16,
    "integer": np.int32,
    "long": np.int64,
    "float": np.float32,
    "double": np.float64,
}

_TORCH_TYPES = {
    "boolean": "bool",
    "byte": "int8",
    "short": "int16",
    "integer": "int32",
    "float": "float32",
}


@register_stage
class DataConversion(Transformer):
    cols = Param(None, "columns to convert", required=True, ptype=(list, tuple))
    convert_to = Param(
        None,
        "target type: boolean|byte|short|integer|long|float|double|string|date",
        required=True,
        ptype=str,
    )
    date_time_format = Param("%Y-%m-%d %H:%M:%S", "format for date conversion", ptype=str)

    def _transform(self, table: Table) -> Table:
        target = self.get("convert_to")
        out = table
        for c in self.get("cols"):
            col = table[c]
            if target in _NUMPY_TYPES:
                if not isinstance(col, np.ndarray):
                    col = np.asarray([float(v) for v in col])
                out = out.with_column(c, col.astype(_NUMPY_TYPES[target]))
            elif target == "string":
                vals = col.tolist() if isinstance(col, np.ndarray) else col
                out = out.with_column(c, [str(v) for v in vals])
            elif target == "date":
                fmt = self.get("date_time_format")
                out = out.with_column(
                    c, [_dt.datetime.strptime(str(v), fmt) for v in col]
                )
            elif target == "toCategorical":
                from .indexer import ValueIndexer

                model = ValueIndexer(input_col=c, output_col=c).fit(out)
                out = model.transform(out)
            elif target == "clearCategorical":
                meta = dict(out.meta(c))
                meta.pop("category_values", None)
                out = out.with_meta(c, meta)
            else:
                raise ValueError(f"DataConversion: unknown target type {target!r}")
        return out

    # targets whose device cast matches numpy's astype bit-for-bit; long and
    # double are 64-bit (uploads narrow them, as the reference's x64-off
    # jax does), string/date/categorical are host-side
    _DEVICE_TARGETS = ("boolean", "byte", "short", "integer", "float")

    def device_kernel(self):
        """Fusion kernel: `.to(target)` per column. Narrow-int targets
        wrap modulo 2^bits in both numpy and torch; float->int truncates
        toward zero in both (the `ready` check rejects non-finite or
        out-of-range floats, where the two disagree). float64/int64 inputs
        stay on host — they would silently downcast on upload."""
        import torch

        from ..core.fusion import DeviceKernel

        target = self.get("convert_to")
        if target not in self._DEVICE_TARGETS:
            return f"target {target!r} converts on host"
        np_dtype = _NUMPY_TYPES[target]
        torch_dtype = getattr(torch, _TORCH_TYPES[target])
        cols_ = tuple(self.get("cols"))

        def fn(params, cols):
            return {c: cols[c].to(torch_dtype) for c in cols_}

        def ready(table: Table):
            int_target = np.issubdtype(np_dtype, np.integer)
            lo, hi = ((np.iinfo(np_dtype).min, np.iinfo(np_dtype).max)
                      if int_target else (None, None))
            for c in cols_:
                col = table[c]
                if col.dtype.itemsize > 4 and col.dtype != np.bool_:
                    return (f"column {c!r} is {col.dtype} (would downcast "
                            "on device upload)")
                if int_target and np.issubdtype(col.dtype, np.floating):
                    finite = np.isfinite(col)
                    if not finite.all() or (col.min() < lo or col.max() > hi):
                        return (f"column {c!r} has values outside {target} "
                                "range (float->int overflow is undefined)")
            return True

        return DeviceKernel(
            fn=fn, input_cols=cols_, output_cols=cols_, name="DataConversion",
            out_dtypes={c: np_dtype for c in cols_}, ready=ready)
