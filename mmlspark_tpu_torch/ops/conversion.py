"""Column type coercion.

Reference: `src/data-conversion/DataConversion.scala:23+` — convert columns
to boolean/byte/short/int/long/float/double/string/date with a format.

A copy of mmlspark_tpu/ops/conversion.py (host numpy code). Not
ported: `device_kernel` (the stage's kernel in a fused segment), which
waits for fusion, ROADMAP item 11.
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
