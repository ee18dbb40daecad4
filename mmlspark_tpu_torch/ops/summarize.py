"""Dataset profiling.

Reference: `src/summarize-data/SummarizeData.scala:99-192` — counts,
quantiles, basic and full statistics per column, emitted as a new table with
one row per input column.

A copy of mmlspark_tpu/ops/summarize.py (host numpy code).
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["SummarizeData"]


@register_stage
class SummarizeData(Transformer):
    counts = Param(True, "include count/unique/missing", ptype=bool)
    basic = Param(True, "include mean/std/min/max", ptype=bool)
    sample = Param(True, "include quantiles", ptype=bool)
    percentiles = Param(True, "include percentile stats", ptype=bool)
    error_threshold = Param(0.0, "quantile error (ignored: exact)", ptype=float)

    _QUANTILES = [0.005, 0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99, 0.995]

    def _transform(self, table: Table) -> Table:
        rows: list[dict] = []
        for name in table.columns:
            col = table[name]
            row: dict = {"Feature": name}
            is_numeric = isinstance(col, np.ndarray) and col.dtype != object and np.issubdtype(col.dtype, np.number)
            vals = np.asarray(col, dtype=np.float64) if is_numeric else None
            if self.get("counts"):
                row["Count"] = float(table.num_rows)
                if is_numeric:
                    row["Unique Value Count"] = float(len(np.unique(vals[~np.isnan(vals)])))
                    row["Missing Value Count"] = float(np.isnan(vals).sum())
                else:
                    seq = list(col)
                    row["Unique Value Count"] = float(len({str(v) for v in seq if v is not None}))
                    row["Missing Value Count"] = float(sum(v is None for v in seq))
            if self.get("basic"):
                if is_numeric and vals[~np.isnan(vals)].size:
                    ok = vals[~np.isnan(vals)]
                    row.update(
                        Mean=float(ok.mean()),
                        Variance=float(ok.var(ddof=1)) if ok.size > 1 else 0.0,
                        Min=float(ok.min()),
                        Max=float(ok.max()),
                    )
                else:
                    row.update(Mean=np.nan, Variance=np.nan, Min=np.nan, Max=np.nan)
            if self.get("sample") or self.get("percentiles"):
                for q in self._QUANTILES:
                    key = f"Quantile_{q}"
                    if is_numeric and vals[~np.isnan(vals)].size:
                        row[key] = float(np.quantile(vals[~np.isnan(vals)], q))
                    else:
                        row[key] = np.nan
            rows.append(row)
        return Table.from_rows(rows)
