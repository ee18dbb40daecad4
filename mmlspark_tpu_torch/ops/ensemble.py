"""Prediction aggregation by key.

Reference: `src/ensemble/EnsembleByKey.scala:21+` — group rows by key
column(s), aggregate chosen scalar/vector columns (mean or collect).

A copy of mmlspark_tpu/ops/ensemble.py (host numpy code; its
`device_kernel` declares why the stage stays on the host).
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table, as_scalar, host_array
from ..core.serialize import register_stage

__all__ = ["EnsembleByKey"]


@register_stage
class EnsembleByKey(Transformer):
    keys = Param(None, "key columns", required=True, ptype=(list, tuple))
    cols = Param(None, "columns to aggregate", required=True, ptype=(list, tuple))
    col_names = Param(None, "output names (default '<agg>(col)')", ptype=(list, tuple))
    strategy = Param(
        "mean", "aggregation: mean | collect", ptype=str,
        validator=lambda v: v in ("mean", "collect"),
    )
    collapse_group = Param(True, "one row per key (else broadcast back)", ptype=bool)
    vector_dims = Param(None, "kept for API parity (unused)", ptype=dict)

    def _transform(self, table: Table) -> Table:
        keys = list(self.get("keys"))
        cols = list(self.get("cols"))
        names = list(self.get("col_names") or [f"{self.get('strategy')}({c})" for c in cols])
        if len(names) != len(cols):
            raise ValueError("col_names must align with cols")

        key_tuples = [
            tuple(as_scalar(table[k][i]) for k in keys) for i in range(table.num_rows)
        ]
        order: dict[tuple, list[int]] = {}
        for i, kt in enumerate(key_tuples):
            order.setdefault(kt, []).append(i)

        agg: dict[str, list] = {k: [] for k in keys}
        for name in names:
            agg[name] = []
        for kt, idxs in order.items():
            for k, kv in zip(keys, kt):
                agg[k].append(kv)
            for c, name in zip(cols, names):
                col = table[c]
                vals = [col[i] for i in idxs]
                if self.get("strategy") == "mean":
                    agg[name].append(np.mean(host_array(vals, np.float64), axis=0))
                else:
                    agg[name].append([as_scalar(v) for v in vals])
        grouped = Table({k: v for k, v in agg.items()})
        if self.get("collapse_group"):
            return grouped
        # broadcast aggregate back onto original rows
        pos = {kt: j for j, kt in enumerate(order)}
        out = table
        for name in names:
            col = grouped[name]
            vals = [col[pos[kt]] for kt in key_tuples]
            out = out.with_column(name, vals)
        return out

    def device_kernel(self):
        """Non-fusable (core/fusion.py): groupby over python key tuples with
        a DATA-DEPENDENT output row count — neither expressible as a
        fixed-shape row-independent device program. The planner surfaces
        this reason in the plan text."""
        return ("groupby with data-dependent output shape "
                "(row count depends on key values)")
