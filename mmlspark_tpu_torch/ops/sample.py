"""Sampling stages.

Reference: `src/partition-sample/PartitionSample.scala:24-137` — modes: head,
random rate (global/per-partition), assign to buckets.

A copy of mmlspark_tpu/ops/sample.py (host numpy code).
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["PartitionSample"]


@register_stage
class PartitionSample(Transformer):
    mode = Param(
        "RandomSample",
        "Head | RandomSample | AssignToPartition",
        ptype=str,
        validator=lambda v: v in ("Head", "RandomSample", "AssignToPartition"),
    )
    count = Param(1000, "rows for Head mode", ptype=int)
    percent = Param(0.1, "sample rate for RandomSample", ptype=float)
    seed = Param(0, "random seed", ptype=int)
    new_col_name = Param("Partition", "bucket column for AssignToPartition", ptype=str)
    num_parts = Param(10, "bucket count for AssignToPartition", ptype=int)

    def _transform(self, table: Table) -> Table:
        mode = self.get("mode")
        if mode == "Head":
            return table.take(self.get("count"))
        rng = np.random.default_rng(self.get("seed"))
        if mode == "RandomSample":
            mask = rng.random(table.num_rows) < self.get("percent")
            return table.gather(mask)
        buckets = rng.integers(0, self.get("num_parts"), size=table.num_rows)
        return table.with_column(self.get("new_col_name"), buckets.astype(np.int32))
