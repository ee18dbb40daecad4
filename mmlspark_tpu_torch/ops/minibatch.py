"""Mini-batching transformers.

Reference: `src/io/http/src/main/scala/MiniBatchTransformer.scala:42-203` —
DynamicMiniBatchTransformer (:42), TimeIntervalMiniBatchTransformer (:65),
FixedMiniBatchTransformer (:138), FlattenBatch (:173); buffered batchers in
`Batchers.scala:12-140`.

TPU-first: batches become *rows whose cells are sequences*; the deep-model
runner pads each batch to a static shape bucket before jit execution (XLA
needs static shapes — SURVEY.md §7 "Dynamic shapes").

A copy of mmlspark_tpu/ops/minibatch.py (host numpy code).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table, host_array
from ..core.serialize import register_stage

__all__ = [
    "FixedMiniBatchTransformer",
    "DynamicMiniBatchTransformer",
    "TimeIntervalMiniBatchTransformer",
    "FlattenBatch",
]


def _batch_table(table: Table, sizes: list[int]) -> Table:
    cols: dict[str, list] = {}
    for name in table.columns:
        col = table[name]
        batches, start = [], 0
        for s in sizes:
            chunk = col[start : start + s]
            batches.append(chunk if isinstance(chunk, np.ndarray) else list(chunk))
            start += s
        cols[name] = batches
    return Table(cols)


@register_stage
class FixedMiniBatchTransformer(Transformer):
    """Group rows into fixed-size batches (MiniBatchTransformer.scala:138-169)."""

    batch_size = Param(None, "rows per batch", required=True, ptype=int)
    max_buffer_size = Param(None, "kept for API parity (unused)", ptype=int)
    buffered = Param(False, "kept for API parity (unused)", ptype=bool)

    def _transform(self, table: Table) -> Table:
        bs = self.get("batch_size")
        if bs < 1:
            raise ValueError("batch_size must be >= 1")
        n = table.num_rows
        sizes = [min(bs, n - i) for i in range(0, n, bs)]
        return _batch_table(table, sizes)


@register_stage
class DynamicMiniBatchTransformer(Transformer):
    """Batch whatever is available at once (MiniBatchTransformer.scala:42-63).
    On a materialized Table all rows are 'available', so this emits one batch
    — matching the reference's behavior for a fully-buffered partition."""

    max_batch_size = Param(None, "cap on batch size", ptype=int)

    def _transform(self, table: Table) -> Table:
        n = table.num_rows
        cap = self.get("max_batch_size") or n or 1
        sizes = [min(cap, n - i) for i in range(0, n, cap)] if n else []
        return _batch_table(table, sizes)


@register_stage
class TimeIntervalMiniBatchTransformer(Transformer):
    """Batch rows arriving within an interval
    (MiniBatchTransformer.scala:65-136). Streaming-only concept; for a
    materialized Table it requires an arrival-time column to group by."""

    interval_ms = Param(
        None, "interval in milliseconds", required=True, ptype=int,
        validator=lambda v: v > 0,
    )
    arrival_time_col = Param(None, "epoch-ms column giving arrival times", ptype=str)
    max_batch_size = Param(None, "cap on batch size", ptype=int)

    def _transform(self, table: Table) -> Table:
        tcol = self.get("arrival_time_col")
        if tcol is None:
            return DynamicMiniBatchTransformer(
                max_batch_size=self.get("max_batch_size")
            ).transform(table)
        times = host_array(table[tcol], np.int64)
        if not np.all(np.diff(times) >= 0):
            raise ValueError("arrival times must be sorted")
        interval = self.get("interval_ms")
        cap = self.get("max_batch_size") or table.num_rows
        sizes: list[int] = []
        start = 0
        while start < table.num_rows:
            end = start
            while (
                end < table.num_rows
                and times[end] - times[start] < interval
                and end - start < cap
            ):
                end += 1
            sizes.append(end - start)
            start = end
        return _batch_table(table, sizes)


@register_stage
class FlattenBatch(Transformer):
    """Invert batching: one row per element (MiniBatchTransformer.scala:173-203)."""

    def _transform(self, table: Table) -> Table:
        if table.num_rows == 0:
            return table
        cols: dict[str, list] = {name: [] for name in table.columns}
        for name in table.columns:
            for batch in table[name]:
                cols[name].extend(list(batch))
        lengths = {k: len(v) for k, v in cols.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"FlattenBatch: inconsistent batch lengths {lengths}")
        return Table(cols)
