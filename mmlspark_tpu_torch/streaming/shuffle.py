"""Keyed shuffle: hash-by-key row routing between source and stateful

A copy of mmlspark_tpu/streaming/shuffle.py (host only).
operators.

Reference: Spark's exchange/repartition boundary — `groupBy(key)` on a
stream inserts a hash shuffle so every row of a key lands on the SAME
partition, which is what lets per-key state live unreplicated on one
worker. The reference leans on Spark's whole shuffle service; here the
exchange is a pure function over a `Table` plus a registered marker
stage, and `streaming/partition.py` supplies the workers.

Determinism is the whole design: Python's builtin `hash` is salted per
process, so partition routing uses a keyed blake2b digest (the same
`_stable_hash` construction as io_http's consistent-hash ring). The same
key maps to the same partition in every process, every run — which is
what makes P-way output reproducible and kill-restart replay byte-exact
across driver and fleet-worker incarnations.

`split_by_partition` preserves within-partition row order (gather over
an ascending index mask), so for any key the sequence of rows a
partition sees equals that key's subsequence of the original stream —
stateful folds per key are order-identical at P=1 and P=N.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["stable_hash", "partition_of", "partition_ids",
           "split_by_partition", "KeyedShuffle"]


def stable_hash(key: Any) -> int:
    """Process-stable 64-bit hash of a key (via `str`)."""
    digest = hashlib.blake2b(str(key).encode("utf-8"),
                             digest_size=8).digest()
    return int.from_bytes(digest, "big")


def partition_of(key: Any, num_partitions: int) -> int:
    return stable_hash(key) % num_partitions


def partition_ids(table: Table, key_col: str,
                  num_partitions: int) -> "np.ndarray":
    """Partition id per row, same length as the table."""
    return np.array([partition_of(k, num_partitions)
                     for k in table[key_col]], dtype=np.int64)


def split_by_partition(table: Table, key_col: str,
                       num_partitions: int) -> "list[Table]":
    """Split rows into `num_partitions` tables by key hash. Every row of
    a key lands in exactly one output; each output preserves the input's
    relative row order; concatenating the outputs is a permutation of
    the input."""
    if num_partitions <= 1:
        return [table]
    if not table.num_rows:
        return [table.gather(np.zeros(0, dtype=np.int64))
                for _ in range(num_partitions)]
    pids = partition_ids(table, key_col, num_partitions)
    return [table.gather(pids == p) for p in range(num_partitions)]


@register_stage
class KeyedShuffle(Transformer):
    """The exchange boundary as a registered pipeline stage.

    Inside a `ParallelStreamingQuery` pipeline the stage is a MARKER:
    stages before it run on the driver, stages after it run once per
    partition on rows routed by `hash(key_col) % num_partitions` (the
    stage itself is cut out of both halves). Run standalone,
    `transform` annotates rows with their target partition in
    `partition_col` — useful for auditing routing and for tests.
    """

    key_col = Param("key", "column whose hash routes each row to a "
                    "partition", ptype=str)
    num_partitions = Param(2, "number of parallel partitions (P)",
                           ptype=int, validator=lambda v: v >= 1)
    partition_col = Param("partition", "output column holding the routed "
                          "partition id (standalone transform only)",
                          ptype=str)

    def _transform(self, table: Table) -> Table:
        pids = partition_ids(table, self.get("key_col"),
                             self.get("num_partitions"))
        return table.with_column(self.get("partition_col"), pids)
