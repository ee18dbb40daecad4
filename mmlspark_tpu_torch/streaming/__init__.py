"""Structured streaming: micro-batch queries over device pipelines.

A copy of mmlspark_tpu/streaming for the port: a PipelineModel transform
(and a partition-parallel query's pre-shuffle stages) runs fused on
`device` ("cuda" by default; "cpu" eagerly), every other module is host
code.

Reference: Spark Structured Streaming as used by the reference's serving
and PowerBI stories — "deploy any streaming query as a web service"
(docs/mmlspark-serving.md), `PowerBIWriter.stream`, and the
DistributedHTTPSource getOffset/getBatch/commit contract. The reference
leans on Spark's ~9.9k-LoC streaming/DataSource plumbing (VERDICT.md's
LoC diagnostic); this package is the native counterpart.

Design: a `StreamingQuery` drives source -> transform -> sink micro-batch
ticks. Any `core.pipeline` Transformer/PipelineModel is a streaming
transform — its fused segments capture their CUDA graphs on the first
batch and replay them for the life of the query (capture-once /
stream-forever).
Exactly-once comes from three pieces working together:

- deterministic, replayable sources (`DirectorySource`, `ServingSource`);
- a write-ahead commit log (`CommitLog`) that records each batch's offset
  range BEFORE the batch runs and its commit after the sink write, plus
  per-batch snapshots of stateful-operator state;
- idempotent batch-id-named sink writes (`ParquetSink`'s atomic
  `part-<batch_id>` files, `MemorySink`'s keyed buffer, the serving
  journal's duplicate-reply suppression behind `ReplySink`).

A killed query restarts from the last committed batch, replays the
in-flight batch against the exact planned offsets, and the sink skips
anything it already wrote — output is identical to a one-shot batch
`Pipeline.transform` over the same input.

Distributed execution (shuffle.py / partition.py): a `KeyedShuffle`
stage splits the pipeline, `ParallelStreamingQuery` runs the stateful
chain over P key-partitions — on driver threads or across a fleet of
worker processes — with per-partition incremental checkpoints, and the
kill-restart byte-identity guarantee holds at any P. `StreamStreamJoin`
and `StreamTableJoin` are the first operators requiring the shuffle.
"""

from .checkpoint import CommitLog
from .joins import StreamStreamJoin, StreamTableJoin
from .partition import (
    ParallelStreamingQuery,
    PartitionWorkerFactory,
    ThreadPartitionWorker,
    split_pipeline_at_shuffle,
)
from .query import StreamingQuery
from .shuffle import (
    KeyedShuffle,
    partition_of,
    split_by_partition,
    stable_hash,
)
from .sinks import (
    ForeachBatchSink,
    MemorySink,
    ParquetSink,
    PowerBISink,
    ReplySink,
    Sink,
)
from .sources import (
    DirectorySource,
    MemorySource,
    ServingSource,
    SocketSource,
    Source,
)
from .state import (
    GroupedAggregator,
    MemoryStateBackend,
    SpillingStateBackend,
    StateBackend,
    StatefulOperator,
    WindowedAggregator,
)

__all__ = [
    "CommitLog",
    "StreamingQuery",
    "ParallelStreamingQuery",
    "KeyedShuffle",
    "stable_hash",
    "partition_of",
    "split_by_partition",
    "split_pipeline_at_shuffle",
    "ThreadPartitionWorker",
    "PartitionWorkerFactory",
    "StreamStreamJoin",
    "StreamTableJoin",
    "StateBackend",
    "MemoryStateBackend",
    "SpillingStateBackend",
    "Source",
    "DirectorySource",
    "MemorySource",
    "SocketSource",
    "ServingSource",
    "Sink",
    "MemorySink",
    "ParquetSink",
    "ForeachBatchSink",
    "PowerBISink",
    "ReplySink",
    "StatefulOperator",
    "GroupedAggregator",
    "WindowedAggregator",
]
