"""Streaming sinks: idempotent addBatch(batchId, table).

A copy of mmlspark_tpu/streaming/sinks.py (host only; `ParquetSink` needs
pyarrow, imported when it writes).

Reference: Spark's `Sink` trait — `addBatch(batchId, data)` with the
documented contract that a sink asked to write a batchId it has already
written must SKIP it, because the engine replays the in-flight batch
after recovery. The reference's `HTTPSink` keys replies by
(name, partitionId, requestId) for the same reason
(HTTPSourceV2.scala:421-476) and `PowerBIWriter` is its fire-and-forget
HTTP sink (PowerBIWriter.scala:98-107).

Exactly-once lands here: the commit log guarantees a replayed batch
carries the same id and (via planned offsets + deterministic sources)
the same rows, so batch-id-named idempotent writes make the replay a
no-op. `ParquetSink` gets this from atomic `part-<batchId>` files,
`MemorySink` from a keyed buffer, `ReplySink` from the serving journal's
duplicate-reply suppression. `ForeachBatchSink` and `PowerBISink` are
at-least-once unless the user's callback/dataset dedupes on batch_id —
same caveat Spark documents for foreachBatch and its HTTP sinks.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

from ..core.schema import Table
from ..observability.sanitizer import make_lock
from ..core.table_io import write_parquet

__all__ = ["Sink", "MemorySink", "ParquetSink", "ForeachBatchSink",
           "PowerBISink", "ReplySink"]


class Sink:
    """Base streaming sink."""

    def add_batch(self, batch_id: int, table: Table) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Keyed in-memory buffer (Spark's memory sink): `table()` concatenates
    committed batches in batch-id order. Idempotent — a replayed batch_id
    is dropped."""

    def __init__(self) -> None:
        self._lock = make_lock("MemorySink._lock")
        self._batches: dict[int, Table] = {}

    def add_batch(self, batch_id: int, table: Table) -> None:
        with self._lock:
            if batch_id in self._batches:
                return
            self._batches[batch_id] = table

    def table(self) -> Table:
        with self._lock:
            items = sorted(self._batches.items())
        out: "Table | None" = None
        for _bid, t in items:
            if t.num_rows == 0:
                continue
            out = t if out is None else out.concat(t)
        return out if out is not None else Table({})

    def batch_ids(self) -> list[int]:
        with self._lock:
            return sorted(self._batches)


class ParquetSink(Sink):
    """One `part-<batchId>.parquet` per batch, written to a dot-prefixed
    temp name and os.replace'd into place — the visible file is always
    complete, and an existing part file means a pre-crash attempt already
    wrote this batch (identical bytes, by the replay contract), so the
    write is skipped. Empty batches produce no file."""

    _PART_FMT = "part-{:09d}.parquet"

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _part(self, batch_id: int) -> str:
        return os.path.join(self.path, self._PART_FMT.format(batch_id))

    def add_batch(self, batch_id: int, table: Table) -> None:
        if table.num_rows == 0:
            return
        final = self._part(batch_id)
        if os.path.exists(final):
            return
        tmp = os.path.join(
            self.path, f".tmp-{self._PART_FMT.format(batch_id)}")
        write_parquet(table, tmp)
        os.replace(tmp, final)

    def table(self) -> Table:
        """All committed parts concatenated in batch order (test/validation
        convenience, mirroring MemorySink.table)."""
        from ..core.table_io import read_parquet

        out: "Table | None" = None
        for name in sorted(os.listdir(self.path)):
            if name.startswith("part-") and name.endswith(".parquet"):
                t = read_parquet(os.path.join(self.path, name))
                out = t if out is None else out.concat(t)
        return out if out is not None else Table({})


class ForeachBatchSink(Sink):
    """User callback per batch (Spark's foreachBatch): fn(table, batch_id).
    At-least-once — after a crash between the callback and the commit
    record, the replayed batch calls fn again with the SAME batch_id, so
    callbacks that need exactly-once must dedupe on it."""

    def __init__(self, fn: Callable[[Table, int], Any]) -> None:
        self.fn = fn

    def add_batch(self, batch_id: int, table: Table) -> None:
        self.fn(table, batch_id)


class PowerBISink(Sink):
    """Each batch POSTs to a Power BI push dataset via PowerBIWriter — the
    reference's `writeStream.format("console")`-free production demo
    (PowerBIWriter.scala `stream`). At-least-once: the REST API has no
    batch-id dedupe, so a crash inside the commit window can repost a
    batch (true of the reference's sink too)."""

    def __init__(self, url: str, batch_size: int = 100,
                 concurrency: int = 1, client: Any = None) -> None:
        self.url = url
        self.batch_size = batch_size
        self.concurrency = concurrency
        self.client = client
        self.requests_sent = 0

    def add_batch(self, batch_id: int, table: Table) -> None:
        if table.num_rows == 0:
            return
        from ..io_http.powerbi import PowerBIWriter

        self.requests_sent += PowerBIWriter.write(
            table, self.url, batch_size=self.batch_size,
            concurrency=self.concurrency, client=self.client)


class ReplySink(Sink):
    """Completes ServingSource batches: expects `id` + `reply` columns (the
    shape `make_reply` produces with the id carried through) and answers
    the parked HTTP exchanges. Exactly-once rides on the serving journal:
    a replayed batch's already-answered ids are suppressed as duplicates
    inside ServingServer.reply."""

    def __init__(self, server: Any) -> None:
        self.server = server

    def add_batch(self, batch_id: int, table: Table) -> None:
        if table.num_rows == 0:
            return
        self.server.reply_table(table)
