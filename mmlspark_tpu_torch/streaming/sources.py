"""Streaming sources: the getOffset/getBatch/commit contract.

A copy of mmlspark_tpu/streaming/sources.py (host only): `DirectorySource`
reads through the port's `read_csv` / `read_parquet` (pyarrow imported
only when a parquet file is read), `ServingSource` drives the port's
batch-mode `ServingServer` and its journal, and leaves the batch in
flight out of the next offset, so each request is scored and journaled
once (ROADMAP Queue 3).

Reference: Spark's `Source` trait as implemented by the reference's
`HTTPSource`/`DistributedHTTPSource` (HTTPSource.scala:46-225,
DistributedHTTPSource.scala:308-343) and the built-in file/socket
sources. `getOffset` reports how far the stream extends right now,
`getBatch(start, end)` materializes the rows in an offset range, and
`commit(end)` lets the source trim anything at or before a durably
processed offset.

Replayability is the property exactly-once hangs on: a source is
REPLAYABLE when `get_batch(start, end)` returns identical rows for the
same range even after a process restart. `DirectorySource` (files are
the durable store) and `ServingSource` (the serving journal re-parks
unanswered requests) are replayable; `MemorySource` and `SocketSource`
are not across restarts (their buffers die with the process) and are
meant for tests and fire-and-forget pipelines.

Offsets are JSON-able dicts so the commit log can persist them verbatim;
`None` means "beginning of stream".
"""

from __future__ import annotations

import fnmatch
import os
import socket
import threading
from typing import Any

from ..core.schema import Table
from ..observability.sanitizer import make_lock
from ..core.table_io import read_csv, read_parquet

__all__ = ["Source", "DirectorySource", "MemorySource", "SocketSource",
           "ServingSource"]


class Source:
    """Base streaming source. Subclasses implement the offset triple."""

    def get_offset(self, start: "dict | None" = None) -> "dict | None":
        """End offset of the NEXT batch given the committed offset `start`
        (None = nothing available). Most sources ignore `start` and report
        the stream's current extent; rate-limited sources (DirectorySource
        with max_files_per_trigger) use it to bound the batch."""
        raise NotImplementedError

    def get_batch(self, start: "dict | None", end: dict) -> Table:
        """Rows in (start, end]. Must be deterministic for a fixed range —
        the commit log replays a crashed batch against its recorded range
        and the sink's idempotence only holds if the data matches."""
        raise NotImplementedError

    def commit(self, end: dict) -> None:
        """`end` is durably processed; the source may trim up to it."""

    def empty_range(self, start: "dict | None", end: dict) -> bool:
        """True when (start, end] contains no rows — lets the driver skip
        planning no-op batches for sources whose offsets move without new
        data (ServingSource's pending set shrinking on replies)."""
        return False

    def close(self) -> None:
        pass


class MemorySource(Source):
    """In-process source fed by `add_rows`; the MemoryStream analogue.

    Offsets count rows ever added: {"rows": n}. Not replayable across a
    process restart (tests and demos only).
    """

    def __init__(self) -> None:
        self._lock = make_lock("MemorySource._lock")
        self._table: "Table | None" = None
        self._base = 0          # rows trimmed by commit()

    def add_rows(self, table: Table) -> None:
        with self._lock:
            self._table = (table if self._table is None
                           else self._table.concat(table))

    def get_offset(self, start: "dict | None" = None) -> "dict | None":
        with self._lock:
            if self._table is None and self._base == 0:
                return None
            n = self._base + (self._table.num_rows if self._table else 0)
        return {"rows": n}

    def get_batch(self, start: "dict | None", end: dict) -> Table:
        lo = (start or {}).get("rows", 0)
        hi = end["rows"]
        with self._lock:
            if lo < self._base:
                raise ValueError(
                    f"offset {lo} was trimmed by commit (base {self._base}) "
                    "— MemorySource cannot replay committed rows")
            if self._table is None:
                return Table({})
            return self._table.slice(lo - self._base, hi - self._base)

    def commit(self, end: dict) -> None:
        with self._lock:
            if self._table is None:
                return
            keep_from = end["rows"] - self._base
            if keep_from > 0:
                self._table = self._table.slice(
                    keep_from, self._table.num_rows)
                self._base = end["rows"]

    def empty_range(self, start: "dict | None", end: dict) -> bool:
        return (start or {}).get("rows", 0) >= end["rows"]


class DirectorySource(Source):
    """File-tailing source: new files matching `pattern` under `path`
    become the next micro-batch (Spark's FileStreamSource).

    The offset is the sorted list of file names seen: {"files": [...]}.
    Deterministic replay holds because a planned batch names its exact
    file delta and files are immutable once they appear — writers MUST
    materialize atomically (write to a dot-prefixed temp name, then
    os.replace into place) or a half-written file becomes part of a
    batch. Format is inferred per file from the extension (.csv /
    .parquet) unless `format` pins one.
    """

    def __init__(self, path: str, pattern: str = "*", *,
                 format: "str | None" = None,
                 max_files_per_trigger: "int | None" = None,
                 **read_kwargs: Any) -> None:
        self.path = path
        self.pattern = pattern
        self.format = format
        self.max_files_per_trigger = max_files_per_trigger
        self.read_kwargs = read_kwargs

    def _list(self) -> list[str]:
        try:
            names = os.listdir(self.path)
        except FileNotFoundError:
            return []
        return sorted(
            n for n in names
            if not n.startswith(".") and fnmatch.fnmatch(n, self.pattern)
            and os.path.isfile(os.path.join(self.path, n)))

    def _read(self, name: str) -> Table:
        full = os.path.join(self.path, name)
        fmt = self.format or os.path.splitext(name)[1].lstrip(".").lower()
        if fmt == "csv":
            return read_csv(full, **self.read_kwargs)
        if fmt == "parquet":
            return read_parquet(full)
        raise ValueError(
            f"cannot infer a reader for {name!r} (format {fmt!r}); pass "
            "format='csv'|'parquet' to DirectorySource")

    def get_offset(self, start: "dict | None" = None) -> "dict | None":
        files = self._list()
        if not files:
            return None
        limit = self.max_files_per_trigger
        if limit is not None:
            # Spark's maxFilesPerTrigger: cap the batch at `limit` UNSEEN
            # files past the committed offset (rate limiting + the knob
            # tests use to force multi-batch streams over a static dir)
            done = set((start or {}).get("files", ()))
            new = [n for n in files if n not in done][:limit]
            files = sorted(done | set(new))
        return {"files": files}

    def get_batch(self, start: "dict | None", end: dict) -> Table:
        done = set((start or {}).get("files", ()))
        batch: "Table | None" = None
        for name in end["files"]:
            if name in done:
                continue
            t = self._read(name)
            batch = t if batch is None else batch.concat(t)
        return batch if batch is not None else Table({})

    def empty_range(self, start: "dict | None", end: dict) -> bool:
        done = set((start or {}).get("files", ()))
        return all(n in done for n in end["files"])


class SocketSource(Source):
    """Line-delimited text over TCP (Spark's socket source): connects as a
    CLIENT to host:port and buffers lines into a `value` column.

    Offsets count lines received: {"rows": n}. NOT replayable across a
    restart — the TCP stream is gone — so use it only for pipelines where
    at-most-once on crash is acceptable (exactly like the reference's
    socket source, which Spark documents as non-fault-tolerant).
    """

    def __init__(self, host: str, port: int,
                 encoding: str = "utf-8") -> None:
        self.host, self.port, self.encoding = host, port, encoding
        self._lock = make_lock("SocketSource._lock")
        self._lines: list[str] = []
        self._base = 0
        self._stop = threading.Event()
        self._sock = socket.create_connection((host, port))
        self._thread = threading.Thread(
            target=self._pump, name="socket-source", daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        buf = b""
        try:
            while not self._stop.is_set():
                chunk = self._sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
                *complete, buf = buf.split(b"\n")
                if complete:
                    decoded = [c.decode(self.encoding, "replace")
                               for c in complete]
                    with self._lock:
                        self._lines.extend(decoded)
        except OSError:
            pass   # connection torn down (close() or peer went away)

    def get_offset(self, start: "dict | None" = None) -> "dict | None":
        with self._lock:
            n = self._base + len(self._lines)
        return {"rows": n} if n else None

    def get_batch(self, start: "dict | None", end: dict) -> Table:
        lo = (start or {}).get("rows", 0)
        with self._lock:
            rows = self._lines[lo - self._base:end["rows"] - self._base]
        return Table({"value": list(rows)})

    def commit(self, end: dict) -> None:
        with self._lock:
            keep_from = end["rows"] - self._base
            if keep_from > 0:
                del self._lines[:keep_from]
                self._base = end["rows"]

    def empty_range(self, start: "dict | None", end: dict) -> bool:
        return (start or {}).get("rows", 0) >= end["rows"]

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._thread.join(timeout=2)


class ServingSource(Source):
    """A batch-mode ServingServer as a streaming source: pending HTTP
    requests become micro-batches of `id` + `request` rows, and a
    `ReplySink` downstream answers them — the reference's
    `readStream.server() ... writeStream.server()` loop
    (docs/mmlspark-serving.md) with a real engine in the middle.

    The offset is the sorted set of pending exchange ids: {"ids": [...]}.
    Requests stay parked in the server until replied, so a planned batch
    replays deterministically: after a crash, the serving journal re-parks
    every unanswered request at server construction and `get_batch` finds
    the planned ids still pending; ids already answered durably are
    dropped by the journal's duplicate-reply suppression on the sink side.
    """

    def __init__(self, server: Any, max_rows: "int | None" = None) -> None:
        if getattr(server, "mode", None) != "batch":
            raise ValueError(
                "ServingSource requires a ServingServer in mode='batch' "
                "(continuous mode replies inline and has no pending set)")
        self.server = server
        self.max_rows = max_rows

    @staticmethod
    def _sort_key(ex_id: str):
        # server ids are integer strings; numeric order = arrival order
        s = str(ex_id)
        return (0, int(s)) if s.isdigit() else (1, s)

    def get_offset(self, start: "dict | None" = None) -> "dict | None":
        # ids of `start` still pending are the batch in flight (a source
        # lookahead asks while it runs): they are not the next batch's.
        # Without this a lookahead re-plans them, the transform scores
        # them twice and, once commit has compacted the journal, a second
        # reply is journaled for each (the JAX package's ServingSource does
        # that: tests/test_torch_streaming.py pins the port's once)
        in_flight = set((start or {}).get("ids", ()))
        tbl = self.server.get_batch(None)
        ids = sorted((str(i) for i in tbl["id"] if str(i) not in in_flight),
                     key=self._sort_key)
        if self.max_rows is not None:
            ids = ids[:self.max_rows]
        return {"ids": ids} if ids else None

    def get_batch(self, start: "dict | None", end: dict) -> Table:
        wanted = [str(i) for i in end["ids"]]
        tbl = self.server.get_batch(None)
        by_id = {str(i): req for i, req in zip(tbl["id"], tbl["request"])}
        missing = [i for i in wanted if i not in by_id]
        if missing:
            # only a durable reply removes a pending request, so a planned
            # id can be absent ONLY when a pre-crash attempt already
            # answered it — exactly-once says skip, not fail
            wanted = [i for i in wanted if i in by_id]
        return Table({"id": wanted, "request": [by_id[i] for i in wanted]})

    def empty_range(self, start: "dict | None", end: dict) -> bool:
        return not end["ids"]

    def commit(self, end: dict) -> None:
        journal = getattr(self.server, "journal", None)
        if journal is not None:
            journal.compact()
