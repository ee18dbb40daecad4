"""Durable serving journal: checkpoint/restart recovery for batch-mode
serving.

A copy of mmlspark_tpu/io_http/journal.py.

Reference contract: DistributedHTTPSource implements getOffset/getBatch/
commit with batch trimming and documents `checkpointLocation` recovery
(DistributedHTTPSource.scala:308-343, docs/mmlspark-serving.md:50-52) — a
restarted streaming query replays uncommitted requests, and every accepted
request is processed EXACTLY ONCE by the pipeline.

TPU-framework redesign: one append-only JSONL journal per checkpoint dir.
Two record types — `accept` (written when the HTTP frontend parks a
request) and `reply` (written when the scoring path completes it). The
invariant the journal maintains is the reference's: `accepts - replies` is
exactly the set of in-flight requests, under crashes at any point.
Duplicate replies are suppressed at the journal (exactly-once), and
`compact()` is the commit-trimming analogue — fully answered pairs are
dropped once both records are on disk.

The original TCP connection cannot survive a process restart (true in the
reference too — Spark holds the HTTP exchange in memory); what recovery
guarantees is that the accepted request still flows through the handler
and its reply is durably recorded, retrievable via `reply_of`.
"""

from __future__ import annotations

import base64
import json
import os
import threading

from ..observability.sanitizer import allow_blocking, make_lock
from .schema import HTTPRequestData, HTTPResponseData
from ..utils.storage import atomic_write

__all__ = ["ServingJournal"]


class ServingJournal:
    """Append-only accept/reply log under `checkpoint_dir/journal.jsonl`."""

    FILENAME = "journal.jsonl"

    def __init__(self, checkpoint_dir: str):
        self.dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.path = os.path.join(checkpoint_dir, self.FILENAME)
        self._lock = make_lock("ServingJournal._lock")
        self._accepts: dict[str, HTTPRequestData] = {}
        self._replies: dict[str, HTTPResponseData] = {}
        self._load()
        self._fh = open(self.path, "a", encoding="utf-8")

    # -- state ----------------------------------------------------------- #

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        good_end = 0     # byte offset just past the last intact record
        with open(self.path, "rb") as fh:
            for raw in fh:
                if not raw.endswith(b"\n"):
                    break                       # torn tail (no newline)
                line = raw.strip()
                if not line:
                    good_end += len(raw)
                    continue
                try:
                    rec = json.loads(line.decode("utf-8"))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    # torn/corrupt record from a crash mid-append:
                    # everything before it is intact, the torn record's
                    # request was never acknowledged durably — stop here
                    break
                good_end += len(raw)
                self._apply(rec)
        # drop the torn tail ON DISK, not just in memory: appending after
        # a partial line would fuse the next record onto it and a later
        # restart would lose everything from that point on
        if good_end < os.path.getsize(self.path):
            with open(self.path, "r+b") as fh:
                fh.truncate(good_end)

    def _apply(self, rec: dict) -> None:
        if rec.get("t") == "accept":
            self._accepts[rec["id"]] = HTTPRequestData(
                method=rec.get("method", "POST"),
                url=rec.get("url", ""),
                headers=rec.get("headers", {}),
                entity=base64.b64decode(rec["entity"])
                if rec.get("entity") is not None else None,
            )
        elif rec.get("t") == "reply":
            self._replies[rec["id"]] = HTTPResponseData(
                status_code=rec.get("status", 0),
                reason=rec.get("reason", ""),
                headers=rec.get("headers", {}),
                entity=base64.b64decode(rec["entity"])
                if rec.get("entity") is not None else None,
            )

    def _append(self, rec: dict) -> None:
        # Write + flush under the caller's lock (preserves record order);
        # the durability fsync happens in _sync() AFTER the lock is
        # released — group commit.
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def _sync(self) -> None:
        # fsync flushes the whole fd, so records flushed by other threads
        # between our _append and this call ride along for free.
        fh = self._fh
        try:
            os.fsync(fh.fileno())
        except (OSError, ValueError):
            # fd replaced or closed by a concurrent compact()/close();
            # the compacted file is already durable (atomic_write fsyncs
            # before rename), so there is nothing left to sync.
            pass

    # -- recording ------------------------------------------------------- #

    def record_accept(self, ex_id: str, req: HTTPRequestData) -> None:
        with self._lock:
            self._accepts[ex_id] = req
            self._append({
                "t": "accept", "id": ex_id, "method": req.method,
                "url": req.url, "headers": dict(req.headers or {}),
                "entity": base64.b64encode(req.entity).decode()
                if req.entity is not None else None,
            })
        self._sync()

    def record_reply(self, ex_id: str, resp: HTTPResponseData) -> bool:
        """Record a reply; False (and no write) if `ex_id` was already
        answered — the exactly-once guard."""
        with self._lock:
            if ex_id in self._replies:
                return False
            self._replies[ex_id] = resp
            self._append({
                "t": "reply", "id": ex_id,
                "status": resp.status_code, "reason": resp.reason,
                "headers": dict(resp.headers or {}),
                "entity": base64.b64encode(resp.entity).decode()
                if resp.entity is not None else None,
            })
        self._sync()
        return True

    # -- queries --------------------------------------------------------- #

    def unanswered(self) -> dict[str, HTTPRequestData]:
        """Accepted requests with no recorded reply (the replay set)."""
        with self._lock:
            return {i: r for i, r in self._accepts.items()
                    if i not in self._replies}

    def replied(self, ex_id: str) -> bool:
        with self._lock:
            return ex_id in self._replies

    def reply_of(self, ex_id: str) -> HTTPResponseData | None:
        with self._lock:
            return self._replies.get(ex_id)

    def max_id(self) -> int:
        """Largest integer id on record (server id counters resume past it
        so restart never reuses a journaled id)."""
        with self._lock:
            ids = [int(i) for i in
                   list(self._accepts) + list(self._replies)
                   if str(i).isdigit()]
        return max(ids, default=-1)

    # -- commit trimming -------------------------------------------------- #

    def compact(self) -> int:
        """Drop fully answered accept/reply pairs from disk (the
        reference's commit() batch trimming). Returns pairs trimmed.
        Atomic via `utils.storage.atomic_write` (tmp + fsync + rename
        + dir-fsync)."""
        with self._lock:
            answered = [i for i in self._accepts if i in self._replies]
            for i in answered:
                del self._accepts[i]
                del self._replies[i]
            # replies without accepts can't exist (reply() requires the
            # pending exchange), so the rewrite is accepts-only
            lines = [json.dumps({
                "t": "accept", "id": i, "method": r.method,
                "url": r.url, "headers": dict(r.headers or {}),
                "entity": base64.b64encode(r.entity).decode()
                if r.entity is not None else None,
            }) + "\n" for i, r in self._accepts.items()]
            self._fh.close()
            # stop-the-world by design: recorders must stay excluded
            # across the rewrite or their appends land on the replaced fd
            with allow_blocking("journal compact rewrite"):
                atomic_write(self.path, "".join(lines))
            self._fh = open(self.path, "a", encoding="utf-8")
            return len(answered)

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except OSError:
                pass
