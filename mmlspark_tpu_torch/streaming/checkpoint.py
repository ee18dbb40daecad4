"""Write-ahead commit log + state snapshots for streaming queries.

A copy of mmlspark_tpu/streaming/checkpoint.py (host only).

Reference contract: Spark's streaming checkpoint directory holds an
`offsets/<batchId>` file written BEFORE a batch runs and a
`commits/<batchId>` file written after the sink accepts it; on restart
the query replays the last planned-but-uncommitted batch against the
exact offsets in its plan file. That plan-first ordering is what makes
replay deterministic: the restarted query re-forms the in-flight batch
from the RECORDED offset range, not from whatever the source contains
now, so an idempotent sink sees byte-identical data for the same
batch id.

TPU redesign: one append-only JSONL log (`commits.jsonl`) carries both
record types — `{"t": "plan", "batch_id", "start", "end"}` and
`{"t": "commit", "batch_id"}` — with the serving journal's durability
idioms (io_http/journal.py): write+flush+fsync per record, torn-tail
detection with on-disk truncation at load, atomic compact via
`utils.storage.atomic_write` (tmp → fsync → os.replace → dir-fsync).
Stateful-operator snapshots live beside it as `state-<batchId>.json`,
written atomically before the sink write so a replayed batch restarts
its operators from the state that PRECEDED the crashed attempt. A
snapshot that fails to parse at recovery (bit-flip, torn pre-upgrade
write) is skipped — recovery falls back to the newest older snapshot at
or before the last commit and emits a `checkpoint.corrupt` recorder
event plus a `mmlspark_tpu_checkpoint_corrupt_total` count.
"""

from __future__ import annotations

import json
import os
import threading

from ..observability.sanitizer import allow_blocking, make_lock
from ..utils.storage import atomic_write

__all__ = ["CommitLog"]


def _note_corrupt(path: str, detail: str) -> None:
    """Count + record a snapshot that failed to parse (never raises)."""
    try:
        from ..resilience.elastic import _count, _record

        _count("mmlspark_tpu_checkpoint_corrupt_total",
               "checkpoint snapshots/manifests that failed verification")
        _record("checkpoint.corrupt", file=path, what=detail)
    except Exception:  # noqa: BLE001 — telemetry never blocks recovery
        pass


class CommitLog:
    """Plan/commit write-ahead log under `checkpoint_dir/commits.jsonl`."""

    FILENAME = "commits.jsonl"
    _STATE_FMT = "state-{:09d}.json"

    def __init__(self, checkpoint_dir: str):
        self.dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.path = os.path.join(checkpoint_dir, self.FILENAME)
        self._lock = make_lock("CommitLog._lock")
        self._plans: dict[int, dict] = {}   # batch_id -> {"start", "end"}
        self._committed: set[int] = set()
        self._load()
        self._fh = open(self.path, "a", encoding="utf-8")

    # -- load / durability (journal.py idioms) ---------------------------- #

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
                    break                       # torn record mid-append
                good_end += len(raw)
                self._apply(rec)
        # truncate the torn tail ON DISK (appending after a partial line
        # would fuse the next record onto it — see journal.py._load)
        if good_end < os.path.getsize(self.path):
            with open(self.path, "r+b") as fh:
                fh.truncate(good_end)

    def _apply(self, rec: dict) -> None:
        if rec.get("t") == "plan":
            self._plans[int(rec["batch_id"])] = {
                "start": rec.get("start"), "end": rec.get("end")}
        elif rec.get("t") == "commit":
            self._committed.add(int(rec["batch_id"]))

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

    # -- plan / commit ---------------------------------------------------- #

    def plan(self, batch_id: int, start, end) -> None:
        """Record the offset range of `batch_id` BEFORE running it.
        Offsets are JSON-able dicts (or None for 'beginning of stream')."""
        with self._lock:
            self._plans[batch_id] = {"start": start, "end": end}
            self._append({"t": "plan", "batch_id": batch_id,
                          "start": start, "end": end})
        self._sync()

    def planned(self, batch_id: int) -> dict | None:
        """{"start", "end"} of a planned batch, or None."""
        with self._lock:
            return self._plans.get(batch_id)

    def commit(self, batch_id: int) -> None:
        with self._lock:
            if batch_id in self._committed:
                return
            self._committed.add(batch_id)
            self._append({"t": "commit", "batch_id": batch_id})
        self._sync()

    def last_committed(self) -> int:
        """Highest committed batch id; -1 when nothing has committed."""
        with self._lock:
            return max(self._committed, default=-1)

    # -- state snapshots --------------------------------------------------- #

    def _state_path(self, batch_id: int) -> str:
        return os.path.join(self.dir, self._STATE_FMT.format(batch_id))

    def write_state(self, batch_id: int, doc: dict) -> None:
        """Atomically snapshot stateful-operator state as of AFTER
        `batch_id` (atomic_write: tmp + fsync + rename, so a crash
        mid-write leaves the previous snapshot intact and a replay
        simply overwrites)."""
        atomic_write(self._state_path(batch_id), json.dumps(doc))

    def _state_batch_ids(self) -> "list[int]":
        """Batch ids of all whole-query snapshots on disk, ascending."""
        out = []
        for name in os.listdir(self.dir):
            if not (name.startswith("state-") and name.endswith(".json")):
                continue
            if self._parse_pstate(name) is not None:
                continue                        # per-partition snapshot
            try:
                out.append(int(name[len("state-"):-len(".json")]))
            except ValueError:
                continue
        return sorted(out)

    def read_state(self, batch_id: int) -> dict | None:
        """Newest intact whole-query snapshot at or before `batch_id`.

        A snapshot that no longer parses is skipped (counted and
        recorded) and recovery falls back to the next-older one — a
        stale-but-consistent restore beats discarding all state."""
        for bid in reversed([b for b in self._state_batch_ids()
                             if b <= batch_id]):
            path = self._state_path(bid)
            try:
                with open(path, encoding="utf-8") as fh:
                    return json.load(fh)
            except FileNotFoundError:
                continue
            except (json.JSONDecodeError, UnicodeDecodeError):
                _note_corrupt(path, "state-snapshot")
                continue
        return None

    # -- per-partition incremental snapshots ------------------------------- #
    #
    # A P-way query (streaming/partition.py) checkpoints each partition's
    # operator state in its own file, and only for batches where that
    # partition's state CHANGED — so a batch touching 1 of 64 partitions
    # writes one small file, not the whole state. Recovery reads, per
    # partition, the newest snapshot at or before the last committed
    # batch. The same plan/commit records gate replay; only the snapshot
    # layout is partition-aware.

    _PSTATE_FMT = "state-p{:04d}-{:09d}.json"

    def _pstate_path(self, partition: int, batch_id: int) -> str:
        return os.path.join(self.dir,
                            self._PSTATE_FMT.format(partition, batch_id))

    @staticmethod
    def _parse_pstate(name: str) -> "tuple[int, int] | None":
        """(partition, batch_id) from a per-partition snapshot filename."""
        if not (name.startswith("state-p") and name.endswith(".json")):
            return None
        body = name[len("state-p"):-len(".json")]
        part, sep, bid = body.partition("-")
        if not sep:
            return None
        try:
            return int(part), int(bid)
        except ValueError:
            return None

    def write_partition_state(self, partition: int, batch_id: int,
                              doc: dict) -> None:
        """Atomically snapshot ONE partition's operator state as of after
        `batch_id` (same atomic_write durability as `write_state`)."""
        atomic_write(self._pstate_path(partition, batch_id),
                     json.dumps(doc, sort_keys=True))

    def read_partition_state(self, partition: int,
                             batch_id: int) -> dict | None:
        """Newest intact snapshot of `partition` at or before `batch_id`
        — the incremental layout means the partition may not have written
        at `batch_id` itself if nothing changed since an earlier batch.
        Corrupt snapshots are skipped (counted + recorded) in favor of
        the next-older one."""
        bids = []
        for name in os.listdir(self.dir):
            parsed = self._parse_pstate(name)
            if parsed is not None and parsed[0] == partition \
                    and parsed[1] <= batch_id:
                bids.append(parsed[1])
        for bid in sorted(bids, reverse=True):
            path = self._pstate_path(partition, bid)
            try:
                with open(path, encoding="utf-8") as fh:
                    return json.load(fh)
            except FileNotFoundError:
                continue
            except (json.JSONDecodeError, UnicodeDecodeError):
                _note_corrupt(path, "partition-state-snapshot")
                continue
        return None

    def prune_state(self, keep_from: int) -> None:
        """Drop snapshots recovery can no longer need: whole-query
        snapshots older than `keep_from`, and per-partition snapshots
        superseded by a newer one still at or before `keep_from` (each
        partition's newest <= keep_from file must SURVIVE — with
        incremental writes it may be arbitrarily old)."""
        newest: dict[int, int] = {}     # partition -> newest bid <= keep
        pstates: list[tuple[int, int, str]] = []
        for name in os.listdir(self.dir):
            if not (name.startswith("state-") and name.endswith(".json")):
                continue
            parsed = self._parse_pstate(name)
            if parsed is not None:
                part, bid = parsed
                pstates.append((part, bid, name))
                if bid <= keep_from:
                    newest[part] = max(newest.get(part, -1), bid)
                continue
            try:
                bid = int(name[len("state-"):-len(".json")])
            except ValueError:
                continue
            if bid < keep_from:
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass
        for part, bid, name in pstates:
            if bid < newest.get(part, -1):
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass

    # -- compaction -------------------------------------------------------- #

    def compact(self) -> int:
        """Rewrite the log keeping only the last committed batch's records
        and anything after it (the commit-trimming analogue). The last
        committed plan must SURVIVE compaction: its `end` is the start
        offset of the next batch after a restart. Returns records dropped."""
        with self._lock:
            last = max(self._committed, default=-1)
            keep_plans = {b: p for b, p in self._plans.items() if b >= last}
            keep_commits = {b for b in self._committed if b >= last}
            dropped = (len(self._plans) - len(keep_plans)) + (
                len(self._committed) - len(keep_commits))
            self._plans, self._committed = keep_plans, keep_commits
            lines = []
            for b in sorted(self._plans):
                lines.append(json.dumps({
                    "t": "plan", "batch_id": b,
                    "start": self._plans[b]["start"],
                    "end": self._plans[b]["end"]}) + "\n")
            for b in sorted(self._committed):
                lines.append(json.dumps({"t": "commit", "batch_id": b}) + "\n")
            self._fh.close()
            # stop-the-world by design: writers must stay excluded
            # across the rewrite or their appends land on the replaced fd
            with allow_blocking("commit-log compact rewrite"):
                atomic_write(self.path, "".join(lines))
            self._fh = open(self.path, "a", encoding="utf-8")
            return dropped

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except OSError:
                pass
