"""Preemption-tolerant elastic training: checkpointed resume for the
three training loops (DNNLearner, GBDT boosting, TuneHyperparameters).

A copy of mmlspark_tpu/resilience/elastic.py. The snapshot format is the
same byte for byte, so either package reads the other's snapshots.

The serving/streaming paths have survived kills since the WAL + journal
PRs, but a SIGTERM at epoch 40 of 50 used to lose the whole fit. This
module closes that gap with two small pieces the loops share:

* `TrainingCheckpointer` — crash-consistent snapshot store. Every write
  goes through `utils.storage.atomic_write` (tmp → flush → fsync →
  os.replace → dir-fsync) and every snapshot is self-verifying: the file
  carries a magic header, a blake2b digest, and the payload length, so a
  torn or bit-flipped file is *detected*, never parsed. `load_latest`
  walks the manifest newest→oldest and falls back to the newest snapshot
  that still verifies; a corrupt manifest degrades to a directory scan.

* `PreemptionGuard` — SIGTERM (or any injectable signal source) flips a
  drain flag; the training loop notices at its next step boundary,
  writes a final checkpoint, dumps the flight recorder, and raises
  `Preempted` whose `exit_code` (75, EX_TEMPFAIL) tells the scheduler
  "restart me, I will resume". The drain deadline runs on the injectable
  Clock so chaos tests exercise the timeout with zero real waiting.

Determinism contract (see docs/resilience.md): a resumed fit on the
same mesh shape is byte-identical to the uninterrupted run — snapshots
capture full f32 state and the loops replay their RNG streams from
global positions (epoch/step indices, boosting-round indices) rather
than from "rounds since restart". Across a mesh-size change the resume
is *elastic*: executable caches are keyed on mesh shape so training
recompiles and keeps going, but per-shard RNG folds differ, so
cross-shape runs are statistically equivalent, not bit-equal.
"""

from __future__ import annotations

import json
import hashlib
import os
import re
import signal
import struct
import threading
import time
from typing import Any, Callable

from ..observability.sanitizer import make_lock
from .policy import Clock, SYSTEM_CLOCK
from ..utils.storage import atomic_write

__all__ = [
    "TrainingCheckpointer",
    "PreemptionGuard",
    "Preempted",
    "RESUMABLE_EXIT_CODE",
    "get_active_guard",
    "set_active_guard",
]

#: sysexits.h EX_TEMPFAIL — "transient failure, retry the job". The one
#: exit code preemptible-fleet schedulers already treat as "reschedule".
RESUMABLE_EXIT_CODE = 75

_MAGIC = b"MMLTCKPT"
_DIGEST_SIZE = 16
_HEADER = struct.Struct(f">8s{_DIGEST_SIZE}sQ")  # magic, blake2b, length
_MANIFEST = "manifest.json"
_FILE_RE = re.compile(r"^ckpt-(\d{8})-(.+)\.bin$")


class Preempted(RuntimeError):
    """Raised by a training loop after it drained to a checkpoint.

    Carries the checkpoint path so the caller can log it, and the
    resumable exit code so a `sys.exit(e.exit_code)` at the top level
    tells the scheduler to restart the job rather than fail it."""

    def __init__(self, message: str, checkpoint_path: "str | None" = None):
        super().__init__(message)
        self.checkpoint_path = checkpoint_path
        self.exit_code = RESUMABLE_EXIT_CODE


# -- telemetry (never blocks training) ---------------------------------- #

_LAST_SAVE_LOCK = make_lock("elastic._LAST_SAVE_LOCK")
_LAST_SAVE_T: "float | None" = None
_LAST_SAVE_CLOCK: Clock = SYSTEM_CLOCK


def _checkpoint_age_samples() -> "list":
    with _LAST_SAVE_LOCK:
        if _LAST_SAVE_T is None:
            return []
        return [({}, max(_LAST_SAVE_CLOCK.monotonic() - _LAST_SAVE_T, 0.0))]


def _count(name: str, doc: str, n: float = 1) -> None:
    try:
        from ..observability.metrics import get_registry

        get_registry().counter(name, doc).inc(n)
    except Exception:  # noqa: BLE001 — telemetry never blocks training
        pass


def _note_save(clock: Clock) -> None:
    global _LAST_SAVE_T, _LAST_SAVE_CLOCK
    with _LAST_SAVE_LOCK:
        _LAST_SAVE_T = clock.monotonic()
        _LAST_SAVE_CLOCK = clock
    try:
        from ..observability.metrics import get_registry

        get_registry().register_callback(
            "mmlspark_tpu_checkpoint_last_age_seconds",
            "seconds since the newest training checkpoint was written",
            _checkpoint_age_samples, kind="gauge")
    except Exception:  # noqa: BLE001
        pass


def _record(kind: str, **data: Any) -> None:
    try:
        from ..observability.recorder import get_recorder

        get_recorder().record(kind, **data)
    except Exception:  # noqa: BLE001
        pass


# -- checkpoint store ---------------------------------------------------- #

class TrainingCheckpointer:
    """Atomic, checksummed, lineage-tracked snapshot store for one fit.

    Layout under `directory`:
      ckpt-<seq>-<tag>.bin   magic + blake2b + length + payload
      manifest.json          ordered entries {seq, tag, file, blake2b,
                             bytes, meta, parent_seq, unix_ts}

    Retention keeps the newest `keep` snapshots; older files are
    unlinked but their lineage (parent_seq chain) stays reconstructible
    from the surviving entries. All writes are `atomic_write`, so a kill
    at ANY byte boundary leaves either the previous consistent state or
    the new one — never a torn manifest pointing at a torn snapshot."""

    def __init__(self, directory: str, keep: int = 3,
                 clock: Clock = SYSTEM_CLOCK):
        self.directory = str(directory)
        self.keep = max(int(keep), 1)
        self.clock = clock
        os.makedirs(self.directory, exist_ok=True)
        self._manifest = self._load_manifest()

    # manifest ----------------------------------------------------------- #

    def _manifest_path(self) -> str:
        return os.path.join(self.directory, _MANIFEST)

    def _load_manifest(self) -> dict:
        try:
            with open(self._manifest_path(), encoding="utf-8") as fh:
                doc = json.load(fh)
            if isinstance(doc, dict) and isinstance(doc.get("entries"), list):
                return doc
        except FileNotFoundError:
            # a fresh store — but a manifest deleted out from under
            # surviving snapshots is index loss, handled like corruption
            if not any(_FILE_RE.match(f)
                       for f in os.listdir(self.directory)):
                return {"version": 1, "next_seq": 0, "entries": []}
        except Exception:  # noqa: BLE001 — corrupt manifest, fall through
            pass
        # Manifest torn or nonsense: rebuild what we can from the files
        # themselves (they are self-verifying, the manifest is only the
        # index). Lineage meta is lost for rebuilt entries, resume isn't.
        _count("mmlspark_tpu_checkpoint_corrupt_total",
               "checkpoint snapshots/manifests that failed verification")
        _record("checkpoint.corrupt", dir=self.directory, what="manifest")
        entries = []
        for fname in sorted(os.listdir(self.directory)):
            m = _FILE_RE.match(fname)
            if m:
                entries.append({"seq": int(m.group(1)), "tag": m.group(2),
                                "file": fname, "blake2b": None, "bytes": None,
                                "meta": {}, "parent_seq": None,
                                "unix_ts": None})
        entries.sort(key=lambda e: e["seq"])
        nxt = (entries[-1]["seq"] + 1) if entries else 0
        return {"version": 1, "next_seq": nxt, "entries": entries}

    def entries(self) -> "list[dict]":
        """Manifest entries oldest→newest (copies; for diagnose tables)."""
        return [dict(e) for e in self._manifest["entries"]]

    # write -------------------------------------------------------------- #

    def save(self, payload: bytes, tag: str = "step",
             meta: "dict | None" = None) -> str:
        """Durably write one snapshot and return its path. The snapshot
        file lands (and is fsynced) before the manifest that names it, so
        the manifest never references a file that may not exist."""
        if not isinstance(payload, bytes):
            raise TypeError("checkpoint payload must be bytes")
        tag = re.sub(r"[^A-Za-z0-9._-]", "_", str(tag)) or "step"
        seq = int(self._manifest["next_seq"])
        fname = f"ckpt-{seq:08d}-{tag}.bin"
        digest = hashlib.blake2b(payload, digest_size=_DIGEST_SIZE)
        blob = _HEADER.pack(_MAGIC, digest.digest(), len(payload)) + payload
        path = os.path.join(self.directory, fname)
        atomic_write(path, blob)
        ents = self._manifest["entries"]
        entry = {"seq": seq, "tag": tag, "file": fname,
                 "blake2b": digest.hexdigest(), "bytes": len(payload),
                 "meta": dict(meta or {}),
                 "parent_seq": ents[-1]["seq"] if ents else None,
                 "unix_ts": time.time()}
        ents.append(entry)
        self._manifest["next_seq"] = seq + 1
        doomed = ents[:-self.keep] if len(ents) > self.keep else []
        self._manifest["entries"] = ents[len(doomed):]
        atomic_write(self._manifest_path(),
                     json.dumps(self._manifest, indent=1))
        for old in doomed:  # only after the manifest stopped naming them
            try:
                os.unlink(os.path.join(self.directory, old["file"]))
            except OSError:
                pass
        _note_save(self.clock)
        _count("mmlspark_tpu_checkpoint_writes_total",
               "training checkpoint snapshots written")
        _count("mmlspark_tpu_checkpoint_bytes_total",
               "training checkpoint payload bytes written", len(payload))
        _record("checkpoint.save", dir=self.directory, seq=seq, tag=tag,
                bytes=len(payload))
        return path

    # read --------------------------------------------------------------- #

    @staticmethod
    def verify_file(path: str) -> "tuple[bool, str, bytes | None]":
        """(ok, detail, payload). Detail names the failure mode for the
        diagnose table: missing / short-header / bad-magic / truncated /
        checksum-mismatch / ok."""
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            return False, "missing", None
        if len(blob) < _HEADER.size:
            return False, "short-header", None
        magic, want, length = _HEADER.unpack_from(blob)
        if magic != _MAGIC:
            return False, "bad-magic", None
        payload = blob[_HEADER.size:]
        if len(payload) != length:
            return False, "truncated", None
        got = hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).digest()
        if got != want:
            return False, "checksum-mismatch", None
        return True, "ok", payload

    def load_latest(self, max_world_epoch: "int | None" = None
                    ) -> "tuple[bytes, dict] | None":
        """Newest snapshot that verifies, or None. Corrupt/truncated
        snapshots are skipped (counted + flight-recorded) and the walk
        falls back to the next-newest verified one — a kill mid-write
        costs at most the last `checkpoint_every_n` of progress.

        `max_world_epoch` fences elastic training resumes: a snapshot
        whose `meta["world_epoch"]` is NEWER than the caller's world
        epoch was written by a LATER membership generation — the caller
        is a zombie (a preempted shard resurrected after the fleet moved
        on) and must not adopt state from a future it never joined.
        Refused snapshots are counted and the walk falls back to one the
        caller's epoch may legitimately see."""
        for entry in reversed(self._manifest["entries"]):
            if max_world_epoch is not None:
                snap_epoch = entry.get("meta", {}).get("world_epoch")
                if snap_epoch is not None and \
                        int(snap_epoch) > int(max_world_epoch):
                    _count("mmlspark_tpu_checkpoint_refused_total",
                           "snapshots refused: newer world epoch than the "
                           "restoring driver (zombie fence)")
                    _record("checkpoint.refused", dir=self.directory,
                            seq=entry["seq"], snapshot_epoch=int(snap_epoch),
                            caller_epoch=int(max_world_epoch))
                    continue
            path = os.path.join(self.directory, entry["file"])
            ok, detail, payload = self.verify_file(path)
            if ok and entry.get("blake2b") not in (
                    None, hashlib.blake2b(
                        payload, digest_size=_DIGEST_SIZE).hexdigest()):
                ok, detail = False, "manifest-mismatch"
            if ok:
                _count("mmlspark_tpu_checkpoint_restores_total",
                       "training checkpoint snapshots restored")
                _record("checkpoint.restore", dir=self.directory,
                        seq=entry["seq"], tag=entry["tag"])
                return payload, dict(entry)
            _count("mmlspark_tpu_checkpoint_corrupt_total",
                   "checkpoint snapshots/manifests that failed verification")
            _record("checkpoint.corrupt", dir=self.directory,
                    seq=entry["seq"], file=entry["file"], detail=detail)
        return None


# -- preemption ---------------------------------------------------------- #

_ACTIVE_GUARD: "PreemptionGuard | None" = None
_ACTIVE_LOCK = make_lock("elastic._ACTIVE_LOCK")


def get_active_guard() -> "PreemptionGuard | None":
    """The process-wide guard training loops poll when none is passed
    explicitly (set by `PreemptionGuard.__enter__`/`set_active_guard`)."""
    return _ACTIVE_GUARD


def set_active_guard(guard: "PreemptionGuard | None") -> None:
    global _ACTIVE_GUARD
    with _ACTIVE_LOCK:
        _ACTIVE_GUARD = guard


class PreemptionGuard:
    """Turns SIGTERM into "checkpoint at the next step boundary".

    The signal handler only flips an Event — all real work (final
    checkpoint, flight-recorder dump) happens on the training thread at
    a step boundary, where model state is consistent. `drain_deadline_s`
    runs on the injectable Clock: a loop whose boundary work overruns it
    should skip optional work and get out (`deadline_exceeded()`).

    Tests inject preemption with `request_drain()` instead of a real
    signal; real-process chaos tests send the signal. `install=False`
    (or a non-main thread) skips handler installation entirely."""

    def __init__(self, signals: "tuple[int, ...]" = (signal.SIGTERM,),
                 clock: Clock = SYSTEM_CLOCK,
                 drain_deadline_s: float = 30.0,
                 install: bool = True):
        self.clock = clock
        self.drain_deadline_s = float(drain_deadline_s)
        self._event = threading.Event()
        self._reason: "str | None" = None
        self._drain_t: "float | None" = None
        self._old_handlers: "dict[int, Any]" = {}
        self.installed = False
        if install:
            for sig in signals:
                try:
                    self._old_handlers[sig] = signal.signal(
                        sig, self._on_signal)
                    self.installed = True
                except (ValueError, OSError):  # not main thread / bad sig
                    pass

    def _on_signal(self, signum: int, frame: Any) -> None:
        self.request_drain(reason=f"signal:{signum}")

    def request_drain(self, reason: str = "test") -> None:
        """Idempotent: the first call stamps the drain deadline."""
        if self._event.is_set():
            return
        self._reason = reason
        self._drain_t = self.clock.monotonic()
        self._event.set()
        _count("mmlspark_tpu_preemptions_total",
               "drain requests observed by PreemptionGuard")
        try:
            from ..observability.recorder import get_recorder

            get_recorder().record_transition(
                "preemption", "drain_requested", reason=reason,
                deadline_s=self.drain_deadline_s)
        except Exception:  # noqa: BLE001
            pass

    @property
    def draining(self) -> bool:
        return self._event.is_set()

    def should_checkpoint(self) -> bool:
        """What loops poll at each step boundary."""
        return self._event.is_set()

    def remaining_s(self) -> float:
        if self._drain_t is None:
            return self.drain_deadline_s
        used = self.clock.monotonic() - self._drain_t
        return max(self.drain_deadline_s - used, 0.0)

    def deadline_exceeded(self) -> bool:
        return self._drain_t is not None and self.remaining_s() <= 0.0

    def complete(self, checkpoint_path: "str | None" = None,
                 **detail: Any) -> int:
        """Boundary work done: dump the black box (forced — the process
        is about to die) and hand back the resumable exit code."""
        try:
            from ..observability.recorder import get_recorder

            rec = get_recorder()
            rec.record_transition(
                "preemption", "checkpointed", reason=self._reason,
                checkpoint=checkpoint_path, **detail)
            rec.trigger_dump("preemption", force=True)
        except Exception:  # noqa: BLE001
            pass
        return RESUMABLE_EXIT_CODE

    def uninstall(self) -> None:
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_handlers.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionGuard":
        set_active_guard(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        if get_active_guard() is self:
            set_active_guard(None)
        self.uninstall()


def preempt_now(guard: "PreemptionGuard | None", write: Callable[[], str],
                what: str) -> None:
    """Shared boundary idiom for the training loops: if `guard` (or the
    process-wide active guard) is draining, write the final checkpoint,
    finish the drain, and raise `Preempted`. No-op otherwise."""
    g = guard if guard is not None else get_active_guard()
    if g is None or not g.should_checkpoint():
        return
    path = write() if not g.deadline_exceeded() else None
    g.complete(checkpoint_path=path, what=what)
    raise Preempted(f"{what} preempted; resumable checkpoint "
                    f"{path or 'NOT written (drain deadline exceeded)'}",
                    checkpoint_path=path)
