"""Async data plane: host<->device pipelining primitives of the DNN runner.

A copy of mmlspark_tpu/core/dataplane.py's `Prefetcher`, `AsyncReadback`,
`ShapeBucketer` and `ExecutableCache`, without the metrics-registry hooks
(the observability layer is not ported yet) and with a plain
`threading.RLock` for the cache:

* `Prefetcher` — a bounded-depth background thread overlaps host-side
  slice/pad + the host->device copy of batch N+1 with device compute on
  batch N. Depth 0 is the synchronous path (identical results, zero
  threads).
* `AsyncReadback` — result fetch with a bounded lag, so host readback of
  batch N-1 overlaps compute on batch N.
* `ShapeBucketer` — a pad-to-bucket ladder (powers of two up to the max
  batch size) with row masks, so ragged tails map into a small closed set
  of shapes.
* `ExecutableCache` — per-(family, bucket shape) entries with
  hit/miss/recompile counters.

Framework-free: callers pass the `prepare`/build callables that touch the
device.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np

__all__ = ["Prefetcher", "AsyncReadback", "ShapeBucketer", "ExecutableCache"]


class _End:
    """Queue sentinel (private class, never a legal prepared item)."""


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Iterate `prepare(item)` for each item, preparing up to `depth`
    items ahead in a background thread.

    The consumer sees exactly the sequence `map(prepare, items)` in order:
    depth changes WHEN host work happens, never WHAT is produced.
    Exceptions raised by `prepare` propagate to the consumer at the point
    the failed item would have been yielded.

    `stats`: prepare_seconds (wall time inside `prepare`), wait_seconds
    (time the consumer blocked waiting for an item), items (yielded so
    far). `overlap_fraction()` is the share of prepare time hidden behind
    the consumer's own work (always 0.0 at depth 0).
    """

    def __init__(self, items: Iterable[Any], prepare: Callable[[Any], Any],
                 depth: int = 2, name: str = "prefetch"):
        self._items = items
        self._prepare = prepare
        self.depth = max(int(depth), 0)
        self.name = name
        self.stats = {"prepare_seconds": 0.0, "wait_seconds": 0.0, "items": 0}
        self._queue: "queue.Queue | None" = None
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()

    def overlap_fraction(self) -> float:
        prep = self.stats["prepare_seconds"]
        if prep <= 0.0:
            return 0.0
        hidden = max(prep - self.stats["wait_seconds"], 0.0)
        return min(hidden / prep, 1.0)

    def _iter_sync(self) -> Iterator[Any]:
        for item in self._items:
            t0 = time.perf_counter()
            out = self._prepare(item)
            dt = time.perf_counter() - t0
            # serial: every prepare second is also a consumer-wait second
            self.stats["prepare_seconds"] += dt
            self.stats["wait_seconds"] += dt
            self.stats["items"] += 1
            yield out

    def _worker(self) -> None:
        q = self._queue
        try:
            for item in self._items:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                try:
                    out = self._prepare(item)
                except BaseException as e:  # noqa: BLE001 — re-raised at consumer
                    q.put(_Raised(e))
                    return
                # stats is written only on the consumer thread; ship this
                # item's prepare time through the queue alongside it
                q.put((out, time.perf_counter() - t0))
        except BaseException as e:  # noqa: BLE001 — iterator itself raised
            q.put(_Raised(e))
            return
        q.put(_End)

    def __iter__(self) -> Iterator[Any]:
        if self.depth <= 0:
            yield from self._iter_sync()
            return
        self._queue = queue.Queue(maxsize=self.depth)
        self._thread = threading.Thread(
            target=self._worker, name=f"dataplane-{self.name}", daemon=True)
        self._thread.start()
        try:
            while True:
                t0 = time.perf_counter()
                got = self._queue.get()
                self.stats["wait_seconds"] += time.perf_counter() - t0
                if got is _End:
                    return
                if isinstance(got, _Raised):
                    raise got.exc
                out, prep_dt = got
                self.stats["prepare_seconds"] += prep_dt
                self.stats["items"] += 1
                yield out
        finally:
            self.close()

    def close(self) -> None:
        """Stop the background thread (idempotent; called on generator
        close so an abandoned iteration never leaks a producer)."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            # unblock a producer parked on a full queue
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)


class AsyncReadback:
    """Bounded-lag device->host readback.

    `push(outs)` parks the (still in-flight) device results of the current
    batch and returns the FETCHED results of batches that fell out of the
    lag window, so host readback of batch N-1 runs after batch N is
    enqueued. `drain()` fetches whatever is left.
    """

    def __init__(self, fetch: Callable[[Any], Any], lag: int = 1):
        self._fetch = fetch
        self.lag = max(int(lag), 0)
        self._pending: list[Any] = []

    @property
    def pending(self) -> int:
        """Batches dispatched but not yet fetched."""
        return len(self._pending)

    def push(self, outs: Any) -> list[Any]:
        self._pending.append(outs)
        ready = []
        while len(self._pending) > self.lag:
            ready.append(self._fetch(self._pending.pop(0)))
        return ready

    def drain(self) -> list[Any]:
        ready = [self._fetch(o) for o in self._pending]
        self._pending = []
        return ready


class ShapeBucketer:
    """Pad-to-bucket ladder: geometric (default powers of two) batch-size
    buckets up to `max_size`, each rounded up to `multiple_of`.

    Ragged row counts map onto a small closed set of shapes. `pad` returns
    the padded array plus the row mask marking real rows (padding repeats
    the last row, so padded rows are well-formed inputs that get sliced
    away). `shards` > 1 builds the ladder in per-shard rows and scales it
    back up, so every rung splits into `shards` equal slices."""

    def __init__(self, max_size: int, min_size: int = 1, growth: int = 2,
                 multiple_of: int = 1, shards: int = 1):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        if growth < 2:
            raise ValueError(f"growth must be >= 2, got {growth}")
        m = max(int(multiple_of), 1)
        s = max(int(shards), 1)
        self.multiple_of = m
        self.shards = s
        # per-shard rung rounding unit: smallest k with (shards*k) % m == 0,
        # so scaled-up totals stay divisible by BOTH shards and multiple_of
        per_m = m // math.gcd(m, s)
        per_max = -(-int(max_size) // s)
        per_max = ((per_max + per_m - 1) // per_m) * per_m
        self.max_size = per_max * s
        ladder: list[int] = []
        b = max(-(-int(min_size) // s), 1)
        while b < per_max:
            rounded = ((b + per_m - 1) // per_m) * per_m
            if not ladder or rounded > ladder[-1]:
                ladder.append(rounded)
            b *= growth
        if not ladder or ladder[-1] != per_max:
            ladder.append(per_max)
        self.ladder: tuple[int, ...] = tuple(r * s for r in ladder)
        # rung -> [rows_real, rows_padded]
        self._pad_rows: dict[int, list] = {}

    def note_pad(self, n_real: int, n_target: int) -> None:
        """Account one padded dispatch (`pad` calls this itself)."""
        ent = self._pad_rows.setdefault(int(n_target), [0, 0])
        ent[0] += int(n_real)
        ent[1] += max(int(n_target) - int(n_real), 0)

    def pad_waste(self) -> dict[int, dict]:
        """{rung: {rows_real, rows_padded, ratio}} since construction."""
        return {rung: {"rows_real": real, "rows_padded": padded,
                       "ratio": padded / max(real + padded, 1)}
                for rung, (real, padded) in sorted(self._pad_rows.items())}

    @property
    def per_shard_ladder(self) -> "tuple[int, ...]":
        """The ladder in per-shard rows (every rung divided by `shards`)."""
        return tuple(r // self.shards for r in self.ladder)

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket >= n (n must fit the ladder)."""
        if n < 0:
            raise ValueError(f"row count must be >= 0, got {n}")
        for b in self.ladder:
            if n <= b:
                return b
        raise ValueError(
            f"{n} rows exceed the bucket ladder's max {self.max_size} — "
            "chunk the input to max_size first")

    def pad(self, x: np.ndarray, n_target: "int | None" = None
            ) -> "tuple[np.ndarray, np.ndarray]":
        """(padded, row_mask): rows padded to `n_target` (default: the
        bucket for len(x)) by repeating the last row; mask is True for
        real rows."""
        n = len(x)
        target = self.bucket_for(n) if n_target is None else int(n_target)
        if target < n:
            raise ValueError(f"cannot pad {n} rows down to {target}")
        mask = np.zeros(target, dtype=bool)
        mask[:n] = True
        self.note_pad(n, target)
        if target == n:
            return x, mask
        if n == 0:
            raise ValueError("cannot pad an empty batch (no row to repeat)")
        pad = np.repeat(x[-1:], target - n, axis=0)
        return np.concatenate([x, pad], axis=0), mask


class ExecutableCache:
    """Per-(family, shape) cache of built callables.

    `family` is everything that selects a distinct program lineage
    (fetches, dtype flags, model identity); `shape` is the bucketed batch
    shape. Counters: hits, misses (the builder ran), recompiles (the
    subset of misses where the family was already cached at a DIFFERENT
    shape: ragged shapes defeating the bucket ladder), compile_seconds
    (wall time inside builders)."""

    def __init__(self) -> None:
        self._entries: dict[tuple, Any] = {}
        self._families: dict[Any, set] = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.recompiles = 0
        self.compile_seconds = 0.0

    def get_or_build(self, family: Any, shape: Any,
                     builder: Callable[[], Any]) -> Any:
        with self._lock:
            key = (family, shape)
            if key in self._entries:
                self.hits += 1
                return self._entries[key]
            seen = self._families.setdefault(family, set())
            if seen and shape not in seen:
                self.recompiles += 1
            self.misses += 1
            t0 = time.perf_counter()
            value = builder()
            self.compile_seconds += time.perf_counter() - t0
            self._entries[key] = value
            seen.add(shape)
            return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._families.clear()

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "recompiles": self.recompiles, "entries": len(self._entries),
                    "compile_seconds": self.compile_seconds}
