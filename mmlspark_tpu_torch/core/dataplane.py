"""Async data plane: host<->device pipelining primitives.

A copy of mmlspark_tpu/core/dataplane.py. In the port a "compile" is a
CUDA graph capture (core/fusion.py) and "XLA" below reads as the
builder that `ExecutableCache` times.

BENCH_r05's headroom note names the bottleneck: end-to-end model-runner
throughput is host->device transfer bound — the chip idles while Python
featurizes, pads, and `device_put`s the next batch one step at a time.
Input pipelining as a first-class reusable layer is the standard cure
(tf.data, Murray et al. 2021; Pathways' asynchronous dispatch, Barham et
al. 2022). This module is that layer, shared by the four batch loops that
each reimplemented the sequential pattern (nn/runner.py, nn/trainer.py,
streaming/query.py, io_http/serving.py):

* `Prefetcher` — a bounded-depth background thread overlaps host-side
  decode/featurize/pad + `device_put` of batch N+1 with device compute on
  batch N. Depth 0 is the synchronous fallback (identical results, zero
  threads) so pipelined-vs-sequential equivalence is a test, not a hope.
* `AsyncReadback` — non-blocking result fetch with a bounded lag, so host
  readback of batch N-1 overlaps compute on batch N instead of serializing
  at the end of the loop.
* `ShapeBucketer` — a pad-to-bucket ladder (powers of two up to the max
  batch size) with row masks, so ragged tails and small serving batches
  stop forcing a fresh XLA compile per row count: every observed shape
  maps into a small closed set.
* `ExecutableCache` — jitted executables keyed by (family, bucket shape)
  with hit/miss/recompile counters, aggregated process-wide so a serving
  info endpoint can report steady-state recompile health.
* `Lookahead` — a single-slot keyed read-ahead for the streaming driver:
  the next micro-batch's SOURCE READ overlaps the current batch's
  transform+sink, while planning and commit stay strictly ordered (the
  exactly-once contract is untouched).

Framework-free: callers pass the `prepare`/build callables that touch
the device, so the module imports anywhere (and in orchestrator
processes that must never initialize CUDA).
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np

__all__ = ["Prefetcher", "AsyncReadback", "ShapeBucketer", "ExecutableCache",
           "Lookahead", "cache_stats", "reset_cache_stats"]


# --------------------------------------------------------------------- #
# Prefetcher                                                            #
# --------------------------------------------------------------------- #

class _End:
    """Queue sentinel (private class, never a legal prepared item)."""


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Iterate `prepare(item)` for each item, preparing up to `depth`
    items ahead in a background thread.

    The consumer sees exactly the sequence `map(prepare, items)` in order
    — depth changes WHEN host work happens, never WHAT is produced, which
    is what makes pipelined-vs-sequential byte-equivalence testable.
    Exceptions raised by `prepare` propagate to the consumer at the point
    the failed item would have been yielded.

    `stats` after (or during) iteration:
      prepare_seconds — total wall time spent inside `prepare`
      wait_seconds    — total time the consumer blocked waiting for an item
      items           — items yielded so far

    `overlap_fraction()` estimates how much of the host-side prepare cost
    was hidden behind the consumer's own work: 1.0 means the consumer
    never waited, 0.0 means fully serial (always 0.0 at depth 0).
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

    def _gauges(self):
        """(queue_depth, overlap) gauge children for this prefetcher, or
        (None, None) when telemetry is unavailable. Resolved lazily at
        iteration start — never at import — to keep this module free of
        package-load ordering."""
        try:
            from ..observability.metrics import get_registry

            reg = get_registry()
            depth = reg.gauge(
                "mmlspark_tpu_dataplane_prefetch_queue_depth",
                "prepared items parked in the prefetch queue",
                labels=("name",)).labels(name=self.name)
            overlap = reg.gauge(
                "mmlspark_tpu_dataplane_overlap_ratio",
                "fraction of prepare cost hidden behind consumer work",
                labels=("name",)).labels(name=self.name)
            return depth, overlap
        except Exception:
            return None, None

    # -- synchronous path (depth 0) ------------------------------------- #

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

    # -- pipelined path -------------------------------------------------- #

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
        g_depth, g_overlap = self._gauges()
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
                if g_depth is not None:
                    g_depth.set(self._queue.qsize())
                yield out
        finally:
            if g_overlap is not None:
                g_overlap.set(self.overlap_fraction())
                g_depth.set(0)
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

    `push(outs)` parks the (still in-flight, thanks to async dispatch)
    device results of the current batch and returns the FETCHED results of
    batches that fell out of the lag window — so host readback of batch
    N-1 runs while the device computes batch N, instead of all readbacks
    serializing after the loop. `drain()` fetches whatever is left.
    """

    def __init__(self, fetch: Callable[[Any], Any], lag: int = 1):
        self._fetch = fetch
        self.lag = max(int(lag), 0)
        self._pending: list[Any] = []

    @property
    def pending(self) -> int:
        """Batches dispatched but not yet fetched — the serving hot path
        publishes this as its readback-lag gauge."""
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


# --------------------------------------------------------------------- #
# ShapeBucketer                                                         #
# --------------------------------------------------------------------- #

class ShapeBucketer:
    """Pad-to-bucket ladder: geometric (default powers of two) batch-size
    buckets up to `max_size`, each rounded up to `multiple_of` (the mesh
    data-axis divisibility constraint).

    Ragged row counts map onto a small closed set of shapes, so a jitted
    per-shape executable compiles once per BUCKET instead of once per
    observed row count — the serving p99-recompile-spike fix. `pad`
    returns the padded array plus the row mask marking real rows (padding
    repeats the last row, the same convention the runner always used, so
    padded rows are well-formed inputs that get sliced away).

    `shards` > 1 makes the ladder SKEW-AWARE: the geometric progression is
    built in PER-SHARD rows and scaled back up, so every rung splits into
    `shards` equal slices — each shard carries exactly rung/shards rows
    (⌈rows/shards⌉ padded to the same per-shard rung on every shard) and
    the compiled per-shard shape set is the same closed ladder on every
    device. A merely mesh-DIVISIBLE total can leave the geometric
    progression stated in totals; per-shard construction states it in the
    unit that actually compiles and balances. `multiple_of` still rounds
    each rung so totals honor both constraints."""

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
        # padded-vs-real row accounting per rung: at multiple_of=8 mesh
        # padding a small batch can be MOSTLY padding, and before this
        # nothing reported it — rung -> [rows_real, rows_padded]
        self._pad_rows: dict[int, list] = {}
        self._waste_gauge: Any = None

    def note_pad(self, n_real: int, n_target: int) -> None:
        """Account one padded dispatch (`pad` calls this itself; callers
        that pad by hand — fusion's column stack, the serving batcher —
        call it explicitly). Publishes the per-rung pad_waste_ratio
        gauge, fail-soft like every dataplane telemetry hook."""
        ent = self._pad_rows.setdefault(int(n_target), [0, 0])
        ent[0] += int(n_real)
        ent[1] += max(int(n_target) - int(n_real), 0)
        if self._waste_gauge is None:
            try:
                from ..observability.metrics import get_registry

                self._waste_gauge = get_registry().gauge(
                    "mmlspark_tpu_dataplane_pad_waste_ratio",
                    "fraction of dispatched rows that were bucket padding",
                    labels=("rung",))
            except Exception:
                self._waste_gauge = False
        if self._waste_gauge:
            total = ent[0] + ent[1]
            if total:
                self._waste_gauge.labels(rung=str(int(n_target))).set(
                    ent[1] / total)

    def pad_waste(self) -> dict[int, dict]:
        """{rung: {rows_real, rows_padded, ratio}} since construction."""
        return {rung: {"rows_real": real, "rows_padded": padded,
                       "ratio": padded / max(real + padded, 1)}
                for rung, (real, padded) in sorted(self._pad_rows.items())}

    @property
    def per_shard_ladder(self) -> "tuple[int, ...]":
        """The ladder in per-shard rows — every rung divided by `shards`
        (exact by construction; the skew-aware balance invariant)."""
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


# --------------------------------------------------------------------- #
# ExecutableCache                                                       #
# --------------------------------------------------------------------- #

# process-wide aggregate across every live ExecutableCache — what a
# serving info endpoint reports without having to find each model's
# private cache instance
_GLOBAL_STATS_LOCK = threading.Lock()
_GLOBAL_STATS = {"hits": 0, "misses": 0, "recompiles": 0,
                 "compile_seconds": 0.0}


def cache_stats() -> dict[str, float]:
    """Process-wide executable-cache counters (sum over all caches)."""
    with _GLOBAL_STATS_LOCK:
        return dict(_GLOBAL_STATS)


def reset_cache_stats() -> None:
    """Zero the process-wide counters (tests / soak baselines)."""
    with _GLOBAL_STATS_LOCK:
        for k in _GLOBAL_STATS:
            _GLOBAL_STATS[k] = 0


def ensure_cache_metrics(registry=None) -> None:
    """Expose the process-wide executable-cache counters as pull-style
    telemetry series (scraped from `/metrics`). Idempotent; the import is
    deferred so this module stays importable before the package finishes
    loading (observability itself imports core.pipeline)."""
    from ..observability.metrics import get_registry

    reg = registry if registry is not None else get_registry()
    for key in ("hits", "misses", "recompiles"):
        name = f"mmlspark_tpu_executable_cache_{key}_total"
        if not reg.has(name):
            reg.register_callback(
                name, f"executable-cache {key} across all caches",
                (lambda k=key: cache_stats()[k]), kind="counter")
    if not reg.has("mmlspark_tpu_compile_seconds_total"):
        reg.register_callback(
            "mmlspark_tpu_compile_seconds_total",
            "wall-clock seconds spent inside executable builders (XLA "
            "compiles) across all caches",
            (lambda: cache_stats()["compile_seconds"]), kind="counter")


class ExecutableCache:
    """Compiled-executable cache keyed by (family, shape).

    `family` is everything that selects a distinct program lineage —
    fetches, dtype flags, shardings, model identity; `shape` is the
    bucketed batch shape. Counters:

      hits       — the executable existed
      misses     — the builder ran (an XLA compile happened)
      recompiles — the subset of misses where the family was already
                   cached at a DIFFERENT shape: the signal that ragged
                   shapes are defeating the bucket ladder. Steady-state
                   recompiles == 0 is the serving soak acceptance bar.
    """

    def __init__(self) -> None:
        # lazy import: this module stays free of package-load ordering
        # (see _gauges), and the factory returns a plain RLock unless the
        # lock-order sanitizer is enabled
        from ..observability.sanitizer import make_rlock

        self._entries: dict[tuple, Any] = {}
        self._families: dict[Any, set] = {}
        self._lock = make_rlock("ExecutableCache._lock")
        self.hits = 0
        self.misses = 0
        self.recompiles = 0
        # wall-clock seconds inside `builder()` per (family, shape) —
        # the compile-time ledger that makes warmup cost and recompile
        # spikes a number instead of an inference from `recompiles`
        self.compile_seconds = 0.0
        self._compile_log: dict[tuple, float] = {}

    @staticmethod
    def family_key(base: Any, mesh_shape: Any = None,
                   sharding_spec: Any = None) -> Any:
        """Extend a family key with the mesh dimension.

        `mesh_shape` is the ((axis, size), ...) layout of the mesh the
        executable was compiled under and `sharding_spec` describes how the
        family's inputs/params are placed on it.  With `mesh_shape=None`
        (single chip) the base key is returned UNCHANGED — the pre-mesh key
        — so a sharded executable can never be handed to the single-chip
        path or vice versa: the two lineages live under different family
        keys and a mesh-shape change is a new family, not a recompile of
        the old one."""
        if mesh_shape is None:
            return base
        return (base, ("mesh", tuple(mesh_shape), tuple(sharding_spec or ())))

    def _bump(self, **deltas: int) -> None:
        with _GLOBAL_STATS_LOCK:
            for k, v in deltas.items():
                _GLOBAL_STATS[k] += v

    def get_or_build(self, family: Any, shape: Any,
                     builder: Callable[[], Any]) -> Any:
        with self._lock:
            key = (family, shape)
            if key in self._entries:
                self.hits += 1
                self._bump(hits=1)
                return self._entries[key]
            seen = self._families.setdefault(family, set())
            recompile = bool(seen) and shape not in seen
            self.misses += 1
            deltas = {"misses": 1}
            if recompile:
                self.recompiles += 1
                deltas["recompiles"] = 1
            self._bump(**deltas)
            t0 = time.perf_counter()
            value = builder()
            dt = time.perf_counter() - t0
            self.compile_seconds += dt
            self._compile_log[key] = self._compile_log.get(key, 0.0) + dt
            self._bump(compile_seconds=dt)
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

    def compile_ledger(self, top: int = 0) -> list[dict]:
        """Per-(family, bucket) compile seconds, most expensive first —
        the serving `info()` block that answers "what did warmup cost,
        and which bucket keeps recompiling". Family keys are repr'd and
        truncated: they identify, they don't round-trip."""
        with self._lock:
            items = sorted(self._compile_log.items(), key=lambda kv: kv[1],
                           reverse=True)
        if top:
            items = items[:int(top)]
        return [{"family": repr(family)[:120], "shape": repr(shape),
                 "seconds": dt} for (family, shape), dt in items]


# --------------------------------------------------------------------- #
# Lookahead                                                             #
# --------------------------------------------------------------------- #

class Lookahead:
    """Single-slot keyed read-ahead.

    `submit(key, fn)` runs `fn()` on a background thread; `take(key)`
    waits for it and returns the result IF the key matches the pending
    submission, else discards it and reports a miss. A read that raised
    is also a miss (the caller re-reads synchronously, surfacing a
    persistent error through the normal path).

    Built for the streaming driver: the next batch's source read overlaps
    the current batch's transform+sink, while the caller keeps planning
    and committing strictly in order — a mismatched or failed lookahead
    costs one synchronous read, never correctness.
    """

    def __init__(self, name: str = "lookahead"):
        self.name = name
        self._key: Any = None
        self._done = threading.Event()
        # the background thread publishes into a per-submission box dict
        # ("result"/"error" keys); the submitting thread reads it only
        # after join(), so the box never needs a lock
        self._box: dict = {}
        self._thread: "threading.Thread | None" = None
        self.hits = 0
        self.misses = 0

    @property
    def pending(self) -> bool:
        return self._thread is not None

    def submit(self, key: Any, fn: Callable[[], Any]) -> None:
        """Start a background read for `key`; any previous unclaimed
        submission is discarded first."""
        self.discard()
        self._key = key
        done = threading.Event()
        box: dict = {}

        def run() -> None:
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — reported as a miss
                box["error"] = e
            finally:
                done.set()

        self._done = done
        self._box = box
        self._thread = threading.Thread(
            target=run, name=f"dataplane-{self.name}", daemon=True)
        self._thread.start()

    def take(self, key: Any) -> "tuple[bool, Any]":
        """(hit, result): hit=True only when `key` matches the pending
        submission and its read succeeded."""
        if self._thread is None:
            return False, None
        self._done.wait()
        self._thread.join()
        self._thread = None
        box = self._box
        matched = (self._key == key and "error" not in box
                   and "result" in box)
        result = box.get("result") if matched else None
        self._key, self._box = None, {}
        if matched:
            self.hits += 1
        else:
            self.misses += 1
        return matched, result

    def discard(self) -> None:
        """Drop any pending submission (waits for its thread so no read
        ever races a caller's next synchronous source call)."""
        if self._thread is not None:
            self._done.wait()
            self._thread.join()
            self._thread = None
        self._key, self._box = None, {}
