"""Phase ledger: per-dispatch performance attribution ("where did the µs go").

A copy of mmlspark_tpu/observability/profiler.py for the port. Every
fused-segment run and every serving hot-path request decomposes into a
fixed vocabulary of attributed phases, and the per-segment / per-shard
totals aggregate into an attribution table (`render_attribution`).
Metrics say *that* a path is slow; spans say *when*; this module says
*where*.

Phase vocabulary (closed, so fleet merges and the attribution table
always see the same columns):

    prepare     host-side input assembly (decode, column stacking)
    pad         bucket padding work (the ROWS padded are counted too)
    h2d         host-to-device transfer (DeviceTable.from_host)
    dispatch    handing the work to the card (a CUDA-graph replay,
                enqueued asynchronously)
    compute     device compute: the wait on the dispatch's own CUDA
                event (core/fusion.py `_block_ready`), never a
                device-wide synchronize, so another thread's graph
                capture is left alone
    collective  cross-shard collective stalls (mesh paths)
    d2h         device-to-host readback (copy + dtype cast)
    queue       any wait in a queue: batcher input wait AND the lag-N
                async-readback hold between dispatch and drain

Design constraints mirror metrics/tracing/recorder:

* stdlib only: never imports back into the rest of the port, so the hot
  modules (fusion, dataplane, serving) can hold a profiler without
  cycles; the commit drainer thread never touches CUDA.
* The DISARMED path is one attribute check: `profiler.ledger(...)`
  returns a shared null ledger whose every method is a no-op — the
  instrumentation stays in production code.
* Injectable clock (duck-typed `monotonic()`, resilience FakeClock
  fits): ledger unit tests advance time explicitly, no real sleeps.
* Every sink is optional and fail-soft: histograms into a
  MetricsRegistry, phase child-spans under a parent Tracer span
  (Perfetto exports gain `phase.*` children), `profiler.ledger` events
  into the FlightRecorder ring, and — because the histograms are plain
  labeled series — fleet-wide aggregation through MetricsAggregator
  needs no extra wiring (`attribution_from_snapshot` reads either a
  registry snapshot or the aggregator's fleet-merged one).

Shard attribution extends the scalar `shard_skew_ratio` gauge into a
table: per (segment, shard) compute seconds and row counts, naming the
slowest shard.

Cost analysis never runs the dispatched work: see `cost_analysis_of`.
"""

from __future__ import annotations

import threading
from .sanitizer import make_lock
from collections import deque
from typing import Any

__all__ = [
    "PHASES", "PHASE_LABEL", "PROFILER_SERIES",
    "PHASE_SECONDS", "SHARD_SECONDS",
    "ROWS_REAL_TOTAL", "ROWS_PADDED_TOTAL", "LEDGERS_TOTAL",
    "PhaseLedger", "Profiler", "get_profiler", "set_default_profiler",
    "cost_analysis_of", "attribution_from_snapshot", "render_attribution",
]

# the closed phase vocabulary (the attribution table's columns)
PHASES: tuple[str, ...] = (
    "prepare", "pad", "h2d", "dispatch", "compute", "collective",
    "d2h", "queue",
)
PHASE_LABEL = "phase"

PHASE_SECONDS = "mmlspark_tpu_profiler_phase_seconds"
SHARD_SECONDS = "mmlspark_tpu_profiler_shard_phase_seconds"
ROWS_REAL_TOTAL = "mmlspark_tpu_profiler_rows_real_total"
ROWS_PADDED_TOTAL = "mmlspark_tpu_profiler_rows_padded_total"
LEDGERS_TOTAL = "mmlspark_tpu_profiler_ledgers_total"

# the profiler's full series manifest: name -> (kind, label names), the
# JAX package's own (every *_seconds histogram here carries the phase
# label, whose values come from PHASES), so fleet merges of either
# package's replicas see the same series.
PROFILER_SERIES: dict[str, tuple[str, tuple[str, ...]]] = {
    PHASE_SECONDS: ("histogram", ("kind", "segment", PHASE_LABEL)),
    SHARD_SECONDS: ("histogram", ("segment", "shard", PHASE_LABEL)),
    ROWS_REAL_TOTAL: ("counter", ("kind", "segment")),
    ROWS_PADDED_TOTAL: ("counter", ("kind", "segment")),
    LEDGERS_TOTAL: ("counter", ("kind", "segment")),
}


class _MonotonicClock:
    # bound directly: phase brackets read the clock twice per bracket,
    # a method wrapper there adds to every armed request
    import time as _time
    monotonic = staticmethod(_time.monotonic)


# --------------------------------------------------------------------- #
# ledgers                                                               #
# --------------------------------------------------------------------- #


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_PHASE = _NullPhase()


class _NullLedger:
    """The disarmed ledger: every method a no-op, shared instance."""

    __slots__ = ()
    armed = False

    def phase(self, name: str):
        return _NULL_PHASE

    def add(self, name: str, seconds: float) -> None:
        pass

    def note_pad(self, rows_real: int, rows_target: int) -> None:
        pass

    def note_shard(self, shard: str, seconds: float,
                   rows: "int | None" = None) -> None:
        pass

    def note_cost(self, flops: float, bytes_: float) -> None:
        pass

    def cost(self, key: Any, fn: Any, *args: Any, **kwargs: Any) -> None:
        return None

    def set(self, **meta: Any) -> None:
        pass

    def phase_sum(self) -> float:
        return 0.0

    def done(self, rtt_s: "float | None" = None) -> None:
        pass


NULL_LEDGER = _NullLedger()


class _PhaseCtx:
    """Times one phase on the profiler clock and (when the ledger rides
    under a traced parent span) brackets a `phase.<name>` child span so
    the Perfetto export shows the decomposition in-line."""

    __slots__ = ("_ledger", "_name", "_t0", "_span_ctx")

    def __init__(self, ledger: "PhaseLedger", name: str):
        self._ledger = ledger
        self._name = name
        self._t0 = 0.0
        self._span_ctx = None

    def __enter__(self):
        led = self._ledger
        if led._spans and getattr(led.span, "span_id", 0) \
                and led._tracer is not None and led._tracer.enabled:
            self._span_ctx = led._tracer.start_span(
                f"phase.{self._name}", parent=led.span)
            self._span_ctx.__enter__()
        self._t0 = led._clock.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        led = self._ledger
        led.add(self._name, led._clock.monotonic() - self._t0)
        if self._span_ctx is not None:
            self._span_ctx.__exit__(*exc)
        return False


class PhaseLedger:
    """One dispatch / one request worth of attributed phases.

    Accumulative: `phase(name)` brackets time on the profiler clock (and
    opens a `phase.<name>` tracer child span under `span`), `add` folds
    in externally-measured seconds, and the same phase may be hit
    multiple times (both queue waits land in "queue"). `done()` commits
    the record to every sink exactly once — and hands the instance back
    to the profiler's pool, so a ledger MUST NOT be touched after done();
    read committed data through `records()` / `attribution()`.
    """

    __slots__ = ("kind", "segment", "span", "phases", "rows_real",
                 "rows_padded", "shards", "flops", "bytes", "meta",
                 "rtt_s", "_prof", "_clock", "_tracer", "_done",
                 "_overhead_s", "_spans", "_ctx")
    armed = True

    def __init__(self, prof: "Profiler", kind: str, segment: str,
                 span: Any = None, **meta: Any):
        self._ctx: "_PhaseCtx | None" = None
        self.phases: dict[str, float] = {}
        # shard -> [seconds, rows]
        self.shards: dict[str, list] = {}
        self._reset(prof, kind, segment, span, meta)

    def _reset(self, prof: "Profiler", kind: str, segment: str,
               span: Any, meta: dict) -> None:
        """(Re)initialise for one dispatch — ledgers are pooled, and a
        per-request allocation storm is the dominant armed cost, so the
        hot path only ever touches recycled objects (`phases`/`shards`
        are replaced with fresh dicts by the committer, off-thread)."""
        self._prof = prof
        self._clock = prof._clock
        self._spans = prof.spans
        tracer = prof.tracer
        if tracer is None and span is not None and self._spans:
            try:
                from .tracing import get_tracer

                tracer = get_tracer()
            except Exception:  # noqa: BLE001 — tracing is best-effort
                tracer = None
        self._tracer = tracer
        self.kind = str(kind)
        self.segment = str(segment)
        self.span = span
        self.rows_real = 0
        self.rows_padded = 0
        self.flops = 0.0
        self.bytes = 0.0
        # the ** call-site dict is freshly built per call — own it as-is
        self.meta = meta
        self.rtt_s: "float | None" = None
        self._done = False
        # wall time the ledger itself spent on cost analysis (once per
        # executable key) — observer overhead,
        # subtracted from the committed RTT so coverage stays honest
        self._overhead_s = 0.0

    def phase(self, name: str) -> _PhaseCtx:
        """Context manager timing one phase occurrence. The returned ctx
        is reused per ledger (brackets never nest within one ledger), so
        the bracket itself allocates nothing."""
        if name not in PHASES:
            raise ValueError(f"unknown phase {name!r}; vocabulary: {PHASES}")
        ctx = self._ctx
        if ctx is None:
            ctx = self._ctx = _PhaseCtx(self, name)
        else:
            ctx._name = name
        return ctx

    def add(self, name: str, seconds: float) -> None:
        """Fold externally-measured seconds into a phase."""
        if name not in PHASES:
            raise ValueError(f"unknown phase {name!r}; vocabulary: {PHASES}")
        if seconds < 0:
            seconds = 0.0
        self.phases[name] = self.phases.get(name, 0.0) + float(seconds)

    def note_pad(self, rows_real: int, rows_target: int) -> None:
        """Padded-vs-real row accounting: `rows_target - rows_real` rows
        of every dispatch are pure bucket-padding waste."""
        self.rows_real += int(rows_real)
        self.rows_padded += max(int(rows_target) - int(rows_real), 0)

    def note_shard(self, shard: str, seconds: float,
                   rows: "int | None" = None) -> None:
        """Per-shard compute/readback seconds (mesh paths) — feeds the
        slowest-shard attribution table."""
        ent = self.shards.setdefault(str(shard), [0.0, 0])
        ent[0] += float(seconds)
        if rows is not None:
            ent[1] += int(rows)

    def note_cost(self, flops: float, bytes_: float) -> None:
        """Static cost-analysis estimate for the dispatched executable
        (FLOPs + bytes accessed) — achieved-vs-roofline in the table."""
        self.flops += float(flops or 0.0)
        self.bytes += float(bytes_ or 0.0)

    def cost(self, key: Any, fn: Any, *args: Any,
             **kwargs: Any) -> "dict | None":
        """Note the (cached) cost-analysis estimate for the executable
        about to be dispatched at these args."""
        t0 = self._clock.monotonic()
        c = self._prof.cost_for(key, fn, *args, **kwargs)
        self._overhead_s += max(self._clock.monotonic() - t0, 0.0)
        if c:
            self.note_cost(c["flops"], c["bytes"])
        return c

    def set(self, **meta: Any) -> None:
        self.meta.update(meta)

    def phase_sum(self) -> float:
        return sum(self.phases.values())

    def done(self, rtt_s: "float | None" = None) -> None:
        """Seal the ledger and hand it to the commit drain. The request
        thread pays one deque append; histograms, recorder event, and
        the in-process table are written by the profiler's background
        drainer (every read path flushes first, so reads stay exact)."""
        if self._done:
            return
        self._done = True
        if rtt_s is not None:
            self.rtt_s = max(float(rtt_s) - self._overhead_s, 0.0)
        self._prof._enqueue(self)


# --------------------------------------------------------------------- #
# the profiler                                                          #
# --------------------------------------------------------------------- #


class Profiler:
    """Armable phase-ledger collector.

    registry / tracer / recorder   sinks; None resolves the process
                                   defaults lazily at commit time (and
                                   tolerates their absence)
    clock                          duck-typed `monotonic()` (FakeClock
                                   fits) — drives phase brackets
    enabled                        the armed bit; disarmed `ledger()` is
                                   one attribute check returning the
                                   shared NULL_LEDGER
    max_records                    bound on retained raw ledger records
                                   (the aggregate table is unbounded in
                                   time but bounded in keys)
    """

    def __init__(self, registry: Any = None, tracer: Any = None,
                 recorder: Any = None, clock: Any = None,
                 enabled: bool = False, spans: bool = False,
                 max_records: int = 1024):
        self.enabled = bool(enabled)
        # phase child-spans cost a span alloc + ring write EACH,
        # far more than the whole ledger — opt-in via
        # arm(spans=True) for Perfetto deep dives, off on the default
        # armed path so the armed p50 stays near the disarmed one
        self.spans = bool(spans)
        self.registry = registry
        self.tracer = tracer
        self.recorder = recorder
        self._clock = clock if clock is not None else _MonotonicClock()
        self._lock = make_lock("Profiler._lock")
        self._records: deque[dict] = deque(maxlen=int(max_records))
        # (kind, segment) -> aggregate dict
        self._agg: dict[tuple[str, str], dict] = {}
        self._cost_cache: dict[Any, "dict | None"] = {}
        self._ledgers = 0
        # labeled-child cache for _publish: family lookup + .labels()
        # per commit would dominate the armed cost of a request;
        # children are stable, so resolve once
        self._pub_cache: dict = {}
        # sealed ledgers waiting for the background committer — the
        # request thread pays one append; bounded so a pathological
        # armed load degrades attribution fidelity, never memory
        self._pending: deque = deque(maxlen=4096)
        self._wake = threading.Event()
        self._drain_idle = True
        self._drainer: "threading.Thread | None" = None
        # committed ledgers come back here (refilled with fresh dicts by
        # the committer) so the armed request path allocates nothing
        self._pool: deque = deque(maxlen=512)

    # -- arming ---------------------------------------------------------- #

    def arm(self, registry: Any = None, tracer: Any = None,
            recorder: Any = None,
            spans: "bool | None" = None) -> "Profiler":
        """Turn the profiler on, optionally (re)binding sinks. Pass
        ``spans=True`` to also open `phase.*` tracer child-spans."""
        if registry is not None:
            self.registry = registry
        if tracer is not None:
            self.tracer = tracer
        if recorder is not None:
            self.recorder = recorder
        if spans is not None:
            self.spans = bool(spans)
        self.enabled = True
        self._ensure_drainer()
        return self

    def disarm(self) -> "Profiler":
        self.enabled = False
        self.flush()
        return self

    # -- ledger creation (the hot path) ---------------------------------- #

    def ledger(self, kind: str, segment: str = "-", span: Any = None,
               **meta: Any):
        """A PhaseLedger when armed; the shared no-op ledger when not."""
        if not self.enabled:
            return NULL_LEDGER
        try:
            led = self._pool.popleft()
        except IndexError:
            return PhaseLedger(self, kind, segment, span=span, **meta)
        led._reset(self, kind, segment, span, meta)
        return led

    # -- cost analysis ---------------------------------------------------- #

    def cost_for(self, key: Any, fn: Any = None, *args: Any,
                 **kwargs: Any) -> "dict | None":
        """Cached `cost_analysis_of` per executable key: it runs armed
        only, once per (family, shape), and never calls `fn`."""
        if not self.enabled:
            return None
        with self._lock:
            if key in self._cost_cache:
                return self._cost_cache[key]
        cost = cost_analysis_of(fn, *args, **kwargs) if fn is not None \
            else None
        with self._lock:
            self._cost_cache[key] = cost
        return cost

    # -- commit ----------------------------------------------------------- #

    def _enqueue(self, led: PhaseLedger) -> None:
        """Hot-path half of a commit: one deque append. The committer is
        NOT woken per ledger — an eager wake costs a thread switch in the
        middle of the request that enqueued it; the 4Hz drain timer picks the backlog up in bulk, and the
        event is only set if the queue nears its drop bound."""
        pending = self._pending
        pending.append(led)
        if len(pending) >= 1024 and self._drain_idle:
            self._wake.set()
        if self._drainer is None:
            self._ensure_drainer()

    def _ensure_drainer(self) -> None:
        with self._lock:
            t = self._drainer
            if t is not None and t.is_alive():
                return
            t = threading.Thread(target=self._drain_loop,
                                 name="profiler-commit", daemon=True)
            self._drainer = t
        t.start()

    def _drain_loop(self) -> None:
        # the timeout is a safety net for the benign idle-flag race (an
        # append landing just as a pass ends); reads flush synchronously,
        # so a late background commit never skews what anyone observes
        while True:
            self._wake.wait(timeout=0.25)
            self._wake.clear()
            with self._lock:
                self._drain_idle = False
            self.flush()
            with self._lock:
                self._drain_idle = True

    def flush(self) -> None:
        """Drain pending ledgers synchronously. Safe from any thread —
        the deque hands each ledger to exactly one committer."""
        pending = self._pending
        while True:
            try:
                led = pending.popleft()
            except IndexError:
                return
            self._commit(led)

    def _commit(self, led: PhaseLedger) -> None:
        with self._lock:
            self._ledgers += 1
            agg = self._agg.get((led.kind, led.segment))
            if agg is None:
                agg = self._agg[(led.kind, led.segment)] = {
                    "count": 0, "phases": {}, "rows_real": 0,
                    "rows_padded": 0, "rtt_s": 0.0, "rtt_n": 0,
                    "flops": 0.0, "bytes": 0.0, "shards": {},
                }
            agg["count"] += 1
            for p, s in led.phases.items():
                agg["phases"][p] = agg["phases"].get(p, 0.0) + s
            agg["rows_real"] += led.rows_real
            agg["rows_padded"] += led.rows_padded
            if led.rtt_s is not None:
                agg["rtt_s"] += led.rtt_s
                agg["rtt_n"] += 1
            agg["flops"] += led.flops
            agg["bytes"] += led.bytes
            for sh, (sec, rows) in led.shards.items():
                ent = agg["shards"].setdefault(sh, [0.0, 0, 0])
                ent[0] += sec
                ent[1] += rows
                ent[2] += 1
            # the ledger is sealed at done(); its dicts are safe to
            # reference without copying
            self._records.append({
                "kind": led.kind, "segment": led.segment,
                "phases": led.phases, "rows_real": led.rows_real,
                "rows_padded": led.rows_padded, "rtt_s": led.rtt_s,
                "meta": led.meta,
            })
        self._publish(led)
        rec = self.recorder
        if rec is None:
            try:
                from .recorder import get_recorder

                rec = get_recorder()
            except Exception:  # noqa: BLE001 — recorder is best-effort
                rec = None
        if rec is not None:
            try:
                rec.record_ledger(
                    ledger=led.kind, segment=led.segment,
                    phases=led.phases,
                    rows_real=led.rows_real, rows_padded=led.rows_padded,
                    rtt_s=led.rtt_s,
                    shards={sh: [v[0], v[1]]
                            for sh, v in led.shards.items()} or None)
            except Exception:  # noqa: BLE001 — never fail the hot path
                pass
        # recycle: the record/recorder keep the old dicts, so the ledger
        # gets fresh ones here — on the committer thread, not the hot path
        led.phases = {}
        led.shards = {}
        led.meta = {}
        led.span = None
        self._pool.append(led)

    def _publish(self, led: PhaseLedger) -> None:
        """Labeled histograms into the registry (fail-soft)."""
        reg = self.registry
        if reg is None:
            try:
                from .metrics import get_registry

                reg = get_registry()
            except Exception:  # noqa: BLE001 — metrics are best-effort
                return
        try:
            pub = self._pub_cache
            if pub.get("reg") is not reg:
                from .metrics import PHASE_BUCKETS

                pub = self._pub_cache = {
                    "reg": reg,
                    "hist": reg.histogram(
                        PHASE_SECONDS,
                        "attributed seconds per phase of one "
                        "dispatch/request",
                        PROFILER_SERIES[PHASE_SECONDS][1],
                        buckets=PHASE_BUCKETS),
                    "shard_hist": reg.histogram(
                        SHARD_SECONDS,
                        "per-shard attributed compute seconds",
                        PROFILER_SERIES[SHARD_SECONDS][1],
                        buckets=PHASE_BUCKETS),
                    "ledgers": reg.counter(
                        LEDGERS_TOTAL, "committed phase ledgers",
                        PROFILER_SERIES[LEDGERS_TOTAL][1]),
                    "real": reg.counter(
                        ROWS_REAL_TOTAL, "real rows dispatched",
                        PROFILER_SERIES[ROWS_REAL_TOTAL][1]),
                    "padded": reg.counter(
                        ROWS_PADDED_TOTAL,
                        "bucket-padding rows dispatched",
                        PROFILER_SERIES[ROWS_PADDED_TOTAL][1]),
                    "children": {},
                }
            key = (led.kind, led.segment)
            ch = pub["children"].get(key)
            if ch is None:
                ch = pub["children"][key] = {
                    "phase": {},
                    "ledgers": pub["ledgers"].labels(
                        kind=led.kind, segment=led.segment),
                    "real": pub["real"].labels(
                        kind=led.kind, segment=led.segment),
                    "padded": pub["padded"].labels(
                        kind=led.kind, segment=led.segment),
                    "shards": {},
                }
            phase_children = ch["phase"]
            for p, s in led.phases.items():
                c = phase_children.get(p)
                if c is None:
                    c = phase_children[p] = pub["hist"].labels(
                        kind=led.kind, segment=led.segment, phase=p)
                c.observe(s)
            ch["ledgers"].inc()
            if led.rows_real or led.rows_padded:
                ch["real"].inc(led.rows_real)
                ch["padded"].inc(led.rows_padded)
            if led.shards:
                shard_children = ch["shards"]
                for sh, (sec, _rows) in led.shards.items():
                    c = shard_children.get(sh)
                    if c is None:
                        c = shard_children[sh] = pub["shard_hist"].labels(
                            segment=led.segment, shard=sh, phase="compute")
                    c.observe(sec)
        except Exception:  # noqa: BLE001 — never fail the hot path
            pass

    # -- reads ------------------------------------------------------------ #

    def records(self) -> list[dict]:
        self.flush()
        with self._lock:
            return list(self._records)

    def reset(self) -> None:
        self._pending.clear()
        with self._lock:
            self._records.clear()
            self._agg.clear()
            self._ledgers = 0

    def attribution(self) -> list[dict]:
        """JSON-safe attribution rows, one per (kind, segment): mean
        phase µs, phase-sum vs mean RTT coverage, pad waste, achieved
        GFLOP/s, and the per-shard table naming the slowest shard."""
        self.flush()
        with self._lock:
            items = [(k, {**v, "phases": dict(v["phases"]),
                          "shards": {s: list(e)
                                     for s, e in v["shards"].items()}})
                     for k, v in sorted(self._agg.items())]
        rows = []
        for (kind, segment), agg in items:
            n = max(agg["count"], 1)
            phase_us = {p: agg["phases"].get(p, 0.0) / n * 1e6
                        for p in PHASES if p in agg["phases"]}
            phase_sum_us = sum(phase_us.values())
            rtt_us = (agg["rtt_s"] / agg["rtt_n"] * 1e6
                      if agg["rtt_n"] else None)
            total_rows = agg["rows_real"] + agg["rows_padded"]
            compute_s = agg["phases"].get("compute", 0.0)
            shards = []
            for sh, (sec, rows_, cnt) in sorted(
                    agg["shards"].items(),
                    key=lambda kv: kv[1][0], reverse=True):
                shards.append({
                    "shard": sh, "seconds": sec, "rows": rows_,
                    "dispatches": cnt,
                    "mean_us": sec / max(cnt, 1) * 1e6,
                })
            skew = None
            if len(shards) >= 2:
                lo = min(s["seconds"] for s in shards)
                skew = shards[0]["seconds"] / max(lo, 1e-12)
            rows.append({
                "kind": kind, "segment": segment, "count": agg["count"],
                "phase_us": phase_us, "phase_sum_us": phase_sum_us,
                "rtt_us": rtt_us,
                "coverage": (phase_sum_us / rtt_us
                             if rtt_us else None),
                "rows_real": agg["rows_real"],
                "rows_padded": agg["rows_padded"],
                "pad_waste": (agg["rows_padded"] / total_rows
                              if total_rows else 0.0),
                "gflops": agg["flops"] / 1e9 if agg["flops"] else None,
                "achieved_gflops_per_s": (
                    agg["flops"] / compute_s / 1e9
                    if agg["flops"] and compute_s > 0 else None),
                "slowest_shard": shards[0]["shard"] if shards else None,
                "shard_skew": skew,
                "shards": shards,
            })
        return rows

    def snapshot(self) -> dict:
        """The serving `info()` block: armed bit + attribution rows."""
        self.flush()
        with self._lock:
            ledgers = self._ledgers
        return {"enabled": self.enabled, "ledgers": ledgers,
                "attribution": self.attribution()}


# --------------------------------------------------------------------- #
# cost analysis                                                         #
# --------------------------------------------------------------------- #


def cost_analysis_of(fn: Any, *args: Any, **kwargs: Any) -> "dict | None":
    """FLOPs + bytes-accessed estimate for the work `fn` would do at these
    args: None in the port, and `fn` is never called.

    The JAX package lowers and compiles a jitted function and reads XLA's
    cost analysis; nothing runs, and a backend without costs gives None.
    The port's dispatched callables are CUDA-graph replays (core/fusion.py
    `_CudaGraphExec`) and eager compositions with no compiler to ask:
    calling one, even under a FLOP counter, would run it, launch its
    kernels and advance their launch counters. So the port gives the
    reference's fail-soft answer, None, and attribution is time-only (no
    GFLOP/s column)."""
    return None


# --------------------------------------------------------------------- #
# fleet aggregation + rendering                                         #
# --------------------------------------------------------------------- #


def attribution_from_snapshot(snap: dict) -> list[dict]:
    """Attribution rows rebuilt from a metrics snapshot — either one
    registry's `MetricsRegistry.snapshot()` or the fleet-merged
    `MetricsAggregator.snapshot()` (histograms sum across replicas under
    the standard merge policy, so the fleet table needs no new wire
    format). Only phase timings and row counters survive the round trip;
    per-record RTT and shard rows come from `SHARD_SECONDS`."""
    fam = snap.get(PHASE_SECONDS) or {}
    agg: dict[tuple[str, str], dict] = {}
    for s in fam.get("samples", []):
        lbl = s.get("labels", {})
        key = (lbl.get("kind", "-"), lbl.get("segment", "-"))
        row = agg.setdefault(key, {"phases": {}, "counts": {}})
        p = lbl.get(PHASE_LABEL, "?")
        row["phases"][p] = row["phases"].get(p, 0.0) + float(s.get("sum", 0.0))
        row["counts"][p] = row["counts"].get(p, 0) + int(s.get("count", 0))
    real = {}
    padded = {}
    for name, dest in ((ROWS_REAL_TOTAL, real), (ROWS_PADDED_TOTAL, padded)):
        for s in (snap.get(name) or {}).get("samples", []):
            lbl = s.get("labels", {})
            key = (lbl.get("kind", "-"), lbl.get("segment", "-"))
            dest[key] = dest.get(key, 0.0) + float(s.get("value", 0.0))
    shards: dict[str, list] = {}
    for s in (snap.get(SHARD_SECONDS) or {}).get("samples", []):
        lbl = s.get("labels", {})
        ent = shards.setdefault(lbl.get("segment", "-"), [])
        ent.append({"shard": lbl.get("shard", "?"),
                    "seconds": float(s.get("sum", 0.0)),
                    "dispatches": int(s.get("count", 0))})
    rows = []
    for (kind, segment), row in sorted(agg.items()):
        n = max(max(row["counts"].values(), default=0), 1)
        phase_us = {p: row["phases"][p] / n * 1e6
                    for p in PHASES if p in row["phases"]}
        seg_shards = sorted(shards.get(segment, []),
                            key=lambda d: d["seconds"], reverse=True)
        total_rows = real.get((kind, segment), 0.0) \
            + padded.get((kind, segment), 0.0)
        rows.append({
            "kind": kind, "segment": segment, "count": n,
            "phase_us": phase_us, "phase_sum_us": sum(phase_us.values()),
            "rtt_us": None, "coverage": None,
            "rows_real": real.get((kind, segment), 0.0),
            "rows_padded": padded.get((kind, segment), 0.0),
            "pad_waste": (padded.get((kind, segment), 0.0) / total_rows
                          if total_rows else 0.0),
            "gflops": None, "achieved_gflops_per_s": None,
            "slowest_shard": seg_shards[0]["shard"] if seg_shards else None,
            "shard_skew": (seg_shards[0]["seconds"]
                           / max(min(d["seconds"] for d in seg_shards),
                                 1e-12)
                           if len(seg_shards) >= 2 else None),
            "shards": seg_shards,
        })
    return rows


def render_attribution(rows: list[dict],
                       title: str = "phase attribution") -> str:
    """The one-shot attribution table, as text."""
    out = [f"== {title} =="]
    if not rows:
        out.append("  (no ledgers committed — is the profiler armed?)")
        return "\n".join(out)
    cols = [p for p in PHASES
            if any(p in r["phase_us"] for r in rows)]
    hdr = (f"  {'kind':<10} {'segment':<14} {'n':>6} "
           + " ".join(f"{p + '/us':>12}" for p in cols)
           + f" {'sum/us':>10} {'rtt/us':>10} {'cov%':>6} {'waste%':>7}")
    out.append(hdr)
    for r in rows:
        cells = " ".join(
            f"{r['phase_us'].get(p, 0.0):>12.1f}" for p in cols)
        rtt = f"{r['rtt_us']:>10.1f}" if r["rtt_us"] else f"{'-':>10}"
        cov = (f"{r['coverage'] * 100:>6.1f}" if r["coverage"]
               else f"{'-':>6}")
        out.append(
            f"  {r['kind']:<10} {r['segment']:<14} {r['count']:>6} "
            f"{cells} {r['phase_sum_us']:>10.1f} {rtt} {cov} "
            f"{r['pad_waste'] * 100:>7.2f}")
        if r.get("achieved_gflops_per_s"):
            out.append(
                f"    cost: {r['gflops']:.3f} GFLOP/dispatch, "
                f"achieved {r['achieved_gflops_per_s']:.2f} GFLOP/s")
    shard_rows = [r for r in rows if r.get("shards")]
    for r in shard_rows:
        out.append(f"  -- shard spread: segment {r['segment']} "
                   f"(skew {r['shard_skew']:.2f}x)"
                   if r.get("shard_skew")
                   else f"  -- shard spread: segment {r['segment']}")
        for i, sh in enumerate(r["shards"]):
            tag = "  <- slowest" if i == 0 and len(r["shards"]) > 1 else ""
            rows_txt = (f" rows={sh['rows']}" if sh.get("rows")
                        else "")
            out.append(
                f"     {sh['shard']:<28} {sh['seconds'] * 1e6:>12.1f} us "
                f"over {sh['dispatches']} dispatches{rows_txt}{tag}")
    return "\n".join(out)


# --------------------------------------------------------------------- #
# process-default profiler                                              #
# --------------------------------------------------------------------- #

_DEFAULT: "Profiler | None" = None
_DEFAULT_LOCK = make_lock("profiler._DEFAULT_LOCK")


def get_profiler() -> Profiler:
    """The process-default profiler. Starts DISARMED (unlike metrics and
    the recorder): attribution is a diagnosis tool you arm on demand —
    `arm()`, `set_default_profiler(Profiler(enabled=True))`, or tests."""
    global _DEFAULT
    p = _DEFAULT
    if p is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Profiler(enabled=False)
            p = _DEFAULT
    return p


def set_default_profiler(prof: "Profiler | None") -> "Profiler | None":
    """Swap the process-default profiler (tests); returns the previous."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        old, _DEFAULT = _DEFAULT, prof
    return old
