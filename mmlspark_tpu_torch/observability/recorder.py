"""FlightRecorder: a per-process black box for after-the-fact forensics.

A copy of mmlspark_tpu/observability/recorder.py.

The live observability stack (metrics + spans + fleet aggregation + SLO
burn rates) answers "what is happening?" while you watch. When a chaos
soak or a production fleet violates its SLO, the evidence has usually
rotated out by the time anyone looks: the span ring re-used its slots,
histograms say *that* p99 spiked but not *which* requests, and a killed
replica takes its in-memory telemetry with it. This module is the layer
that answers "what just happened?" — a bounded, lock-cheap ring of
structured events, continuously armed, dumped ATOMICALLY to disk the
moment something goes wrong:

* SLO burn-rate alert        (`SLOEngine.attach_recorder` — fires on the
                              not-alerting -> alerting transition)
* load-shed / deadline spike (`note_shed` / `note_expired`: a rolling
                              window crossing `spike_threshold` dumps)
* supervisor restart         (resilience.supervisor wiring)
* SIGTERM drain / kill()     (io_http.serving `_fleet_worker` + the
                              `POST /flightrecorder/dump` broadcast)
* unhandled loop exception   (streaming.query fatal path)

Design constraints mirror metrics.py/tracing.py:

* stdlib-only, never imports back into mmlspark_tpu — every hot module
  can hold a recorder without cycles.
* The DISARMED path is one attribute check (`record` returns before
  building the event dict); arming costs one small dict + a deque
  append under a lock per event.
* Injectable clock (duck-typed `monotonic()`, resilience FakeClock
  fits): chaos tests drive triggers with zero real waiting, and dumps
  from FakeClock processes stay ordered for the postmortem merge.
* Dumps are JSONL behind an `os.replace` — the postmortem reader never
  sees a torn file, even when the process dies mid-incident.

Dump format (`flight-<process>-<pid>.jsonl`, schema-checked by
`load_dump`): line 1 is a `recorder.meta` header (schema version,
trigger, event counts, ring drops, tracer spans lost), line 2 an
optional full `metrics.snapshot`, then every ring event oldest-first.
Events carry {ts, kind, pid, seq, data}; `seq` is a per-process
monotone counter, the tiebreaker FakeClock timelines need.

`tools/diagnose.py --postmortem <dir>` merges every process's dumps
into one causally-ordered incident timeline.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from .sanitizer import make_lock
import time
from collections import deque
from typing import Any

__all__ = [
    "FlightRecorder", "load_dump", "get_recorder", "set_default_recorder",
    "DUMP_SCHEMA_VERSION", "EVENT_KEYS", "DUMP_PREFIX",
]

# the schema contract for dumped events (load_dump verifies it)
EVENT_KEYS = ("ts", "kind", "pid", "seq", "data")
DUMP_SCHEMA_VERSION = 1
DUMP_PREFIX = "flight-"


class _MonotonicClock:
    def monotonic(self) -> float:
        return time.monotonic()


class FlightRecorder:
    """Bounded ring of structured incident events + atomic trigger dumps.

    capacity          ring bound on retained events (oldest evicted;
                      evictions are counted and disclosed in the dump
                      header, like Tracer.drop_count)
    clock             duck-typed `monotonic()` (FakeClock fits)
    enabled           the armed bit — disabled recorders no-op on the
                      first attribute check
    dump_dir          where triggered dumps land; None records into the
                      ring but makes every dump request a no-op (the
                      ring still serves in-process inspection)
    process           short name stamped into dump filenames and the
                      header ("replica-0", "gateway", ...)
    tick_interval_s   coarse cadence of metric-delta snapshot events
                      (`maybe_tick`)
    spike_window_s /  `note_shed`/`note_expired` events inside one
    spike_threshold   window at or past the threshold auto-dump
                      ("shed_spike" / "deadline_spike")
    dump_cooldown_s   minimum spacing between AUTOMATIC dumps (spike and
                      SLO-transition triggers); explicit `dump()` and
                      terminal triggers (`sigterm`, `exception`, ...)
                      via `trigger_dump(..., force=True)` ignore it
    keep              dump-directory retention: after each dump, only
                      the newest `keep` dumps from THIS process survive
                      (mirrors TrainingCheckpointer's keep-N; None keeps
                      everything). Prunes are counted in
                      `recorder_dumps_pruned_total` so a flapping
                      trigger eating its own history is visible.
    """

    def __init__(self, capacity: int = 4096, clock: Any = None,
                 enabled: bool = True, dump_dir: "str | None" = None,
                 process: str = "proc", tick_interval_s: float = 5.0,
                 spike_window_s: float = 1.0, spike_threshold: int = 50,
                 dump_cooldown_s: float = 30.0, registry: Any = None,
                 keep: "int | None" = None):
        self.enabled = bool(enabled)
        self.dump_dir = dump_dir
        self.process = str(process)
        self.tick_interval_s = float(tick_interval_s)
        self.spike_window_s = float(spike_window_s)
        self.spike_threshold = int(spike_threshold)
        self.dump_cooldown_s = float(dump_cooldown_s)
        if keep is not None and int(keep) < 1:
            raise ValueError("keep must be >= 1 (or None to disable)")
        self.keep = int(keep) if keep is not None else None
        # injectable registry the tick deltas and dump snapshot read from
        # (None: the process default at call time)
        self.registry = registry
        self._clock = clock if clock is not None else _MonotonicClock()
        self._lock = make_lock("FlightRecorder._lock")
        self._events: deque[dict] = deque(maxlen=int(capacity))
        self._seq = 0
        self._dropped = 0
        self._dump_count = 0
        self._last_auto_dump_t = float("-inf")
        # rolling windows for the shed / deadline-expiry spike triggers
        self._shed_ts: deque[float] = deque()
        self._expired_ts: deque[float] = deque()
        # metric-delta tick state: last tick time + counter baseline
        self._last_tick_t = float("-inf")
        self._tick_base: "dict[str, float]" = {}
        # SLO transition state: currently-alerting names
        self._alerting: "frozenset[str]" = frozenset()
        # optional callback(trigger, path) invoked AFTER a successful
        # dump — a driver-side recorder chains a fleet-wide broadcast
        # (ServingFleet.dump_all) off its own trigger this way
        self.on_dump: "Any | None" = None

    # -- recording (the hot path) --------------------------------------- #

    def record(self, kind: str, **data: Any) -> None:
        """Append one event to the ring. Disarmed: one attribute check."""
        if not self.enabled:
            return
        ts = self._clock.monotonic()
        with self._lock:
            self._seq += 1
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append({"ts": ts, "kind": kind,
                                 "pid": os.getpid(), "seq": self._seq,
                                 "data": data})

    def record_request(self, trace_id: "int | str" = 0, route: str = "",
                       bucket: "int | None" = None,
                       queue_depth: "int | None" = None,
                       latency_s: "float | None" = None,
                       status: int = 200, **extra: Any) -> None:
        """One served request: the per-request black-box record the
        postmortem joins with exemplars and spans through `trace_id`."""
        if not self.enabled:
            return
        self.record("serving.request", trace_id=str(trace_id), route=route,
                    bucket=bucket, queue_depth=queue_depth,
                    latency_s=latency_s, status=status, **extra)

    def record_ledger(self, ledger: str = "", segment: str = "",
                      phases: "dict | None" = None, **extra: Any) -> None:
        """One committed profiler phase ledger (observability.profiler):
        the black box keeps the per-dispatch attribution records around
        an incident, not just their aggregate histograms — a postmortem
        can say which phase blew up on the exact slow dispatches."""
        if not self.enabled:
            return
        self.record("profiler.ledger", ledger=ledger, segment=segment,
                    phases=phases or {}, **extra)

    def record_transition(self, component: str, action: str,
                          **detail: Any) -> None:
        """A control-plane state change: breaker trip/close, autoscaler
        scale/heal, gateway admit/eject, rolling-swap step, supervisor
        restart."""
        if not self.enabled:
            return
        self.record("transition", component=component, action=action,
                    **detail)

    # -- spike triggers -------------------------------------------------- #

    def _note_spike(self, window: "deque[float]", kind: str,
                    trigger: str) -> "str | None":
        if not self.enabled:
            return None
        now = self._clock.monotonic()
        with self._lock:
            window.append(now)
            while window and window[0] < now - self.spike_window_s:
                window.popleft()
            spiking = len(window) >= self.spike_threshold
            if spiking:
                window.clear()  # one dump per spike, not per excess event
        self.record(kind)
        if spiking:
            return self.trigger_dump(trigger)
        return None

    def note_shed(self) -> "str | None":
        """A load-shed (503) happened; dumps on a shed spike."""
        return self._note_spike(self._shed_ts, "serving.shed", "shed_spike")

    def note_expired(self) -> "str | None":
        """A deadline expiry (504) happened; dumps on an expiry spike."""
        return self._note_spike(self._expired_ts, "serving.expired",
                                "deadline_spike")

    # -- coarse metric-delta tick ---------------------------------------- #

    def maybe_tick(self, registry: Any = None) -> bool:
        """On a coarse cadence, record a `metrics.tick` event holding the
        DELTAS of every counter/histogram-count series since the previous
        tick — the "what moved around the trigger" signal the postmortem
        tabulates. Cheap between ticks: one clock read + compare."""
        if not self.enabled:
            return False
        now = self._clock.monotonic()
        if now - self._last_tick_t < self.tick_interval_s:
            return False
        self._last_tick_t = now
        if registry is None:
            registry = self.registry
        if registry is None:
            from .metrics import get_registry

            registry = get_registry()
        totals: dict[str, float] = {}
        try:
            snap = registry.snapshot()
        except Exception:  # noqa: BLE001 — a broken collector never dumps us
            return False
        for name, fam in snap.items():
            if fam.get("kind") == "histogram":
                totals[name] = float(sum(
                    s.get("count", 0) for s in fam["samples"]))
            elif fam.get("kind") == "counter":
                totals[name] = float(sum(
                    s.get("value", 0.0) for s in fam["samples"]))
        deltas = {n: v - self._tick_base.get(n, 0.0)
                  for n, v in totals.items()
                  if v - self._tick_base.get(n, 0.0) != 0.0}
        self._tick_base = totals
        self.record("metrics.tick", deltas=deltas)
        return True

    # -- SLO transition trigger ------------------------------------------ #

    def note_slo(self, alerting: "list[str]") -> "str | None":
        """Track the alerting set; dump on the empty -> non-empty (or
        newly-added SLO) transition, not on every evaluation while an
        alert stays up."""
        if not self.enabled:
            return None
        names = frozenset(alerting)
        fresh = names - self._alerting
        self._alerting = names
        if fresh:
            self.record("slo.alert", slos=sorted(names),
                        fresh=sorted(fresh))
            return self.trigger_dump("slo_burn", slos=sorted(names))
        return None

    # -- dumping --------------------------------------------------------- #

    @property
    def drop_count(self) -> int:
        """Events evicted from the ring since the last dump."""
        return self._dropped

    def events(self) -> "list[dict]":
        with self._lock:
            return list(self._events)

    def trigger_dump(self, trigger: str, force: bool = False,
                     **detail: Any) -> "str | None":
        """Dump the ring if armed and a dump_dir is configured. Automatic
        triggers respect `dump_cooldown_s` (a flapping alert must not
        grind the disk); `force=True` is for terminal triggers where this
        is the last chance to get the evidence out."""
        if not self.enabled or not self.dump_dir:
            return None
        now = self._clock.monotonic()
        with self._lock:
            if not force and now - self._last_auto_dump_t < self.dump_cooldown_s:
                return None
            self._last_auto_dump_t = now
        return self.dump(trigger, **detail)

    def dump(self, trigger: str = "manual", **detail: Any) -> "str | None":
        """Write the ring to `dump_dir` atomically (tempfile + os.replace);
        returns the path, or None when no dump_dir is configured. The
        header discloses ring evictions and tracer span loss so the
        postmortem can state what the black box did NOT capture."""
        if not self.dump_dir:
            return None
        spans_lost = 0
        try:
            from .tracing import get_tracer

            spans_lost = get_tracer().drop_count
        except Exception:  # noqa: BLE001 — tracing is best-effort here
            pass
        snapshot = None
        try:
            registry = self.registry
            if registry is None:
                from .metrics import get_registry

                registry = get_registry()
            snapshot = registry.snapshot()
        except Exception:  # noqa: BLE001 — metrics are best-effort here
            snapshot = None
        pid = os.getpid()
        with self._lock:
            events = list(self._events)
            dropped, self._dropped = self._dropped, 0
            self._dump_count += 1
            n = self._dump_count
        # per-route request breakdown of the dumped ring (resident /
        # sar_resident / native / host): the postmortem can attribute an
        # incident to one serving route without re-scanning every event
        route_counts: dict[str, int] = {}
        for ev in events:
            if ev["kind"] == "serving.request":
                r = ev["data"].get("route") or "-"
                route_counts[r] = route_counts.get(r, 0) + 1
        meta = {"kind": "recorder.meta", "schema": DUMP_SCHEMA_VERSION,
                "trigger": trigger, "detail": detail,
                "process": self.process, "pid": pid,
                "ts": self._clock.monotonic(),
                "events": len(events), "events_dropped": dropped,
                "spans_lost": spans_lost, "dump_n": n,
                "route_counts": route_counts}
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(
            self.dump_dir, f"{DUMP_PREFIX}{self.process}-{pid}-{n:03d}.jsonl")
        fd, tmp = tempfile.mkstemp(dir=self.dump_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                fh.write(json.dumps(meta) + "\n")
                if snapshot is not None:
                    fh.write(json.dumps(
                        {"ts": meta["ts"], "kind": "metrics.snapshot",
                         "pid": pid, "seq": 0,
                         "data": {"snapshot": snapshot}}) + "\n")
                for ev in events:
                    fh.write(json.dumps(ev) + "\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        if self.keep is not None:
            self._prune_dumps()
        if self.on_dump is not None:
            try:
                self.on_dump(trigger, path)
            except Exception:  # noqa: BLE001 — a broken hook keeps the dump
                pass
        return path

    def _prune_dumps(self) -> None:
        """keep-N retention over THIS process's dumps, oldest first —
        other processes sharing the directory own their own files. The
        just-written dump is never pruned (keep >= 1)."""
        prefix = f"{DUMP_PREFIX}{self.process}-"
        try:
            names = [n for n in os.listdir(self.dump_dir)
                     if n.startswith(prefix) and n.endswith(".jsonl")]
        except OSError:
            return
        if len(names) <= self.keep:
            return

        def _order(n: str) -> "tuple[float, str]":
            try:
                return (os.path.getmtime(os.path.join(self.dump_dir, n)),
                        n)
            except OSError:
                return (0.0, n)

        names.sort(key=_order)
        pruned = 0
        for n in names[:len(names) - self.keep]:
            try:
                os.unlink(os.path.join(self.dump_dir, n))
                pruned += 1
            except OSError:
                pass
        if not pruned:
            return
        try:
            registry = self.registry
            if registry is None:
                from .metrics import get_registry

                registry = get_registry()
            registry.counter(
                "mmlspark_tpu_recorder_dumps_pruned_total",
                "flight-recorder dumps removed by keep-N retention",
            ).inc(pruned)
        except Exception:  # noqa: BLE001 — retention metrics are best-effort
            pass


def load_dump(path: str) -> "tuple[dict, list[dict]]":
    """Load one flight-recorder dump, verifying the schema the way
    tracing.load_jsonl verifies Chrome events: line 1 must be a
    `recorder.meta` header with a known schema version, every following
    line an event object carrying ts/kind/pid/seq/data. Returns
    (meta, events)."""
    meta: "dict | None" = None
    events: list[dict] = []
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if not isinstance(obj, dict):
                raise ValueError(f"{path}:{i + 1}: not a JSON object")
            if meta is None:
                if obj.get("kind") != "recorder.meta":
                    raise ValueError(
                        f"{path}:{i + 1}: dump must start with a "
                        "recorder.meta header")
                if obj.get("schema") != DUMP_SCHEMA_VERSION:
                    raise ValueError(
                        f"{path}:{i + 1}: unknown dump schema "
                        f"{obj.get('schema')!r} (expected "
                        f"{DUMP_SCHEMA_VERSION})")
                meta = obj
                continue
            missing = [k for k in EVENT_KEYS if k not in obj]
            if missing:
                raise ValueError(
                    f"{path}:{i + 1}: event missing keys {missing}")
            events.append(obj)
    if meta is None:
        raise ValueError(f"{path}: empty dump (no recorder.meta header)")
    return meta, events


# --------------------------------------------------------------------- #
# process-default recorder                                              #
# --------------------------------------------------------------------- #

_DEFAULT: "FlightRecorder | None" = None
_DEFAULT_LOCK = make_lock("recorder._DEFAULT_LOCK")


def get_recorder() -> FlightRecorder:
    """The process-default recorder. It starts armed but with no
    dump_dir, so recording is live from import time and the first
    subsystem configured with a `flight_recorder_dir` makes triggers
    actually land on disk."""
    global _DEFAULT
    rec = _DEFAULT
    if rec is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = FlightRecorder()
            rec = _DEFAULT
    return rec


def set_default_recorder(
        rec: "FlightRecorder | None") -> "FlightRecorder | None":
    """Swap the process-default recorder (tests); returns the previous."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        old, _DEFAULT = _DEFAULT, rec
    return old
