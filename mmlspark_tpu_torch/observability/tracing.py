"""Span tracing: Dapper-style host spans exported as Chrome-trace JSONL.

A copy of mmlspark_tpu/observability/tracing.py, with the device
annotation re-pointed from jax.profiler to torch.profiler.

`Tracer.start_span` is a context manager; nested spans pick up the
active span as parent through a contextvar, and cross-thread work
propagates explicitly (`parent=span` or `bind(span)` in the worker).
Completed spans land in a bounded ring buffer and export as
Chrome-trace/Perfetto events — one JSON object per line (JSONL), each a
complete `"ph": "X"` duration event, so `chrome://tracing`, Perfetto's
legacy-JSON importer, or a five-line script can load them
(`export_jsonl` / `load_jsonl`).

Distributed propagation: span ids are PROCESS-SEEDED (pid mixed into the
high bits of the id counter), so per-replica JSONL exports merge into one
fleet trace with no id collisions (`merge_jsonl`). `inject()` renders the
active span as a W3C `traceparent` header (clients attach it via
`current_traceparent()`); `extract()` parses an incoming header into a
remote parent span, so a server-side span joins the caller's trace —
the Dapper pattern end to end.

Device correlation: when `MMLSPARK_TPU_TRACE_DIR` is set, every host
span ALSO enters a `torch.profiler.record_function`, so the same span
names appear in a torch.profiler trace's annotation track and host spans
line up with device activity in the card's trace.

The disabled path is a no-op fast path: one attribute check, a shared
null context manager — no allocation, no locks, no contextvar writes.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import re
import threading
from .sanitizer import make_lock
import time
from collections import deque
from typing import Any

__all__ = ["Span", "Tracer", "get_tracer", "set_default_tracer",
           "load_jsonl", "merge_jsonl", "CHROME_EVENT_KEYS",
           "format_traceparent", "parse_traceparent",
           "current_traceparent", "PHASE_SPAN_PREFIX", "phase_children"]

# the profiler's phase child-spans are named `phase.<name>` under the
# dispatch/request span they decompose (observability.profiler)
PHASE_SPAN_PREFIX = "phase."

# the schema contract for exported events (load_jsonl verifies it)
CHROME_EVENT_KEYS = ("name", "cat", "ph", "ts", "dur", "pid", "tid")

# W3C Trace Context: version "00", 16-byte trace-id, 8-byte parent-id,
# flags — all lowercase hex, all-zero ids invalid
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def format_traceparent(trace_id: int, span_id: int) -> str:
    """Render ids as a W3C `traceparent` header value (sampled flag set)."""
    return f"00-{trace_id % (1 << 128):032x}-{span_id % (1 << 64):016x}-01"


def parse_traceparent(header: "str | None") -> "tuple[int, int] | None":
    """(trace_id, span_id) from a `traceparent` header; None when absent
    or malformed (a bad header must degrade to 'no trace', never error)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None or m.group(1) == "ff":
        return None
    trace_id, span_id = int(m.group(2), 16), int(m.group(3), 16)
    if not trace_id or not span_id:
        return None
    return trace_id, span_id


class Span:
    """One timed region. `set(**args)` attaches arguments post-start
    (they export into the Chrome event's "args")."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "parent",
                 "start_us", "dur_us", "args", "tid")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent: "Span | None", start_us: float, args: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent = parent
        self.parent_id = parent.span_id if parent is not None else 0
        self.start_us = start_us
        self.dur_us = 0.0
        self.args = args
        self.tid = threading.get_ident()

    def set(self, **args: Any) -> None:
        self.args.update(args)

    def find_arg(self, key: str) -> Any:
        """Look up an argument on this span or the nearest ancestor that
        carries it (e.g. the batch id a streaming batch span stamped)."""
        node: "Span | None" = self
        while node is not None:
            if key in node.args:
                return node.args[key]
            node = node.parent
        return None


class _NullSpan:
    __slots__ = ()
    name = ""
    trace_id = 0
    span_id = 0
    parent_id = 0
    parent = None
    args: dict = {}

    def set(self, **args: Any) -> None:
        pass

    def find_arg(self, key: str) -> Any:
        return None


_NULL_SPAN = _NullSpan()


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CTX = _NullCtx()


def _device_annotation(name: str):
    """torch.profiler.record_function(name), the range a torch.profiler
    trace shows; the import is lazy and fail-soft so the tracer stays
    dependency-free."""
    try:
        import torch.profiler

        return torch.profiler.record_function(name)
    except Exception:
        return None


class _SpanCtx:
    __slots__ = ("_tracer", "_span", "_token", "_ann")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span
        self._token = None
        self._ann = None

    def __enter__(self) -> Span:
        self._token = self._tracer._current.set(self._span)
        if self._tracer.annotate_device:
            self._ann = _device_annotation(self._span.name)
            if self._ann is not None:
                self._ann.__enter__()
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._ann is not None:
            self._ann.__exit__(*exc)
        span = self._span
        span.dur_us = self._tracer._now_us() - span.start_us
        self._tracer._current.reset(self._token)
        self._tracer._record(span)
        return False


class Tracer:
    """Bounded-buffer span collector.

    clock            duck-typed `monotonic()` (resilience FakeClock fits);
                     span timestamps are microseconds on this clock
    max_spans        ring-buffer bound on retained completed spans
    annotate_device  also enter torch.profiler.record_function per span;
                     default: on exactly when MMLSPARK_TPU_TRACE_DIR is
                     set, so host spans appear in the device trace the
                     same env var turns on
    """

    def __init__(self, clock: Any = None, enabled: bool = True,
                 max_spans: int = 65536,
                 annotate_device: "bool | None" = None,
                 id_seed: "int | None" = None):
        self._clock = clock
        self.enabled = bool(enabled)
        self.annotate_device = (
            bool(os.environ.get("MMLSPARK_TPU_TRACE_DIR"))
            if annotate_device is None else bool(annotate_device))
        self._spans: deque[Span] = deque(maxlen=int(max_spans))
        self._dropped = 0
        self._lock = make_lock("Tracer._lock")
        # Ids are PROCESS-SEEDED: the pid owns the top bits and random
        # bits scatter the counter base, so per-replica exports merge
        # into one fleet trace with no span-id collisions. Stays < 2^62
        # so span ids fit W3C traceparent's 8 bytes (and trace ids its
        # 16). id_seed=1 restores the legacy deterministic 1,2,3,...
        # numbering for tests that assert exact ids.
        if id_seed is None:
            rand = int.from_bytes(os.urandom(5), "big")  # 40 bits
            id_seed = ((os.getpid() & 0x3FFFFF) << 40) | rand | 1
        self._ids = itertools.count(int(id_seed))
        self._current: contextvars.ContextVar["Span | None"] = \
            contextvars.ContextVar(f"tracer_span_{id(self):x}",
                                   default=None)

    def _now_us(self) -> float:
        if self._clock is not None:
            return self._clock.monotonic() * 1e6
        return time.monotonic() * 1e6

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                # the ring is about to evict its oldest span — count it,
                # so exports can say "N spans lost" instead of silently
                # truncating the incident's head
                self._dropped += 1
            self._spans.append(span)

    @property
    def drop_count(self) -> int:
        """Spans evicted from the ring since the last export (or clear) —
        the truncation an incident report must disclose."""
        return self._dropped

    # -- span API ------------------------------------------------------- #

    def start_span(self, name: str, parent: "Span | None" = None,
                   **args: Any):
        """Context manager yielding the Span. Parent resolution: explicit
        `parent=` (cross-thread propagation) beats the thread's active
        span. Disabled tracers return a shared null context: no locks, no
        allocation, no contextvar writes."""
        if not self.enabled:
            return _NULL_CTX
        if parent is None:
            parent = self._current.get()
        trace_id = parent.trace_id if parent is not None else next(self._ids)
        span = Span(name, trace_id, next(self._ids), parent,
                    self._now_us(), dict(args))
        return _SpanCtx(self, span)

    def current_span(self) -> "Span | None":
        """The active span on this thread (None when outside any span)."""
        if not self.enabled:
            return None
        return self._current.get()

    def bind(self, span: "Span | None"):
        """Adopt `span` as the active parent on THIS thread — the worker
        half of cross-thread propagation (the submitting thread passes the
        span object, the worker binds it)."""
        if not self.enabled or span is None:
            return _NULL_CTX
        return _Bind(self, span)

    # -- distributed propagation ---------------------------------------- #

    def inject(self, span: "Span | None" = None) -> "str | None":
        """The active (or given) span as a `traceparent` header value;
        None when tracing is off or no span is active — callers skip the
        header rather than sending a broken one."""
        if not self.enabled:
            return None
        if span is None:
            span = self._current.get()
        if span is None or not getattr(span, "span_id", 0):
            return None
        return format_traceparent(span.trace_id, span.span_id)

    def extract(self, header: "str | None") -> "Span | None":
        """An incoming `traceparent` as a synthetic REMOTE parent span:
        pass it to `start_span(parent=...)` and the local span joins the
        caller's trace. The remote span is never recorded locally — the
        caller's own process exports it."""
        if not self.enabled:
            return None
        ids = parse_traceparent(header)
        if ids is None:
            return None
        trace_id, span_id = ids
        return Span("remote", trace_id, span_id, None, 0.0, {"remote": True})

    # -- export --------------------------------------------------------- #

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    def chrome_events(self) -> list[dict]:
        """Completed spans as Chrome-trace duration events."""
        pid = os.getpid()
        out = []
        for s in self.spans():
            out.append({
                "name": s.name, "cat": "mmlspark_tpu", "ph": "X",
                "ts": s.start_us, "dur": s.dur_us,
                "pid": pid, "tid": s.tid,
                "args": {**s.args, "trace_id": s.trace_id,
                         "span_id": s.span_id, "parent_id": s.parent_id},
            })
        return out

    def export_jsonl(self, path: str) -> int:
        """Write one Chrome-trace event per line; returns the event count.
        Perfetto/chrome://tracing load the same events wrapped in a list —
        `json.dumps({"traceEvents": [json.loads(l) for l in open(p)]})`.

        When the ring evicted spans since the last export, the file leads
        with a synthetic zero-duration `tracer.spans_lost` event (schema-
        valid, args.count = N) so the truncation is stated in-band; the
        drop counter resets, scoping the disclosure to this export."""
        events = self.chrome_events()
        with self._lock:
            dropped, self._dropped = self._dropped, 0
        if dropped:
            first_ts = min((ev["ts"] for ev in events), default=0.0)
            events.insert(0, {
                "name": "tracer.spans_lost", "cat": "mmlspark_tpu",
                "ph": "X", "ts": first_ts, "dur": 0.0,
                "pid": os.getpid(), "tid": 0,
                "args": {"count": dropped},
            })
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            for ev in events:
                fh.write(json.dumps(ev) + "\n")
        return len(events)

    @staticmethod
    def merge_jsonl(paths: "list[str]", out_path: str) -> int:
        """Merge per-replica JSONL exports into one fleet trace file:
        each input is schema-validated (`load_jsonl`), events are sorted
        by timestamp, and the result is written as JSONL. Process-seeded
        ids keep cross-file span ids collision-free, so a client span in
        one file parents a server span in another purely through the
        propagated trace_id/parent_id args. Returns the event count."""
        events: list[dict] = []
        for p in paths:
            events.extend(load_jsonl(p))
        events.sort(key=lambda ev: ev["ts"])
        out_dir = os.path.dirname(os.path.abspath(out_path))
        os.makedirs(out_dir, exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as fh:
            for ev in events:
                fh.write(json.dumps(ev) + "\n")
        return len(events)


class _Bind:
    __slots__ = ("_tracer", "_span", "_token")

    def __init__(self, tracer: Tracer, span: Span):
        self._tracer = tracer
        self._span = span
        self._token = None

    def __enter__(self) -> Span:
        self._token = self._tracer._current.set(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        self._tracer._current.reset(self._token)
        return False


def load_jsonl(path: str) -> list[dict]:
    """Load an exported trace, verifying the Chrome-trace event schema
    (every line a JSON object with name/cat/ph/ts/dur/pid/tid)."""
    events = []
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            missing = [k for k in CHROME_EVENT_KEYS if k not in ev]
            if missing:
                raise ValueError(
                    f"{path}:{i + 1}: event missing keys {missing}")
            if ev["ph"] != "X":
                raise ValueError(
                    f"{path}:{i + 1}: expected duration event, got "
                    f"ph={ev['ph']!r}")
            events.append(ev)
    return events


merge_jsonl = Tracer.merge_jsonl


def phase_children(events: "list[dict]",
                   parent_span_id: "int | None" = None) -> "dict[int, dict]":
    """Group the profiler's `phase.*` child events out of an exported
    Chrome-trace event list: {parent span_id: {phase name: dur_us}}.
    Pass `parent_span_id` to restrict to one dispatch/request span —
    what the Perfetto round-trip test and `diagnose.py --perf` use to
    re-read an attribution straight from a trace file."""
    out: dict[int, dict] = {}
    for ev in events:
        name = ev.get("name", "")
        if not name.startswith(PHASE_SPAN_PREFIX):
            continue
        args = ev.get("args", {})
        pid_ = args.get("parent_id", 0)
        if parent_span_id is not None and pid_ != parent_span_id:
            continue
        phases = out.setdefault(pid_, {})
        short = name[len(PHASE_SPAN_PREFIX):]
        phases[short] = phases.get(short, 0.0) + float(ev.get("dur", 0.0))
    return out


# --------------------------------------------------------------------- #
# process-default tracer                                                #
# --------------------------------------------------------------------- #

_DEFAULT: "Tracer | None" = None
_DEFAULT_LOCK = make_lock("tracing._DEFAULT_LOCK")


def get_tracer() -> Tracer:
    global _DEFAULT
    t = _DEFAULT
    if t is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Tracer()
            t = _DEFAULT
    return t


def set_default_tracer(tracer: "Tracer | None") -> "Tracer | None":
    """Swap the process-default tracer (tests); returns the previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        old, _DEFAULT = _DEFAULT, tracer
    return old


def current_traceparent() -> "str | None":
    """`traceparent` for the process-default tracer's active span — the
    one-liner HTTP clients call to propagate the trace downstream."""
    return get_tracer().inject()
