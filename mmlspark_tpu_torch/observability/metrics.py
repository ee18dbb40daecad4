"""MetricsRegistry: Counter / Gauge / Histogram with Prometheus exposition.

A copy of mmlspark_tpu/observability/metrics.py; series names are the
JAX package's, so one scrape reads either package.

The reference's observability story is a Timer stage plus log4j
(Timer.scala:55-124, Logging.scala:14-23); by PR 3 this repo had four
subsystems each growing private ad-hoc counters (ServingServer's locked
ints, StreamingQuery.last_progress, dataplane.cache_stats(), breaker
state with no export path). This module is the single registry they all
emit into, scrape-able as Prometheus text exposition from the serving
`/metrics` endpoint.

Design constraints, in order:

* Dependency-free (stdlib only) and import-light: every hot module in
  the package can import it without cycles — it never imports back into
  mmlspark_tpu.
* The DISABLED path is a no-op fast path: one attribute check, no locks
  taken, no dict churn — instrumentation can stay in production code.
* Thread-safe when enabled: instruments are updated from ThreadingHTTPServer
  handler threads, batcher threads, and prefetch workers concurrently.
* Injectable clock (duck-typed `monotonic()`, resilience.policy.FakeClock
  fits) so histogram timing tests run with zero real sleeps.
* Series names are validated at registration against the repo convention
  `mmlspark_tpu_[a-z0-9_]+` (tools/metric_lint.py enforces the unit
  suffix on top).

One process-default registry (`get_registry()`) serves the scrape
endpoint; isolated `MetricsRegistry()` instances serve tests.
"""

from __future__ import annotations

import bisect
import re
import threading
from .sanitizer import make_lock, make_rlock
import time
from typing import Any, Callable, Iterable

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "set_default_registry", "set_enabled",
    "DEFAULT_BUCKETS", "PHASE_BUCKETS", "METRIC_NAME_RE",
    "EXEMPLAR_LABEL_SET_MAX",
]

METRIC_NAME_RE = re.compile(r"^mmlspark_tpu_[a-z0-9_]+$")
_LABEL_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# latency-shaped default: sub-ms serving p50 up through multi-second batches
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# phase-shaped buckets for the profiler's attribution histograms: a
# single dispatch phase (h2d, XLA dispatch, d2h slice) is microseconds,
# not the milliseconds DEFAULT_BUCKETS starts at — resolution must reach
# below where "where did the microsecond go" lives
PHASE_BUCKETS: tuple[float, ...] = (
    0.000001, 0.0000025, 0.000005, 0.00001, 0.000025, 0.00005,
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 1.0,
)


class _Flag:
    """Shared mutable enabled-bit: every instrument checks `flag.on` first,
    so disabling the registry disables every child with one store."""

    __slots__ = ("on",)

    def __init__(self, on: bool):
        self.on = bool(on)


class _MonotonicClock:
    """Default time source (duck-typed like resilience.policy.Clock, but
    local so this module stays dependency-free)."""

    def monotonic(self) -> float:
        return time.monotonic()


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: tuple[str, ...], values: tuple[str, ...],
                extra: "tuple[tuple[str, str], ...]" = ()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# OpenMetrics: "The combined length of the label names and values of an
# Exemplar's LabelSet MUST NOT exceed 128 UTF-8 characters."
EXEMPLAR_LABEL_SET_MAX = 128


def _cap_exemplar_labels(
        pairs: "tuple[tuple[str, str], ...]"
) -> "tuple[tuple[str, str], ...] | None":
    """Trim trailing label pairs until the OpenMetrics 128-char cap holds.
    Callers put the join key (trace_id) first so it survives trimming;
    None when even the first pair is oversized (drop the exemplar, never
    render an invalid one)."""
    kept: list[tuple[str, str]] = []
    budget = EXEMPLAR_LABEL_SET_MAX
    for n, v in pairs:
        budget -= len(n) + len(v)
        if budget < 0:
            break
        kept.append((n, v))
    return tuple(kept) if kept else None


def _fmt_exemplar(pairs: "tuple[tuple[str, str], ...]", value: float) -> str:
    """The OpenMetrics exemplar suffix (sans the leading "# "):
    `{trace_id="..."} 0.0042`."""
    body = ",".join(f'{n}="{_escape_label(v)}"' for n, v in pairs)
    return "{" + body + "} " + _fmt_value(value)


# --------------------------------------------------------------------- #
# children (one per label-value set; these are the hot-path objects)    #
# --------------------------------------------------------------------- #


class _CounterChild:
    __slots__ = ("_flag", "_lock", "_value")

    def __init__(self, flag: _Flag):
        self._flag = flag
        self._lock = make_lock("metrics._CounterChild")
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if not self._flag.on:
            return
        if v < 0:
            raise ValueError(f"counters only go up; got {v}")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        return self._value


class _GaugeChild:
    __slots__ = ("_flag", "_lock", "_value")

    def __init__(self, flag: _Flag):
        self._flag = flag
        self._lock = make_lock("metrics._GaugeChild")
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._flag.on:
            return
        # locked like inc(): an unlocked store could land between inc's
        # read and write and be silently overwritten (lost update)
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        if not self._flag.on:
            return
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        return self._value


class _HistogramChild:
    __slots__ = ("_flag", "_clock", "_lock", "_bounds", "_counts",
                 "_sum", "_count", "_ex_on", "_exemplars")

    def __init__(self, flag: _Flag, clock: Any, bounds: tuple[float, ...],
                 exemplars: bool = False):
        self._flag = flag
        self._clock = clock
        self._lock = make_lock("metrics._HistogramChild")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        # per-bucket last (label_pairs, value) observation; the list is
        # allocated lazily so exemplar-free histograms pay nothing
        self._ex_on = bool(exemplars)
        self._exemplars: "list | None" = None

    def observe(self, v: float, exemplar: "dict | None" = None) -> None:
        if not self._flag.on:
            return
        i = bisect.bisect_left(self._bounds, v)
        pairs = None
        if exemplar and self._ex_on:
            pairs = _cap_exemplar_labels(
                tuple((str(k), str(val)) for k, val in exemplar.items()))
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if pairs is not None:
                if self._exemplars is None:
                    self._exemplars = [None] * len(self._counts)
                self._exemplars[i] = (pairs, float(v))

    def exemplars(self) -> "dict[float, tuple]":
        """Last retained (label_pairs, value) per bucket upper bound —
        only buckets that hold one (the +Inf slot keyed as inf)."""
        with self._lock:
            exs = list(self._exemplars) if self._exemplars else []
        out: dict[float, tuple] = {}
        for idx, ex in enumerate(exs):
            if ex is None:
                continue
            bound = (self._bounds[idx] if idx < len(self._bounds)
                     else float("inf"))
            out[bound] = ex
        return out

    def time(self):
        """Observe the wall time of a block through the registry clock.
        Disabled histograms return one shared null context — no generator
        machinery, no clock reads."""
        if not self._flag.on:
            return _NULL_TIMER
        return _HistTimer(self)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def buckets(self) -> "dict[float, int]":
        """Cumulative bucket counts keyed by upper bound (inf included)."""
        with self._lock:
            counts = list(self._counts)
        out: dict[float, int] = {}
        acc = 0
        for b, c in zip(self._bounds, counts):
            acc += c
            out[b] = acc
        out[float("inf")] = acc + counts[-1]
        return out


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_TIMER = _NullTimer()


class _HistTimer:
    __slots__ = ("_child", "_t0")

    def __init__(self, child: _HistogramChild):
        self._child = child
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = self._child._clock.monotonic()
        return None

    def __exit__(self, *exc) -> bool:
        child = self._child
        child.observe(child._clock.monotonic() - self._t0)
        return False


# --------------------------------------------------------------------- #
# parent instruments (a family: name + label names -> children)         #
# --------------------------------------------------------------------- #


class _Family:
    kind = "untyped"
    _child_cls: type = _CounterChild

    def __init__(self, registry: "MetricsRegistry", name: str, doc: str,
                 labelnames: tuple[str, ...]):
        self._registry = registry
        self.name = name
        self.doc = doc
        self.labelnames = labelnames
        self._children: dict[tuple[str, ...], Any] = {}
        if not labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        return self._child_cls(self._registry._flag)

    def labels(self, **labelvalues: Any):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._registry._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use .labels()")
        return self._children[()]

    def children(self) -> "list[tuple[tuple[str, ...], Any]]":
        with self._registry._lock:
            return sorted(self._children.items())


class Counter(_Family):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Family):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._default().dec(v)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry: "MetricsRegistry", name: str, doc: str,
                 labelnames: tuple[str, ...],
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 exemplars: bool = False):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._bounds = bounds
        self._exemplars_on = bool(exemplars)
        super().__init__(registry, name, doc, labelnames)

    def _make_child(self):
        return _HistogramChild(self._registry._flag, self._registry._clock,
                               self._bounds, exemplars=self._exemplars_on)

    @property
    def exemplars_enabled(self) -> bool:
        return self._exemplars_on

    def enable_exemplars(self) -> None:
        """Turn exemplar retention on for this family (idempotent; the
        promote half of the registry's re-declaration contract — any
        module asking for exemplars=True wins over earlier plain
        declarations of the same series)."""
        self._exemplars_on = True
        with self._registry._lock:
            children = list(self._children.values())
        for child in children:
            child._ex_on = True

    def observe(self, v: float, exemplar: "dict | None" = None) -> None:
        self._default().observe(v, exemplar=exemplar)

    def time(self):
        return self._default().time()

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum

    def buckets(self) -> "dict[float, int]":
        return self._default().buckets()

    def exemplars(self) -> "dict[float, tuple]":
        return self._default().exemplars()


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# --------------------------------------------------------------------- #
# registry                                                              #
# --------------------------------------------------------------------- #


class MetricsRegistry:
    """Thread-safe instrument registry + Prometheus text renderer.

    Instrument getters are idempotent: asking for an existing name with
    the same kind and labels returns the existing family (so modules can
    re-declare their series without coordination); a kind or label
    mismatch raises. `register_callback` adds a pull-style series
    sampled at render time (for state that already has its own counters,
    e.g. dataplane.cache_stats())."""

    def __init__(self, clock: Any = None, enabled: bool = True):
        self._clock = clock if clock is not None else _MonotonicClock()
        self._flag = _Flag(enabled)
        self._lock = make_rlock("MetricsRegistry._lock")
        self._families: dict[str, _Family] = {}
        # name -> (doc, kind, fn); fn() returns a float or a list of
        # (labels_dict, float) samples
        self._callbacks: dict[str, tuple[str, str, Callable[[], Any]]] = {}

    # -- lifecycle ------------------------------------------------------ #

    @property
    def enabled(self) -> bool:
        return self._flag.on

    def set_enabled(self, on: bool) -> None:
        self._flag.on = bool(on)

    # -- registration --------------------------------------------------- #

    def _family(self, kind: str, name: str, doc: str,
                labels: Iterable[str], **kw: Any) -> Any:
        if not METRIC_NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must match {METRIC_NAME_RE.pattern}")
        labelnames = tuple(labels)
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln):
                raise ValueError(f"bad label name {ln!r} on {name}")
        with self._lock:
            if name in self._callbacks:
                raise ValueError(f"{name} is registered as a callback series")
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"{name} already registered as {fam.kind}"
                        f"{fam.labelnames}, requested {kind}{labelnames}")
                return fam
            fam = _KINDS[kind](self, name, doc, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, doc: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._family("counter", name, doc, labels)

    def gauge(self, name: str, doc: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._family("gauge", name, doc, labels)

    def histogram(self, name: str, doc: str = "", labels: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  exemplars: bool = False) -> Histogram:
        fam = self._family("histogram", name, doc, labels, buckets=buckets,
                           exemplars=exemplars)
        if exemplars and not fam.exemplars_enabled:
            fam.enable_exemplars()
        return fam

    def register_callback(self, name: str, doc: str,
                          fn: Callable[[], Any], kind: str = "gauge") -> None:
        """Pull-style series: `fn()` is sampled at render/snapshot time.
        Returns a float (one unlabeled sample) or a list of
        (labels_dict, float). Idempotent per name."""
        if not METRIC_NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must match {METRIC_NAME_RE.pattern}")
        if kind not in ("gauge", "counter"):
            raise ValueError(f"callback kind must be gauge|counter, not {kind}")
        with self._lock:
            if name in self._families:
                raise ValueError(f"{name} is registered as an instrument")
            self._callbacks.setdefault(name, (doc, kind, fn))

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._families or name in self._callbacks

    def names(self) -> list[str]:
        with self._lock:
            return sorted(list(self._families) + list(self._callbacks))

    # -- export --------------------------------------------------------- #

    def _callback_samples(self, fn: Callable[[], Any]
                          ) -> "list[tuple[dict, float]]":
        try:
            out = fn()
        except Exception:  # a broken collector must never break the scrape
            return []
        if isinstance(out, (int, float)):
            return [({}, float(out))]
        return [(dict(lbl), float(v)) for lbl, v in out]

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4. Histograms with
        exemplars enabled render OpenMetrics exemplar suffixes on their
        `_bucket` lines and the exposition gains the OpenMetrics `# EOF`
        terminator (parsers of the plain 0.0.4 dialect skip both)."""
        lines: list[str] = []
        any_exemplar = False
        with self._lock:
            families = sorted(self._families.items())
            callbacks = sorted(self._callbacks.items())
        for name, fam in families:
            lines.append(f"# HELP {name} {fam.doc or name}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in fam.children():
                lbl = _fmt_labels(fam.labelnames, key)
                if fam.kind == "histogram":
                    exs = child.exemplars() if child._ex_on else {}
                    for bound, cum in child.buckets().items():
                        le = "+Inf" if bound == float("inf") else _fmt_value(bound)
                        blbl = _fmt_labels(fam.labelnames, key,
                                           extra=(("le", le),))
                        line = f"{name}_bucket{blbl} {cum}"
                        ex = exs.get(bound)
                        if ex is not None:
                            line += " # " + _fmt_exemplar(*ex)
                            any_exemplar = True
                        lines.append(line)
                    lines.append(f"{name}_sum{lbl} {_fmt_value(child.sum)}")
                    lines.append(f"{name}_count{lbl} {child.count}")
                else:
                    lines.append(f"{name}{lbl} {_fmt_value(child.value)}")
        for name, (doc, kind, fn) in callbacks:
            lines.append(f"# HELP {name} {doc or name}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in self._callback_samples(fn):
                lbl = _fmt_labels(tuple(labels), tuple(str(v) for v in
                                                       labels.values()))
                lines.append(f"{name}{lbl} {_fmt_value(value)}")
        if any_exemplar:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-safe dump of every series (bench metrics snapshot)."""
        out: dict[str, Any] = {}
        with self._lock:
            families = sorted(self._families.items())
            callbacks = sorted(self._callbacks.items())
        for name, fam in families:
            samples = []
            for key, child in fam.children():
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    sample = {
                        "labels": labels, "count": child.count,
                        "sum": child.sum,
                        "buckets": {("+Inf" if b == float("inf") else b): c
                                    for b, c in child.buckets().items()},
                    }
                    exs = child.exemplars() if child._ex_on else {}
                    if exs:
                        sample["exemplars"] = {
                            ("+Inf" if b == float("inf") else b):
                            {"labels": dict(pairs), "value": v}
                            for b, (pairs, v) in exs.items()}
                    samples.append(sample)
                else:
                    samples.append({"labels": labels, "value": child.value})
            out[name] = {"kind": fam.kind, "samples": samples}
        for name, (_doc, kind, fn) in callbacks:
            out[name] = {"kind": kind, "samples": [
                {"labels": labels, "value": value}
                for labels, value in self._callback_samples(fn)]}
        return out


# --------------------------------------------------------------------- #
# process-default registry                                              #
# --------------------------------------------------------------------- #

_DEFAULT: "MetricsRegistry | None" = None
_DEFAULT_LOCK = make_lock("metrics._DEFAULT_LOCK")


def _default_enabled() -> bool:
    try:
        from ..core.config import get_config

        return str(get_config("metrics.enabled", "true")).lower() not in (
            "false", "0", "no", "off")
    except Exception:
        return True


def get_registry() -> MetricsRegistry:
    """The process-default registry — what `/metrics` scrapes. Telemetry
    defaults on; MMLSPARK_TPU_METRICS__ENABLED=false starts it disabled."""
    global _DEFAULT
    reg = _DEFAULT
    if reg is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MetricsRegistry(enabled=_default_enabled())
            reg = _DEFAULT
    return reg


def set_default_registry(reg: "MetricsRegistry | None") -> "MetricsRegistry | None":
    """Swap the process-default registry (tests); returns the previous one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        old, _DEFAULT = _DEFAULT, reg
    return old


def set_enabled(on: bool) -> None:
    """Toggle the process-default registry's no-op fast path."""
    get_registry().set_enabled(on)
