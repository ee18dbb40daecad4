"""Per-endpoint circuit breakers.

A copy of mmlspark_tpu/resilience/breaker.py.

A retrying client pointed at a dead dependency still burns its full
backoff budget per request — at serving concurrency that multiplies a
dependency outage into a thread-pool outage. The breaker caps the blast
radius: after the rolling failure rate crosses the threshold the circuit
opens and calls fail immediately (CircuitOpenError / synthetic 503), then
a half-open probe window readmits traffic once the dependency heals.

State machine (closed -> open -> half-open -> closed) is driven entirely
by the injected Clock, so tests walk the full cycle deterministically
with zero real waiting.
"""

from __future__ import annotations

import collections
import threading
import urllib.parse
from typing import Any, Callable, TypeVar

from ..observability.sanitizer import make_lock
from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage
from .policy import Clock, SYSTEM_CLOCK

R = TypeVar("R")

__all__ = ["CircuitOpenError", "CircuitBreaker", "BreakerRegistry",
           "CircuitBreakerTransformer", "ensure_metrics", "STATE_VALUES"]


# numeric encoding of the breaker state gauge (closed < half_open < open,
# so the fleet "max" merge policy surfaces the worst replica's state)
STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


def ensure_metrics(registry=None):
    """Declare the breaker telemetry families on `registry` (process
    default when None) and return (transitions, shed, state). Idempotent;
    ServingServer calls this at construction so the series render from
    `/metrics` before any breaker ever trips."""
    from ..observability.metrics import get_registry

    reg = registry if registry is not None else get_registry()
    transitions = reg.counter(
        "mmlspark_tpu_resilience_breaker_transitions_total",
        "breaker state transitions, labeled by destination state",
        labels=("breaker", "to"))
    shed = reg.counter(
        "mmlspark_tpu_resilience_breaker_shed_total",
        "calls refused while the circuit was open or probing",
        labels=("breaker",))
    state = reg.gauge(
        "mmlspark_tpu_resilience_breaker_state_count",
        "breaker state (0 closed, 1 half_open, 2 open)",
        labels=("breaker",))
    return transitions, shed, state


class CircuitOpenError(RuntimeError):
    """Raised when a call is refused because the circuit is open."""

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(
            f"circuit {name or 'breaker'!s} is open; "
            f"retry in {retry_after_s:.3f}s")
        self.name = name
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """Rolling-window failure-rate breaker. Thread-safe.

    closed     outcomes recorded into a rolling window of size `window`;
               once it holds >= `min_calls` outcomes and the failure rate
               reaches `failure_rate_threshold`, the circuit opens
    open       allow() is False for `open_duration_s`, then half-open
    half-open  up to `half_open_max_calls` probes admitted; one success
               closes the circuit (window reset), one failure re-opens it
    """

    def __init__(
        self,
        name: str = "",
        failure_rate_threshold: float = 0.5,
        window: int = 20,
        min_calls: int = 10,
        open_duration_s: float = 30.0,
        half_open_max_calls: int = 1,
        clock: Clock = SYSTEM_CLOCK,
        metrics: Any = None,
    ):
        self.name = name
        self.failure_rate_threshold = float(failure_rate_threshold)
        self.window = int(window)
        self.min_calls = int(min_calls)
        self.open_duration_s = float(open_duration_s)
        self.half_open_max_calls = int(half_open_max_calls)
        self.clock = clock
        self._lock = make_lock("CircuitBreaker._lock")
        self._outcomes: collections.deque[bool] = collections.deque(
            maxlen=self.window)
        self._state = "closed"
        self._opened_at = 0.0
        self._probes = 0          # half-open calls admitted, not yet resolved
        self.times_opened = 0
        self.calls_shed = 0
        # labeled counter children, resolved once; telemetry stays optional
        try:
            transitions, shed, state = ensure_metrics(metrics)
            label = self.name or "breaker"
            self._m_to = {
                to: transitions.labels(breaker=label, to=to)
                for to in ("open", "half_open", "closed")}
            self._m_shed = shed.labels(breaker=label)
            self._m_state = state.labels(breaker=label)
            self._m_state.set(STATE_VALUES[self._state])
        except Exception:
            self._m_to = {}
            self._m_shed = None
            self._m_state = None

    def _transitioned(self, to: str) -> None:
        child = self._m_to.get(to)
        if child is not None:
            child.inc()
        if self._m_state is not None:
            self._m_state.set(STATE_VALUES.get(to, 0))
        try:
            from ..observability.recorder import get_recorder

            get_recorder().record_transition(
                "breaker", to, breaker=self.name or "breaker")
        except Exception:  # noqa: BLE001 — telemetry stays optional
            pass

    # -- state ---------------------------------------------------------- #

    def _tick(self) -> None:
        """open -> half-open once the cool-off elapses (lazy: no timer
        thread, the transition happens on the next observation)."""
        if self._state == "open" and \
                self.clock.monotonic() - self._opened_at >= self.open_duration_s:
            self._state = "half_open"
            self._probes = 0
            self._transitioned("half_open")

    @property
    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    def retry_after_s(self) -> float:
        """Remaining cool-off; 0 when not open."""
        with self._lock:
            self._tick()
            if self._state != "open":
                return 0.0
            return max(
                self._opened_at + self.open_duration_s - self.clock.monotonic(),
                0.0)

    def failure_rate(self) -> float:
        with self._lock:
            if not self._outcomes:
                return 0.0
            return 1.0 - sum(self._outcomes) / len(self._outcomes)

    # -- admission + outcomes ------------------------------------------- #

    def allow(self) -> bool:
        with self._lock:
            self._tick()
            if self._state == "closed":
                return True
            if self._state == "half_open" and \
                    self._probes < self.half_open_max_calls:
                self._probes += 1
                return True
            self.calls_shed += 1
            if self._m_shed is not None:
                self._m_shed.inc()
            return False

    def record_success(self) -> None:
        with self._lock:
            self._tick()
            if self._state == "half_open":
                # the dependency healed: close and forget the bad window
                self._state = "closed"
                self._outcomes.clear()
                self._transitioned("closed")
                return
            self._outcomes.append(True)

    def record_failure(self) -> None:
        with self._lock:
            self._tick()
            if self._state == "half_open":
                self._open()
                return
            self._outcomes.append(False)
            if self._state == "closed" and \
                    len(self._outcomes) >= self.min_calls:
                rate = 1.0 - sum(self._outcomes) / len(self._outcomes)
                if rate >= self.failure_rate_threshold:
                    self._open()

    def _open(self) -> None:
        self._state = "open"
        self._opened_at = self.clock.monotonic()
        self._probes = 0
        self.times_opened += 1
        self._outcomes.clear()
        self._transitioned("open")

    def call(self, fn: Callable[[], R]) -> R:
        """Guarded invocation: CircuitOpenError while open, outcome
        recorded either way."""
        if not self.allow():
            raise CircuitOpenError(self.name, self.retry_after_s())
        try:
            out = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out


class BreakerRegistry:
    """One breaker per endpoint (scheme://netloc) — the unit at which a
    dependency fails. Thread-safe; `**breaker_kw` templates new entries."""

    def __init__(self, clock: Clock = SYSTEM_CLOCK, **breaker_kw: Any):
        self._breakers: dict[str, CircuitBreaker] = {}
        self._lock = make_lock("BreakerRegistry._lock")
        self._clock = clock
        self._kw = breaker_kw

    @staticmethod
    def endpoint_key(url: str) -> str:
        u = urllib.parse.urlsplit(url)
        return f"{u.scheme}://{u.netloc}" if u.netloc else url

    def breaker_for(self, url: str) -> CircuitBreaker:
        key = self.endpoint_key(url)
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = CircuitBreaker(name=key, clock=self._clock, **self._kw)
                self._breakers[key] = br
            return br

    def states(self) -> dict[str, str]:
        with self._lock:
            items = list(self._breakers.items())
        return {k: br.state for k, br in items}


@register_stage
class CircuitBreakerTransformer(Transformer):
    """Wrap any transformer stage with a circuit breaker.

    While open, `open_mode` decides the fallback: "raise" surfaces
    CircuitOpenError (a supervisor/retry layer above deals with it);
    "passthrough" returns the input table untouched — the degraded-mode
    answer for enrichment stages whose output is optional."""

    inner = Param(None, "wrapped transformer stage", required=True)
    failure_rate_threshold = Param(0.5, "failure rate that opens", ptype=float)
    window = Param(8, "rolling outcome window (calls)", ptype=int)
    min_calls = Param(4, "outcomes required before opening", ptype=int)
    open_duration_s = Param(30.0, "cool-off before half-open (s)", ptype=float)
    open_mode = Param("raise", "'raise' or 'passthrough' while open", ptype=str)

    clock: Clock = SYSTEM_CLOCK  # injectable for deterministic tests
    _breaker: "CircuitBreaker | None" = None

    @property
    def breaker(self) -> CircuitBreaker:
        if self._breaker is None:
            self._breaker = CircuitBreaker(
                name=type(self.get("inner")).__name__,
                failure_rate_threshold=self.get("failure_rate_threshold"),
                window=self.get("window"),
                min_calls=self.get("min_calls"),
                open_duration_s=self.get("open_duration_s"),
                clock=self.clock,
            )
        return self._breaker

    def _transform(self, table: Table) -> Table:
        br = self.breaker
        if not br.allow():
            if self.get("open_mode") == "passthrough":
                return table
            raise CircuitOpenError(br.name, br.retry_after_s())
        try:
            out = self.get("inner").transform(table)
        except Exception:
            br.record_failure()
            raise
        br.record_success()
        return out

    # nested-stage serialization (same contract as MultiColumnAdapter)
    def _save_state(self) -> dict[str, Any]:
        return {"inner": self.get("inner")}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(inner=state["inner"])

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("inner", None)
        return d
