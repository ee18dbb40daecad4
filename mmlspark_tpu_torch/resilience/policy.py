"""RetryPolicy: one retry semantics for the whole package.

A copy of mmlspark_tpu/resilience/policy.py.

Reference: HTTPClients.scala:64-105 — retry on 429/5xx/connection errors,
honor Retry-After, back off between attempts. The reference hard-codes a
ladder; production retry guidance since then converged on exponential
backoff with *decorrelated jitter* (each delay drawn uniformly from
[base, prev*3]) plus a *total deadline budget* so a retrying caller can
never exceed its own SLA. Both are seedable and run against an injectable
clock, so every backoff schedule in the test suite is deterministic and
costs zero wall-clock time.

Failure classification lives here too: the line between "retry this"
(429/408/5xx, connection-class errors) and "fail fast" (other 4xx,
programming errors like TypeError) was previously re-decided — slightly
differently — at each of the three call sites this module replaces.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Sequence, TypeVar

R = TypeVar("R")

__all__ = [
    "Clock", "SystemClock", "FakeClock", "SYSTEM_CLOCK",
    "RetryPolicy", "RetrySession", "RetryBudgetExceeded",
    "is_retryable_status", "is_retryable_exception", "is_fatal_exception",
]


# -- clocks ---------------------------------------------------------------- #


class Clock:
    """Time source + sleeper. Everything in resilience (and the modules it
    wires into) waits through one of these, never `time.sleep` directly —
    that single rule is what lets tier-1 run the whole fault matrix with
    zero real sleeps."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            # runtime R3 hook: a real sleep while holding a sanitized
            # lock is reported (lazy import; free when the sanitizer is
            # off or no sanitized locks are held)
            from ..observability.sanitizer import note_blocking

            note_blocking("sleep")
            time.sleep(seconds)


class FakeClock(Clock):
    """Deterministic test clock: sleep() advances time instantly and
    records the request, so tests assert on the exact backoff schedule."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self.sleeps: list[float] = []

    def monotonic(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(float(seconds))
        self._now += max(float(seconds), 0.0)

    def advance(self, seconds: float) -> None:
        self._now += float(seconds)


SYSTEM_CLOCK = SystemClock()


# -- classification -------------------------------------------------------- #

# status 0 is this package's connection-failure sentinel
# (HTTPResponseData with no HTTP-level answer)
_RETRYABLE_EXTRA = frozenset({0, 408, 429})

# programming errors don't heal with time — retrying them burns the budget
# and hides the bug
_FATAL_EXCEPTIONS = (TypeError, ValueError, KeyError, AttributeError,
                     AssertionError, NotImplementedError)


def is_retryable_status(code: int) -> bool:
    """429/408/5xx/connection-sentinel — the reference's retry set
    (HTTPClients.scala:64-105) plus request-timeout."""
    return code in _RETRYABLE_EXTRA or 500 <= code < 600


def is_fatal_exception(exc: BaseException) -> bool:
    return isinstance(exc, _FATAL_EXCEPTIONS)


def is_retryable_exception(exc: BaseException) -> bool:
    return isinstance(exc, Exception) and not is_fatal_exception(exc)


class RetryBudgetExceeded(RuntimeError):
    """Raised by RetryPolicy.call when every attempt failed."""


def _count_exhausted(reason: str) -> None:
    """Count a spent retry budget by its limiting constraint ("retries" or
    "deadline"). Cold path only; telemetry stays optional."""
    try:
        from ..observability.metrics import get_registry

        get_registry().counter(
            "mmlspark_tpu_resilience_retry_exhausted_total",
            "retry budgets exhausted, by limiting constraint",
            labels=("reason",)).labels(reason=reason).inc()
    except Exception:
        pass


# -- policy ---------------------------------------------------------------- #


class RetryPolicy:
    """Declarative retry schedule; `session()` mints the per-call state.

    max_retries    retries AFTER the first attempt (None: 3, or the ladder
                   length when `backoffs_ms` is given)
    backoffs_ms    explicit delay ladder (legacy HTTPClients.scala mode);
                   overrides base/jitter
    jitter         "decorrelated" (default), "equal", or "none" (pure
                   exponential doubling)
    total_deadline_ms  hard budget across all backoff sleeps — a session
                   refuses to retry past it and clips its last sleep to it
    retry_after_cap_s  upper bound honored for server Retry-After hints
    seed           seeds the jitter RNG (None = entropy)
    """

    def __init__(
        self,
        max_retries: "int | None" = None,
        *,
        base_ms: float = 100.0,
        max_ms: float = 10_000.0,
        multiplier: float = 3.0,
        backoffs_ms: "Sequence[float] | None" = None,
        jitter: str = "decorrelated",
        total_deadline_ms: "float | None" = None,
        retry_after_cap_s: float = 30.0,
        seed: "int | None" = None,
        clock: Clock = SYSTEM_CLOCK,
    ):
        if jitter not in ("decorrelated", "equal", "none"):
            raise ValueError(f"unknown jitter mode {jitter!r}")
        if max_retries is None:
            max_retries = len(backoffs_ms) if backoffs_ms is not None else 3
        self.max_retries = int(max_retries)
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)
        self.multiplier = float(multiplier)
        self.backoffs_ms = list(backoffs_ms) if backoffs_ms is not None else None
        self.jitter = jitter
        self.total_deadline_ms = total_deadline_ms
        self.retry_after_cap_s = float(retry_after_cap_s)
        self.seed = seed
        self.clock = clock

    def session(self) -> "RetrySession":
        return RetrySession(self)

    def call(
        self,
        fn: Callable[[], R],
        retryable: "Callable[[Exception], bool] | None" = None,
    ) -> R:
        """Run fn under this policy; raises RetryBudgetExceeded (chaining
        the last error) when the budget runs out. Non-retryable errors
        propagate immediately."""
        sess = self.session()
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified below
                ok_to_retry = (retryable(e) if retryable is not None
                               else is_retryable_exception(e))
                if not ok_to_retry:
                    raise
                if not sess.should_retry():
                    _count_exhausted(
                        "retries" if sess.attempt >= self.max_retries
                        else "deadline")
                    raise RetryBudgetExceeded(
                        f"all retries failed: {e}") from e
                sess.backoff()


class RetrySession:
    """Mutable per-call-sequence state: attempt counter, decorrelated-jitter
    chain, deadline. One session per logical operation; policies are
    shareable and immutable in spirit."""

    def __init__(self, policy: RetryPolicy):
        self.policy = policy
        self.attempt = 0          # backoffs taken so far
        self.slept_s = 0.0
        self._prev_s = policy.base_ms / 1e3
        self._rng = random.Random(policy.seed)
        self._deadline = (
            policy.clock.monotonic() + policy.total_deadline_ms / 1e3
            if policy.total_deadline_ms is not None else None
        )

    def should_retry(self) -> bool:
        if self.attempt >= self.policy.max_retries:
            return False
        if self._deadline is not None and \
                self.policy.clock.monotonic() >= self._deadline:
            return False
        return True

    def next_delay_s(self, retry_after_s: "float | None" = None) -> float:
        """Compute (and consume) the next backoff delay. A server-supplied
        Retry-After wins over the schedule but is capped — an adversarial
        `Retry-After: 1e9` must not park the thread forever."""
        p = self.policy
        i = self.attempt
        self.attempt += 1
        if retry_after_s is not None:
            d = min(max(float(retry_after_s), 0.0), p.retry_after_cap_s)
        elif p.backoffs_ms is not None:
            d = p.backoffs_ms[min(i, len(p.backoffs_ms) - 1)] / 1e3
        elif p.jitter == "decorrelated":
            d = min(p.max_ms / 1e3,
                    self._rng.uniform(p.base_ms / 1e3,
                                      self._prev_s * p.multiplier))
            self._prev_s = d
        elif p.jitter == "equal":
            b = min(p.max_ms / 1e3, (p.base_ms / 1e3) * (2.0 ** i))
            d = b / 2 + self._rng.uniform(0.0, b / 2)
        else:  # "none": pure exponential
            d = min(p.max_ms / 1e3, (p.base_ms / 1e3) * (2.0 ** i))
        if self._deadline is not None:
            d = min(d, max(self._deadline - p.clock.monotonic(), 0.0))
        return d

    def backoff(
        self,
        retry_after_s: "float | None" = None,
        wait: "Callable[[float], None] | None" = None,
    ) -> float:
        """Sleep out the next delay (through the policy clock, or a caller
        wait such as Event.wait for interruptible backoff); returns it."""
        d = self.next_delay_s(retry_after_s)
        (wait or self.policy.clock.sleep)(d)
        self.slept_s += d
        return d
