"""Deterministic fault injection — the test backbone of the resilience
layer.

A resilience claim that was never exercised is a hope, not a property.
`FaultInjector` wraps the seams the rest of the package defends —
HTTP senders, serving handlers, streaming sources and sinks — and injects
status-code bursts, latency spikes, connection drops, and mid-batch
exceptions from a seeded RNG: the same seed always produces the same
fault schedule, so chaos tests are exactly reproducible and latency
spikes flow through the injectable Clock (zero real sleeps in tier-1).

`ChaosTransformer` is the pipeline-stage face of the same idea: drop it
into any Pipeline to make batch N raise on a deterministic schedule —
how the streaming soak test crashes a query mid-stream on purpose.

A copy of mmlspark_tpu/resilience/chaos.py.
"""

from __future__ import annotations

import random
from typing import Any, Callable

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage
from .policy import Clock, SYSTEM_CLOCK

__all__ = ["ChaosError", "FaultInjector", "ChaosTransformer"]


class ChaosError(RuntimeError):
    """An injected (non-fatal, retryable) fault."""


class ChaosConnectionError(ConnectionError):
    """An injected connection drop."""


class FaultInjector:
    """Seeded fault source with wrap_* adapters for each seam.

    status_prob     probability a call answers with `status_code` instead
                    of reaching the wrapped sender; bursts of
                    `status_burst` consecutive faults (5xx storms arrive
                    in runs, not as isolated coin flips)
    latency_prob    probability a call first sleeps `latency_s` on the
                    injector's clock
    drop_prob       probability of a connection-level failure
    exception_prob  probability a wrapped handler/source/sink raises
                    ChaosError mid-batch
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        status_prob: float = 0.0,
        status_code: int = 503,
        status_burst: int = 1,
        retry_after_s: "float | None" = None,
        latency_prob: float = 0.0,
        latency_s: float = 0.0,
        drop_prob: float = 0.0,
        exception_prob: float = 0.0,
        clock: Clock = SYSTEM_CLOCK,
    ):
        self.seed = seed
        self.status_prob = status_prob
        self.status_code = status_code
        self.status_burst = max(int(status_burst), 1)
        self.retry_after_s = retry_after_s
        self.latency_prob = latency_prob
        self.latency_s = latency_s
        self.drop_prob = drop_prob
        self.exception_prob = exception_prob
        self.clock = clock
        self._rng = random.Random(seed)
        self._burst_left = 0
        self.calls = 0
        self.injected: dict[str, int] = {
            "status": 0, "latency": 0, "drop": 0, "exception": 0}

    # -- the dice ------------------------------------------------------- #

    def _maybe_latency(self) -> None:
        if self.latency_prob and self._rng.random() < self.latency_prob:
            self.injected["latency"] += 1
            self.clock.sleep(self.latency_s)

    def decide(self) -> "str | None":
        """Advance the schedule one call: None, "status", "drop", or
        "exception". Latency is rolled separately (it delays, not fails)."""
        self.calls += 1
        self._maybe_latency()
        if self._burst_left > 0:
            self._burst_left -= 1
            self.injected["status"] += 1
            return "status"
        roll = self._rng.random()
        if roll < self.status_prob:
            self._burst_left = self.status_burst - 1
            self.injected["status"] += 1
            return "status"
        roll -= self.status_prob
        if roll < self.drop_prob:
            self.injected["drop"] += 1
            return "drop"
        roll -= self.drop_prob
        if roll < self.exception_prob:
            self.injected["exception"] += 1
            return "exception"
        return None

    # -- seam adapters --------------------------------------------------- #

    def wrap_send(self, send: Callable) -> Callable:
        """Wrap an http_send-compatible callable: status faults return a
        synthetic response (with optional Retry-After), drops raise a
        ConnectionError, exceptions raise ChaosError."""
        from ..io_http.schema import HTTPResponseData

        def chaotic_send(req, **kw):
            fault = self.decide()
            if fault == "status":
                headers = {}
                if self.retry_after_s is not None:
                    headers["Retry-After"] = str(self.retry_after_s)
                return HTTPResponseData(
                    self.status_code, "chaos: injected status",
                    headers=headers, entity=b"")
            if fault == "drop":
                raise ChaosConnectionError("chaos: connection dropped")
            if fault == "exception":
                raise ChaosError("chaos: injected exception")
            return send(req, **kw)

        return chaotic_send

    def wrap_handler(self, handler: Callable[[Table], Table]) -> Callable:
        """Wrap a serving/streaming handler(Table) -> Table: exceptions and
        status faults both surface as a raised ChaosError (the serving loop
        turns a failed batch into 500s), latency delays the batch."""

        def chaotic_handler(table: Table) -> Table:
            fault = self.decide()
            if fault in ("status", "drop", "exception"):
                raise ChaosError(f"chaos: injected {fault} fault")
            return handler(table)

        return chaotic_handler

    def wrap_source(self, source):
        return _ChaosSource(source, self)

    def wrap_sink(self, sink):
        return _ChaosSink(sink, self)


class _ChaosSource:
    """Source proxy: get_batch fails on the injector's schedule; offset
    bookkeeping passes through untouched so replay stays exact."""

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    def get_batch(self, start, end):
        fault = self.injector.decide()
        if fault == "drop":
            raise ChaosConnectionError("chaos: source connection dropped")
        if fault in ("status", "exception"):
            raise ChaosError("chaos: source read failed")
        return self.inner.get_batch(start, end)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class _ChaosSink:
    """Sink proxy: add_batch fails on the injector's schedule BEFORE the
    inner write, so a fault never half-writes a batch."""

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    def add_batch(self, batch_id, table):
        fault = self.injector.decide()
        if fault in ("status", "drop", "exception"):
            raise ChaosError("chaos: sink write failed")
        return self.inner.add_batch(batch_id, table)

    def __getattr__(self, name):
        return getattr(self.inner, name)


@register_stage
class ChaosTransformer(Transformer):
    """Fault-injecting pass-through stage.

    `fail_calls` pins exact transform-call indexes that raise (the
    deterministic hammer for crash tests); `exception_prob` draws per-call
    from a seeded RNG; `latency_ms` sleeps on the stage clock first. The
    call counter is runtime state: it restarts at 0 in a fresh process,
    which is exactly what a kill-restart test wants."""

    seed = Param(0, "RNG seed for probabilistic faults", ptype=int)
    exception_prob = Param(0.0, "per-call probability of raising", ptype=float)
    fail_calls = Param(None, "explicit call indexes that raise",
                       ptype=(list, tuple))
    latency_prob = Param(0.0, "per-call probability of added latency",
                         ptype=float)
    latency_ms = Param(0.0, "injected latency per spike (ms)", ptype=float)

    clock: Clock = SYSTEM_CLOCK
    _calls: int = 0
    _rng: "random.Random | None" = None

    def _transform(self, table: Table) -> Table:
        if self._rng is None:
            self._rng = random.Random(self.get("seed"))
        i = self._calls
        self._calls += 1
        if self.get("latency_prob") and \
                self._rng.random() < self.get("latency_prob"):
            self.clock.sleep(self.get("latency_ms") / 1e3)
        fail_calls = self.get("fail_calls")
        if fail_calls is not None and i in fail_calls:
            raise ChaosError(f"chaos: injected failure on call {i}")
        if self.get("exception_prob") and \
                self._rng.random() < self.get("exception_prob"):
            raise ChaosError(f"chaos: injected failure on call {i}")
        return table
