"""QuerySupervisor: supervised restarts for streaming queries.

The first StreamingQuery retried a failing batch forever on a fixed
interval. With the batch retry budget now finite (streaming/query.py), a
query whose budget runs dry *terminates* with its exception set — and
this module decides what happens next, playing the role of Spark's
driver-side query restart loop: restart with backoff while the failure
looks transient, escalate (state "failed" + on_failure hook) when the
error is fatal or the restart budget for the rolling window is spent.

Restarting is safe by construction: the WAL makes the planned batch
replay against its recorded offset range and idempotent sinks drop what
a pre-crash attempt already wrote, so a supervised query keeps its
exactly-once guarantee across any number of restarts (the chaos soak
test in tests/test_resilience.py drives this hard).

The supervisor only needs `start/stop/is_active/exception/
batches_processed` from the query, so it supervises StreamingQuery or
anything shaped like it.

A copy of mmlspark_tpu/resilience/supervisor.py (host only). The port
supervises anything shaped like a query or a fleet: `ServingFleet`
(io_http/serving.py) for `PartitionSupervisor`, and `TuneHyperparameters`
(automl/tune.py) takes `RestartPolicy` for its trial retries; the port's
streaming queries are ROADMAP item 15.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable

from ..observability.sanitizer import make_lock
from .policy import (Clock, RetryPolicy, SYSTEM_CLOCK, is_fatal_exception)

__all__ = ["RestartPolicy", "QuerySupervisor", "PartitionSupervisor"]


class RestartPolicy:
    """When (and how fast) a died query may be restarted.

    max_restarts   restarts allowed within any rolling `window_s`
    backoff        RetryPolicy shaping the delay before each restart (the
                   session resets once a restarted query makes progress,
                   so a long-lived query doesn't creep toward max_ms)
    fatal          extra classifier: exception -> bool escalating straight
                   to failed (stacked on policy.is_fatal_exception)
    """

    def __init__(
        self,
        max_restarts: int = 3,
        window_s: float = 300.0,
        backoff: "RetryPolicy | None" = None,
        fatal: "Callable[[BaseException], bool] | None" = None,
    ):
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self.backoff = backoff if backoff is not None else RetryPolicy(
            max_retries=max(self.max_restarts, 1),
            base_ms=100.0, max_ms=30_000.0, seed=0)
        self.fatal = fatal

    def is_fatal(self, exc: BaseException) -> bool:
        if self.fatal is not None and self.fatal(exc):
            return True
        return is_fatal_exception(exc)


class QuerySupervisor:
    """Monitor thread over one query: restart on transient death, escalate
    on fatal errors or an exhausted restart budget.

    States: "initialized" -> "running" -> ("stopped" | "failed").
    on_restart(query, exc, n_restarts) fires before each restart;
    on_failure(query, exc) fires once on escalation."""

    def __init__(
        self,
        query: Any,
        policy: "RestartPolicy | None" = None,
        *,
        on_restart: "Callable | None" = None,
        on_failure: "Callable | None" = None,
        poll_interval_s: float = 0.02,
        clock: Clock = SYSTEM_CLOCK,
        metrics: Any = None,
    ):
        self.query = query
        self._metrics = metrics
        self.policy = policy if policy is not None else RestartPolicy()
        self.on_restart = on_restart
        self.on_failure = on_failure
        self.poll_interval_s = poll_interval_s
        self.clock = clock
        self.state = "initialized"
        self.restarts = 0
        self.last_exception: "BaseException | None" = None
        self._restart_times: collections.deque[float] = collections.deque()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        # guards state/restarts/last_exception: written by the monitor
        # thread, read and written by start()/stop() callers
        self._state_lock = make_lock("QuerySupervisor._state_lock")

    def _set_state(self, s: str) -> None:
        with self._state_lock:
            self.state = s

    def _count_restart(self) -> None:
        """Supervised restarts, labeled by query name. The counter lives in
        the registry, so the tally survives the query object's death/rebirth
        cycle (the query itself restarts from scratch)."""
        try:
            from ..observability.metrics import get_registry

            reg = self._metrics if self._metrics is not None else get_registry()
            reg.counter(
                "mmlspark_tpu_streaming_restarts_total",
                "supervised query restarts",
                labels=("query",)).labels(
                    query=getattr(self.query, "name", "query")).inc()
        except Exception:
            pass

    def _flight_record(self, action: str, exc: "BaseException | None",
                       dump_trigger: "str | None" = None,
                       force: bool = False) -> None:
        """Restart/escalation transitions land in the process black box;
        `dump_trigger` additionally dumps the ring (restarts respect the
        recorder's cooldown, escalation forces — it is terminal)."""
        try:
            from ..observability.recorder import get_recorder

            rec = get_recorder()
            rec.record_transition(
                "supervisor", action,
                query=getattr(self.query, "name", "query"),
                restarts=self.restarts,
                error=(f"{type(exc).__name__}: {exc}" if exc else None))
            if dump_trigger is not None:
                rec.trigger_dump(dump_trigger, force=force)
        except Exception:  # noqa: BLE001 — telemetry never blocks recovery
            pass

    # -- lifecycle ------------------------------------------------------- #

    def start(self) -> "QuerySupervisor":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("supervisor is already running")
        self._stop.clear()
        self._set_state("running")
        self.query.start()
        self._thread = threading.Thread(
            target=self._monitor, name="query-supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.query.stop()
        with self._state_lock:
            if self.state == "running":
                self.state = "stopped"

    def await_terminal(self, timeout_s: "float | None" = None) -> bool:
        """Block until the supervisor leaves "running" (or timeout)."""
        if self._thread is None:
            return True
        self._thread.join(timeout_s)
        return not self._thread.is_alive()

    # -- the monitor loop ------------------------------------------------ #

    def _restart_allowed(self) -> bool:
        now = self.clock.monotonic()
        while self._restart_times and \
                now - self._restart_times[0] > self.policy.window_s:
            self._restart_times.popleft()
        return len(self._restart_times) < self.policy.max_restarts

    def _monitor(self) -> None:
        sess = None
        batches_at_restart = self.query.batches_processed
        while not self._stop.is_set():
            if self.query.is_active:
                self._stop.wait(self.poll_interval_s)
                continue
            if self._stop.is_set():
                break
            exc = self.query.exception
            with self._state_lock:
                self.last_exception = exc
            if exc is None:
                # clean exit (someone stopped the query directly)
                self._set_state("stopped")
                return
            if self.policy.is_fatal(exc) or not self._restart_allowed():
                self._set_state("failed")
                self._flight_record("escalate", exc,
                                    dump_trigger="restart", force=True)
                if self.on_failure is not None:
                    self.on_failure(self.query, exc)
                return
            # progress since the last restart means the previous failure
            # streak healed: restart the backoff chain
            if sess is None or \
                    self.query.batches_processed > batches_at_restart:
                sess = self.policy.backoff.session()
            if not sess.should_retry():
                self._set_state("failed")
                self._flight_record("escalate", exc,
                                    dump_trigger="restart", force=True)
                if self.on_failure is not None:
                    self.on_failure(self.query, exc)
                return
            # interruptible backoff: a stop() during the wait wins
            sess.backoff(wait=self._stop.wait)
            if self._stop.is_set():
                break
            self._restart_times.append(self.clock.monotonic())
            with self._state_lock:
                self.restarts += 1
            self._count_restart()
            self._flight_record("restart", exc, dump_trigger="restart")
            batches_at_restart = self.query.batches_processed
            if self.on_restart is not None:
                self.on_restart(self.query, exc, self.restarts)
            self.query.start()
        self._set_state("stopped")


class PartitionSupervisor:
    """Monitor thread over a partition-worker fleet: respawn dead worker
    processes within the RestartPolicy budget, escalate when it runs dry.

    The driver loop already heals lazily (a send hitting a dead worker
    triggers respawn + state re-push), but that only fires when a batch
    is in flight — this supervisor closes the gap for idle streams, so a
    worker that dies between batches is back before the next one needs
    it. Restart safety is the same argument as QuerySupervisor's: a
    respawned worker holds NO state and answers `need_state`, the driver
    re-pushes the last committed snapshot, and exactly-once holds.

    Only needs `dead_slots()/respawn(slot)` from the fleet, so it
    supervises ServingFleet or anything shaped like it."""

    def __init__(
        self,
        fleet: Any,
        policy: "RestartPolicy | None" = None,
        *,
        name: str = "partitions",
        on_respawn: "Callable | None" = None,
        on_failure: "Callable | None" = None,
        poll_interval_s: float = 0.2,
        clock: Clock = SYSTEM_CLOCK,
        metrics: Any = None,
    ):
        self.fleet = fleet
        self.policy = policy if policy is not None else RestartPolicy()
        self.name = name
        self.on_respawn = on_respawn
        self.on_failure = on_failure
        self.poll_interval_s = poll_interval_s
        self.clock = clock
        self._metrics = metrics
        self.state = "initialized"
        self.respawns = 0
        self.last_exception: "BaseException | None" = None
        self._respawn_times: collections.deque[float] = collections.deque()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        # guards state/respawns/last_exception: written by the monitor
        # thread, read and written by start()/stop() callers
        self._state_lock = make_lock("PartitionSupervisor._state_lock")

    def _set_state(self, s: str) -> None:
        with self._state_lock:
            self.state = s

    def _count_respawn(self) -> None:
        try:
            from ..observability.metrics import get_registry

            reg = self._metrics if self._metrics is not None \
                else get_registry()
            reg.counter(
                "mmlspark_tpu_streaming_partition_respawns_total",
                "supervised partition-worker respawns",
                labels=("query",)).labels(query=self.name).inc()
        except Exception:  # noqa: BLE001 — telemetry never blocks recovery
            pass

    def _flight_record(self, action: str, slot: "int | None" = None,
                       exc: "BaseException | None" = None,
                       dump_trigger: "str | None" = None,
                       force: bool = False) -> None:
        try:
            from ..observability.recorder import get_recorder

            rec = get_recorder()
            rec.record_transition(
                "partition-supervisor", action, query=self.name,
                slot=slot, respawns=self.respawns,
                error=(f"{type(exc).__name__}: {exc}" if exc else None))
            if dump_trigger is not None:
                rec.trigger_dump(dump_trigger, force=force)
        except Exception:  # noqa: BLE001
            pass

    def _respawn_allowed(self) -> bool:
        now = self.clock.monotonic()
        while self._respawn_times and \
                now - self._respawn_times[0] > self.policy.window_s:
            self._respawn_times.popleft()
        return len(self._respawn_times) < self.policy.max_restarts

    def start(self) -> "PartitionSupervisor":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("supervisor is already running")
        self._stop.clear()
        self._set_state("running")
        self._thread = threading.Thread(
            target=self._monitor, name=f"partition-supervisor-{self.name}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._state_lock:
            if self.state == "running":
                self.state = "stopped"

    def _monitor(self) -> None:
        while not self._stop.is_set():
            try:
                dead = list(self.fleet.dead_slots())
            except Exception:  # noqa: BLE001 — fleet mid-stop
                dead = []
            for slot in dead:
                if self._stop.is_set():
                    break
                if not self._respawn_allowed():
                    self._set_state("failed")
                    self._flight_record("escalate", slot=slot,
                                        exc=self.last_exception,
                                        dump_trigger="restart", force=True)
                    if self.on_failure is not None:
                        self.on_failure(self.fleet, slot)
                    return
                try:
                    self.fleet.respawn(slot)
                except Exception as e:  # noqa: BLE001 — retried next poll
                    with self._state_lock:
                        self.last_exception = e
                    continue
                self._respawn_times.append(self.clock.monotonic())
                with self._state_lock:
                    self.respawns += 1
                self._count_respawn()
                self._flight_record("respawn", slot=slot,
                                    dump_trigger="restart")
                if self.on_respawn is not None:
                    self.on_respawn(self.fleet, slot, self.respawns)
            self._stop.wait(self.poll_interval_s)
        self._set_state("stopped")
