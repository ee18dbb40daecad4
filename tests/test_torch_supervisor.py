"""The port's supervisors (resilience/supervisor.py) held against the JAX
package's: tests/test_resilience.py's QuerySupervisor cases and
tests/test_partition.py's PartitionSupervisor cases, each run in both
packages on the same scripted query or stub fleet, with the same outcome
(state, restarts, respawns, hooks). The port's streaming queries are a
later slice, so the query here is a scripted object shaped like one
(`start/stop/is_active/exception/batches_processed`), which is all the
supervisor reads.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu import resilience as jax_resilience  # noqa: E402
from mmlspark_tpu_torch import resilience  # noqa: E402

PACKAGES = {"port": resilience, "jax": jax_resilience}


class ScriptedQuery:
    """Runs batches on a thread; batch `i` raises `failures[i]` (an
    exception type) the number of times listed, then succeeds. A raising
    batch kills the query, as a spent batch retry budget does."""

    def __init__(self, failures: dict, n_batches: int = 4):
        self.failures = {k: list(v) for k, v in failures.items()}
        self.n_batches = n_batches
        self.batches_processed = 0
        self.exception = None
        self.starts = 0
        self._stop = threading.Event()
        self._thread = None

    @property
    def is_active(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        self.starts += 1
        self.exception = None
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            b = self.batches_processed
            pending = self.failures.get(b)
            if pending:
                self.exception = pending.pop(0)(f"batch {b} failed")
                return
            if b < self.n_batches:
                self.batches_processed += 1
            time.sleep(0.001)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _fast_policy(pkg, max_restarts=10, **kw):
    kw.setdefault("window_s", 1e6)
    return pkg.RestartPolicy(max_restarts=max_restarts,
                             backoff=pkg.RetryPolicy(max_retries=max_restarts,
                                                     backoffs_ms=[0.0]), **kw)


def _wait_until(pred, timeout_s=10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _both(run):
    out = {name: run(pkg) for name, pkg in PACKAGES.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


class TestQuerySupervisor:
    def test_restart_heals_a_transient_failure_streak(self):
        def run(pkg):
            q = ScriptedQuery({1: [IOError, IOError]})
            restarts = []
            sup = pkg.QuerySupervisor(q, _fast_policy(pkg), poll_interval_s=0.002,
                                      on_restart=lambda query, exc, n: restarts.append(
                                          type(exc).__name__))
            sup.start()
            try:
                assert _wait_until(lambda: q.batches_processed >= 4)
                state = sup.state
            finally:
                sup.stop()
            return state, sup.restarts, restarts, sup.state

        assert _both(run) == ("running", 2, ["OSError", "OSError"], "stopped")

    def test_escalates_when_restart_budget_is_spent(self):
        def run(pkg):
            q = ScriptedQuery({0: [IOError] * 1000})
            failures = []
            sup = pkg.QuerySupervisor(q, _fast_policy(pkg, max_restarts=2),
                                      poll_interval_s=0.002,
                                      on_failure=lambda query, exc: failures.append(
                                          type(exc).__name__))
            sup.start()
            try:
                assert sup.await_terminal(timeout_s=10)
            finally:
                sup.stop()
            return sup.state, sup.restarts, failures

        assert _both(run) == ("failed", 2, ["OSError"])

    def test_fatal_error_escalates_without_restarting(self):
        def run(pkg):
            q = ScriptedQuery({0: [ValueError] * 1000})
            sup = pkg.QuerySupervisor(q, _fast_policy(pkg), poll_interval_s=0.002)
            sup.start()
            try:
                assert sup.await_terminal(timeout_s=10)
            finally:
                sup.stop()
            return sup.state, sup.restarts, type(sup.last_exception).__name__

        assert _both(run) == ("failed", 0, "ValueError")

    def test_custom_fatal_classifier_and_user_stop(self):
        def run(pkg):
            q = ScriptedQuery({0: [KeyError]})
            policy = _fast_policy(pkg)
            policy.fatal = lambda exc: isinstance(exc, KeyError)
            sup = pkg.QuerySupervisor(q, policy, poll_interval_s=0.002)
            sup.start()
            try:
                assert sup.await_terminal(timeout_s=10)
            finally:
                sup.stop()
            q2 = ScriptedQuery({})
            sup2 = pkg.QuerySupervisor(q2, _fast_policy(pkg), poll_interval_s=0.002)
            sup2.start()
            assert _wait_until(lambda: q2.batches_processed >= 3)
            sup2.stop()
            with pytest.raises(RuntimeError, match="already running"):
                sup3 = pkg.QuerySupervisor(ScriptedQuery({}), poll_interval_s=0.002).start()
                try:
                    sup3.start()
                finally:
                    sup3.stop()
            return sup.state, sup.restarts, sup2.state, q2.is_active

        assert _both(run) == ("failed", 0, "stopped", False)


class StubFleet:
    def __init__(self):
        self.dead: list = []
        self.respawned: list = []

    def dead_slots(self):
        return list(self.dead)

    def respawn(self, slot):
        self.dead.remove(slot)
        self.respawned.append(slot)
        return f"http://respawned-{slot}/"


class TestPartitionSupervisor:
    def test_respawns_dead_slots(self):
        def run(pkg):
            fleet = StubFleet()
            sup = pkg.PartitionSupervisor(fleet, poll_interval_s=0.01).start()
            try:
                fleet.dead.append(1)
                assert _wait_until(lambda: fleet.respawned == [1], 5)
                running = (sup.respawns, sup.state)
            finally:
                sup.stop()
            return fleet.respawned, fleet.dead, running, sup.state

        assert _both(run) == ([1], [], (1, "running"), "stopped")

    def test_escalates_when_budget_runs_dry(self):
        def run(pkg):
            fleet = StubFleet()
            failures = []
            sup = pkg.PartitionSupervisor(
                fleet, pkg.RestartPolicy(max_restarts=1, window_s=300.0), poll_interval_s=0.01,
                on_failure=lambda f, slot: failures.append(slot)).start()
            try:
                fleet.dead.append(0)
                assert _wait_until(lambda: fleet.respawned == [0], 5)
                fleet.dead.append(0)
                assert _wait_until(lambda: sup.state == "failed", 5)
            finally:
                sup.stop()
            return sup.state, failures, fleet.respawned

        assert _both(run) == ("failed", [0], [0])

    def test_restart_policy_defaults_match(self):
        p, j = resilience.RestartPolicy(), jax_resilience.RestartPolicy()
        assert (p.max_restarts, p.window_s) == (j.max_restarts, j.window_s)
        assert p.is_fatal(ValueError()) == j.is_fatal(ValueError())
        assert p.is_fatal(IOError()) == j.is_fatal(IOError())
