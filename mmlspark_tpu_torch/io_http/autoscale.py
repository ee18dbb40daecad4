"""FleetAutoscaler: SLO-signal-driven replica scaling + self-healing.

The ROADMAP's "autoscaled replica fleet behind a routing gateway" arc:
`SLOEngine.signals()` (observability/slo.py) already distills the fleet
aggregate into the scaling inputs — queue depth, p99 latency, shed rate,
burn rate — and `ServingFleet` grew `scale_to`/`respawn`. This module is
the controller between them:

  * scale UP one replica when any pressure signal crosses its threshold
  * scale DOWN one replica only after `hysteresis_ticks` CONSECUTIVE
    calm ticks — a single quiet sample never sheds capacity
  * a `cooldown_s` window after every scale action blocks further
    scaling in either direction, so up/down cannot flap even when the
    signals oscillate around a threshold
  * self-healing runs BEFORE scaling and OUTSIDE the cooldown: a
    crashed replica (`fleet.dead_slots()`) is respawned immediately —
    healing restores the approved capacity, it does not change it

Everything runs on the injectable clock; chaos tests drive `tick()` by
hand on a FakeClock with zero real waiting.

A copy of mmlspark_tpu/io_http/autoscale.py.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable

from ..observability.sanitizer import make_rlock
from ..resilience.policy import SYSTEM_CLOCK

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Drives `fleet` between `min_replicas` and `max_replicas` from SLO
    signals.

    `signals` is an `SLOEngine` (its `.signals()` is polled after an
    `.evaluate()` refresh) or any zero-arg callable returning the same
    dict: {queue_depth, p99_latency_s, shed_rate, burn_rate, ...}.
    """

    def __init__(
        self,
        fleet,
        signals: Any,
        min_replicas: int = 1,
        max_replicas: int = 4,
        up_queue_depth: float = 8.0,
        up_p99_s: float = 0.5,
        up_shed_rate: float = 0.05,
        up_burn_rate: float = 10.0,
        down_fraction: float = 0.5,
        hysteresis_ticks: int = 3,
        cooldown_s: float = 30.0,
        clock: Any = None,
        metrics: Any = None,
        extra_up: "dict[str, float] | None" = None,
        timeline: Any = None,
        trend_window_s: float = 60.0,
        up_queue_slope: "float | None" = None,
        up_p99_slope: "float | None" = None,
    ):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        self.fleet = fleet
        self._signals = signals
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_queue_depth = float(up_queue_depth)
        self.up_p99_s = float(up_p99_s)
        self.up_shed_rate = float(up_shed_rate)
        self.up_burn_rate = float(up_burn_rate)
        # domain-specific up-thresholds beyond the four serving SLOs:
        # {signal_key: threshold} — elastic training adds step-time p99
        # and straggler-wait here; extra signals obey the same
        # down_fraction calm band as the built-ins
        self.extra_up = {k: float(v) for k, v in (extra_up or {}).items()}
        # trend signals from the telemetry timeline (a TimelineStore or
        # a TimelineRecorder): windowed least-squares slope of queue
        # depth and p99 over `trend_window_s`, so scaling acts on where
        # the fleet is HEADED, not only on where it is. Opt-in via the
        # slope thresholds (units/second); trends only push UP — a
        # falling queue never sheds capacity by itself, the calm band
        # still owns scale-down.
        self.timeline = getattr(timeline, "store", timeline)
        self.trend_window_s = float(trend_window_s)
        self.up_queue_slope = (float(up_queue_slope)
                               if up_queue_slope is not None else None)
        self.up_p99_slope = (float(up_p99_slope)
                             if up_p99_slope is not None else None)
        # calm = every signal under down_fraction * its up threshold —
        # the hysteresis BAND between the up and down trigger points
        self.down_fraction = float(down_fraction)
        self.hysteresis_ticks = int(hysteresis_ticks)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        # RLock: tick() holds it while calling heal(), which is also a
        # public entry point and takes it itself
        self._lock = make_rlock("FleetAutoscaler._lock")
        self._calm_ticks = 0
        self._last_action = "none"
        self._last_action_t = float("-inf")
        self._last_signals: dict = {}
        self._last_reasons: list[str] = []
        self.events: collections.deque = collections.deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        from ..observability.metrics import get_registry

        reg = metrics if metrics is not None else get_registry()
        self._g_target = reg.gauge(
            "mmlspark_tpu_autoscaler_target_replicas_count",
            "replica count the autoscaler is holding the fleet at")
        self._g_calm = reg.gauge(
            "mmlspark_tpu_autoscaler_calm_ticks_count",
            "consecutive calm ticks toward a scale-down")
        self._c_events = reg.counter(
            "mmlspark_tpu_autoscaler_scale_events_total",
            "scale actions taken, by direction",
            labels=("direction",))
        self._g_qslope = reg.gauge(
            "mmlspark_tpu_autoscaler_queue_slope_rate",
            "windowed least-squares slope of fleet queue depth (per s)")
        self._g_pslope = reg.gauge(
            "mmlspark_tpu_autoscaler_p99_slope_rate",
            "half-window delta of serving p99 latency (seconds per s)")
        self._g_target.set(self.fleet.n_live)

    # -- signal plumbing ------------------------------------------------ #

    def read_signals(self) -> dict:
        src = self._signals
        if hasattr(src, "signals"):
            # SLOEngine: refresh burn-rate windows, then read
            try:
                src.evaluate()
            except Exception:  # noqa: BLE001 — stale windows beat a crash
                pass
            sig = src.signals()
        else:
            sig = src()
        sig = dict(sig)
        sig.update(self._trend())
        return sig

    def _trend(self) -> dict:
        """Timeline trend signals: queue-depth slope over the trend
        window plus the half-window-to-half-window p99 delta rate. Empty
        (and pressure-neutral) without a timeline or while the history
        is still shorter than the window."""
        tl = self.timeline
        if tl is None:
            return {}
        w = self.trend_window_s
        try:
            at = tl.last_time()
            if at is None:
                return {}
            qs = tl.slope("mmlspark_tpu_serving_queue_depth", w, at=at)
            half = w / 2.0
            p99_now = tl.quantile_over(
                "mmlspark_tpu_serving_latency_seconds", 0.99, half,
                at=at)
            p99_then = tl.quantile_over(
                "mmlspark_tpu_serving_latency_seconds", 0.99, half,
                at=at - half)
            ps = (p99_now - p99_then) / half if half > 0 else 0.0
        except Exception:  # noqa: BLE001 — trends are advisory inputs
            return {}
        self._g_qslope.set(qs)
        self._g_pslope.set(ps)
        return {"queue_depth_slope": qs, "p99_latency_slope": ps}

    def _pressure(self, sig: dict) -> list[str]:
        """Which up-thresholds the current signals cross (empty = calm
        enough to COUNT toward a scale-down when fully under the band)."""
        reasons = []
        if sig.get("queue_depth", 0.0) > self.up_queue_depth:
            reasons.append("queue_depth")
        p99 = sig.get("p99_latency_s", 0.0)
        if p99 == p99 and p99 > self.up_p99_s:  # NaN-safe
            reasons.append("p99_latency")
        if sig.get("shed_rate", 0.0) > self.up_shed_rate:
            reasons.append("shed_rate")
        if sig.get("burn_rate", 0.0) > self.up_burn_rate:
            reasons.append("burn_rate")
        if (self.up_queue_slope is not None
                and sig.get("queue_depth_slope", 0.0)
                > self.up_queue_slope):
            reasons.append("queue_depth_slope")
        if (self.up_p99_slope is not None
                and sig.get("p99_latency_slope", 0.0) > self.up_p99_slope):
            reasons.append("p99_latency_slope")
        for key, threshold in self.extra_up.items():
            v = sig.get(key, 0.0)
            if v == v and v > threshold:  # NaN-safe
                reasons.append(key)
        return reasons

    def _calm(self, sig: dict) -> bool:
        f = self.down_fraction
        p99 = sig.get("p99_latency_s", 0.0)
        if p99 != p99:
            p99 = 0.0
        if not (sig.get("queue_depth", 0.0) <= self.up_queue_depth * f
                and p99 <= self.up_p99_s * f
                and sig.get("shed_rate", 0.0) <= self.up_shed_rate * f
                and sig.get("burn_rate", 0.0) <= self.up_burn_rate * f):
            return False
        if (self.up_queue_slope is not None
                and sig.get("queue_depth_slope", 0.0)
                > self.up_queue_slope * f):
            return False
        if (self.up_p99_slope is not None
                and sig.get("p99_latency_slope", 0.0)
                > self.up_p99_slope * f):
            return False
        for key, threshold in self.extra_up.items():
            v = sig.get(key, 0.0)
            if v != v:
                v = 0.0
            if v > threshold * f:
                return False
        return True

    # -- control loop --------------------------------------------------- #

    def _record(self, action: str, detail: str) -> None:
        now = self.clock.monotonic()
        self._last_action = action
        self._last_action_t = now
        self.events.append({"t": now, "action": action, "detail": detail,
                            "n_live": self.fleet.n_live})
        self._c_events.labels(direction=action).inc()
        # the same transition lands in the black box so a postmortem
        # shows WHEN capacity moved relative to the trigger
        from ..observability.recorder import get_recorder

        get_recorder().record_transition(
            "autoscaler", action, detail=detail, n_live=self.fleet.n_live)

    def heal(self) -> list[int]:
        """Respawn every crashed (non-retired) slot. Runs outside the
        cooldown: healing restores approved capacity, it is not a
        scaling decision."""
        healed = []
        with self._lock:
            for slot in self.fleet.dead_slots():
                try:
                    self.fleet.respawn(slot)
                    healed.append(slot)
                    self._record("respawn", f"slot {slot}")
                except Exception as e:  # noqa: BLE001 — keep healing others
                    self.events.append({
                        "t": self.clock.monotonic(),
                        "action": "respawn_failed",
                        "detail": f"slot {slot}: {e}",
                        "n_live": self.fleet.n_live})
        return healed

    def in_cooldown(self) -> bool:
        return (self.clock.monotonic() - self._last_action_t
                < self.cooldown_s)

    def tick(self) -> str:
        """One control step: heal, read signals, maybe scale by ±1.
        Returns the action taken ("respawn" reports healing even when no
        scaling happened)."""
        with self._lock:
            healed = self.heal()
            sig = self.read_signals()
            self._last_signals = sig
            reasons = self._pressure(sig)
            self._last_reasons = reasons
            n = self.fleet.n_live
            action = "respawn" if healed else "none"
            if reasons:
                self._calm_ticks = 0
                if n < self.max_replicas and not self.in_cooldown():
                    self.fleet.scale_to(n + 1)
                    self._record("up", ",".join(reasons))
                    action = "up"
            elif self._calm(sig):
                self._calm_ticks += 1
                if (self._calm_ticks >= self.hysteresis_ticks
                        and n > self.min_replicas
                        and not self.in_cooldown()):
                    self.fleet.scale_to(n - 1)
                    self._record("down",
                                 f"calm x{self._calm_ticks}")
                    self._calm_ticks = 0
                    action = "down"
            else:
                # inside the hysteresis band: neither direction moves
                self._calm_ticks = 0
            self._g_target.set(self.fleet.n_live)
            self._g_calm.set(self._calm_ticks)
            return action

    def state(self) -> dict:
        """Snapshot for GET /autoscaler and tools/diagnose.py."""
        with self._lock:
            cooldown_left = max(
                0.0, self.cooldown_s
                - (self.clock.monotonic() - self._last_action_t))
            return {
                "n_live": self.fleet.n_live,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "calm_ticks": self._calm_ticks,
                "hysteresis_ticks": self.hysteresis_ticks,
                "cooldown_s": self.cooldown_s,
                "cooldown_remaining_s": (cooldown_left
                                         if cooldown_left != float("inf")
                                         else 0.0),
                "last_action": self._last_action,
                "pressure": list(self._last_reasons),
                "signals": dict(self._last_signals),
                "events": list(self.events)[-8:],
            }

    # -- background loop ------------------------------------------------ #

    def start(self, interval_s: float = 5.0) -> "FleetAutoscaler":
        """Tick on a background thread every `interval_s` (through the
        injectable clock). Tests drive tick() directly instead."""
        def _loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the loop must survive
                    pass
                self.clock.sleep(interval_s)

        self._thread = threading.Thread(target=_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
