"""SLO engine: error-budget burn rates over registry/fleet series.

An objective ("99.9% of requests answered", "99% under 100 ms") turns the
raw counters into one actionable number: the **burn rate** — the window's
error rate divided by the error budget (1 - objective). Burn 1.0 consumes
exactly the budget over the window; the multi-window pattern (Google SRE
workbook) pairs a SHORT window (is it burning *now*?) with a LONG window
(has it burned *enough to matter*?) and alerts only when both exceed the
threshold, which kills both flappy and stale alerts.

Everything runs on the injectable clock against a snapshot-shaped source
(`MetricsRegistry.snapshot()` or `MetricsAggregator.snapshot()` — single
process and fleet read identically), so chaos tests drive budget burn
deterministically with zero real sleeps.

Emitted series (registered in tools/metric_lint.py):
  mmlspark_tpu_slo_burn_rate{slo=,window=}        per-window burn rate
  mmlspark_tpu_slo_budget_remaining_ratio{slo=}   1 - long-window burn
`signals()` returns the autoscaler inputs the ROADMAP names: queue depth,
p99 latency, shed rate, burn rate, budget remaining.

A copy of mmlspark_tpu/observability/slo.py.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

from .sanitizer import make_lock
from .metrics import MetricsRegistry

__all__ = [
    "SeriesReader", "SLO", "SLOEngine",
    "availability_slo", "latency_slo", "counter_series",
    "DEFAULT_WINDOWS", "DEFAULT_BURN_ALERT",
]

# short/long evaluation windows (seconds). The defaults suit the chaos
# soak scale; production configs pass e.g. {"short": 300, "long": 3600}.
DEFAULT_WINDOWS: dict[str, float] = {"short": 60.0, "long": 600.0}
# burn threshold the alert check applies to EVERY window (multi-window
# AND): 10x burn on the long window exhausts the budget in window/10
DEFAULT_BURN_ALERT = 10.0


class _MonotonicClock:
    def monotonic(self) -> float:
        return time.monotonic()


class SeriesReader:
    """Point-in-time reads over a snapshot-shaped source: a dict like
    `MetricsRegistry.snapshot()` returns, or any object with a
    `.snapshot()` method producing one."""

    def __init__(self, source: Any):
        self._snap = (source.snapshot()
                      if hasattr(source, "snapshot") else dict(source))

    def _samples(self, name: str) -> list[dict]:
        fam = self._snap.get(name)
        return list(fam["samples"]) if fam else []

    @staticmethod
    def _match(sample: dict, labels: "dict[str, str] | None") -> bool:
        if not labels:
            return True
        d = sample.get("labels", {})
        return all(str(d.get(k)) == str(v) for k, v in labels.items())

    def counter(self, name: str,
                labels: "dict[str, str] | None" = None) -> float:
        """Sum of matching counter/gauge samples (0.0 when absent)."""
        return float(sum(s["value"] for s in self._samples(name)
                         if "value" in s and self._match(s, labels)))

    gauge = counter

    def histogram(self, name: str,
                  labels: "dict[str, str] | None" = None) -> dict:
        """Matching histogram children merged: cumulative buckets keyed by
        float bound (inf included), plus count and sum."""
        buckets: dict[float, float] = {}
        count = 0.0
        total = 0.0
        for s in self._samples(name):
            if "buckets" not in s or not self._match(s, labels):
                continue
            count += float(s.get("count", 0))
            total += float(s.get("sum", 0.0))
            for b, c in s["buckets"].items():
                bound = float("inf") if b in ("+Inf", "inf") else float(b)
                buckets[bound] = buckets.get(bound, 0.0) + float(c)
        return {"count": count, "sum": total,
                "buckets": dict(sorted(buckets.items()))}

    def histogram_under(self, name: str, threshold: float,
                        labels: "dict[str, str] | None" = None
                        ) -> tuple[float, float]:
        """(observations <= threshold, total observations) — the good/total
        pair a latency SLO needs. Uses the tightest bucket bound <=
        threshold (conservative: never overcounts good)."""
        h = self.histogram(name, labels)
        good = 0.0
        for bound, cum in h["buckets"].items():
            if bound <= threshold:
                good = cum  # cumulative: the last qualifying bound wins
        return good, h["count"]

    def histogram_quantile(self, name: str, q: float,
                           labels: "dict[str, str] | None" = None) -> float:
        """Upper bound of the bucket containing the q-quantile (the usual
        exposition-side estimate); nan when empty."""
        h = self.histogram(name, labels)
        if h["count"] <= 0:
            return float("nan")
        rank = q * h["count"]
        for bound, cum in h["buckets"].items():
            if cum >= rank:
                return bound
        return float("inf")


def counter_series(name: str, **labels: str) -> Callable[[SeriesReader], float]:
    """Spec helper: a total/bad callable reading one counter family."""
    lbl = {k: str(v) for k, v in labels.items()} or None
    return lambda r: r.counter(name, lbl)


class SLO:
    """One objective over the source series.

    total / bad / good are callables `(SeriesReader) -> float` returning
    CUMULATIVE counts; the engine differences them per window. Exactly one
    of bad/good must be given."""

    def __init__(self, name: str, objective: float, *,
                 total: Callable[[SeriesReader], float],
                 bad: "Callable[[SeriesReader], float] | None" = None,
                 good: "Callable[[SeriesReader], float] | None" = None,
                 description: str = ""):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got {objective}")
        if (bad is None) == (good is None):
            raise ValueError("give exactly one of bad= or good=")
        self.name = name
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.total = total
        self._bad = bad
        self._good = good
        self.description = description

    def observe(self, reader: SeriesReader) -> tuple[float, float]:
        """(cumulative total, cumulative bad) at this instant."""
        total = float(self.total(reader))
        if self._bad is not None:
            bad = float(self._bad(reader))
        else:
            bad = max(total - float(self._good(reader)), 0.0)
        return total, bad


def availability_slo(name: str, objective: float, total: str, bad: str,
                     **labels: str) -> SLO:
    """Availability objective over two counter families (e.g. answered
    total vs failed)."""
    return SLO(name, objective,
               total=counter_series(total, **labels),
               bad=counter_series(bad, **labels),
               description=f"{objective:.4%} of {total} not in {bad}")


def latency_slo(name: str, objective: float, histogram: str,
                threshold_s: float, **labels: str) -> SLO:
    """Latency objective over a histogram family: `objective` of
    observations at or under `threshold_s`."""
    lbl = {k: str(v) for k, v in labels.items()} or None
    return SLO(
        name, objective,
        total=lambda r: r.histogram(histogram, lbl)["count"],
        good=lambda r: r.histogram_under(histogram, threshold_s, lbl)[0],
        description=f"{objective:.4%} of {histogram} <= {threshold_s}s")


class SLOEngine:
    """Multi-window burn-rate evaluator.

    source    snapshot-shaped series source (registry or aggregator)
    clock     duck-typed `monotonic()`; FakeClock makes burn deterministic
    windows   {window_name: seconds}
    registry  where the slo_* gauges land; defaults to a PRIVATE registry
              so a rendezvous can append `engine.render()` to the fleet
              exposition without duplicating every other family — pass
              `get_registry()` to co-locate with process series instead
    """

    def __init__(self, source: Any, slos: "list[SLO] | tuple[SLO, ...]" = (),
                 clock: Any = None, windows: "dict[str, float] | None" = None,
                 registry: "MetricsRegistry | None" = None,
                 burn_alert_threshold: float = DEFAULT_BURN_ALERT):
        self.source = source
        self.slos: list[SLO] = list(slos)
        self._clock = clock if clock is not None else _MonotonicClock()
        self.windows = dict(windows) if windows else dict(DEFAULT_WINDOWS)
        if not self.windows:
            raise ValueError("need at least one window")
        self.burn_alert_threshold = float(burn_alert_threshold)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._g_burn = self.registry.gauge(
            "mmlspark_tpu_slo_burn_rate",
            "error-budget burn rate per evaluation window",
            labels=("slo", "window"))
        self._g_budget = self.registry.gauge(
            "mmlspark_tpu_slo_budget_remaining_ratio",
            "error budget left over the longest window (1 - burn, floor 0)",
            labels=("slo",))
        self._lock = make_lock("SLOEngine._lock")
        keep = 2.0 * max(self.windows.values())
        self._keep_s = keep
        # per-SLO history of (t, total, bad); pruned past 2x longest window
        self._history: dict[str, deque] = {s.name: deque() for s in self.slos}
        # cumulative shed counters history for signals() shed_rate
        self._shed_history: deque = deque()
        # per-evaluation worst burn history: signals() averages it over
        # the short window so a one-tick spike cannot page the
        # autoscaler (the instantaneous gauge still spikes, by design)
        self._burn_history: deque = deque()
        self._last_results: dict[str, dict] = {}
        # optional flight recorder: every evaluation reports the alerting
        # set, and the recorder dumps on the not-alerting -> alerting
        # transition (the SLO-burn black-box trigger)
        self._recorder = None

    def attach_recorder(self, recorder) -> None:
        """Dump a FlightRecorder when an SLO starts alerting (the burn-rate
        trigger). The engine only calls `recorder.note_slo(...)`; transition
        and cooldown logic live on the recorder."""
        self._recorder = recorder

    def add(self, slo: SLO) -> None:
        with self._lock:
            self.slos.append(slo)
            self._history.setdefault(slo.name, deque())

    # -- evaluation ----------------------------------------------------- #

    @staticmethod
    def _window_delta(hist: deque, now: float, window_s: float,
                      total: float, bad: float) -> tuple[float, float]:
        """Cumulative deltas vs the newest sample at least `window_s` old
        (or the oldest retained one while history is still short)."""
        base_t, base_total, base_bad = hist[0] if hist else (now, 0.0, 0.0)
        for t, tot, b in hist:
            if t <= now - window_s:
                base_t, base_total, base_bad = t, tot, b
            else:
                break
        return max(total - base_total, 0.0), max(bad - base_bad, 0.0)

    def evaluate(self) -> dict[str, dict]:
        """Sample every SLO, update burn-rate/budget gauges, and return
        {slo: {total, bad, burn_rates: {window: rate}, budget_remaining,
        alerting}}."""
        reader = SeriesReader(self.source)
        now = self._clock.monotonic()
        long_window = max(self.windows, key=lambda w: self.windows[w])
        results: dict[str, dict] = {}
        with self._lock:
            slos = list(self.slos)
        for slo in slos:
            total, bad = slo.observe(reader)
            hist = self._history[slo.name]
            burns: dict[str, float] = {}
            for wname, wsec in self.windows.items():
                d_total, d_bad = self._window_delta(hist, now, wsec,
                                                    total, bad)
                err_rate = d_bad / d_total if d_total > 0 else 0.0
                burn = err_rate / slo.budget
                burns[wname] = burn
                self._g_burn.labels(slo=slo.name, window=wname).set(burn)
            remaining = max(1.0 - burns[long_window], 0.0)
            self._g_budget.labels(slo=slo.name).set(remaining)
            hist.append((now, total, bad))
            self._prune(hist, now)
            results[slo.name] = {
                "objective": slo.objective,
                "total": total, "bad": bad,
                "burn_rates": burns,
                "budget_remaining": remaining,
                "alerting": bool(burns) and all(
                    b >= self.burn_alert_threshold for b in burns.values()),
            }
        # shed counters ride along for signals() (serving shed + breaker
        # shed: the two load-rejection paths)
        shed = (reader.counter("mmlspark_tpu_serving_requests_shed_total")
                + reader.counter("mmlspark_tpu_resilience_breaker_shed_total"))
        self._shed_history.append((now, shed, 0.0))
        self._prune(self._shed_history, now)
        burn_now = max((max(res["burn_rates"].values(), default=0.0)
                        for res in results.values()), default=0.0)
        self._burn_history.append((now, burn_now, 0.0))
        self._prune(self._burn_history, now)
        self._last_results = results
        if self._recorder is not None:
            try:
                self._recorder.note_slo(self.alerting())
            except Exception:  # noqa: BLE001 — a dump must not kill eval
                pass
        return results

    def _prune(self, hist: deque, now: float) -> None:
        while len(hist) > 2 and hist[1][0] <= now - self._keep_s:
            hist.popleft()

    def alerting(self) -> list[str]:
        """SLOs whose burn exceeds the threshold on EVERY window — the
        multi-window AND that pages."""
        return [name for name, res in self._last_results.items()
                if res["alerting"]]

    def render(self) -> str:
        """The slo_* series as text exposition (appended to the fleet
        `/metrics` by the rendezvous)."""
        return self.registry.render_prometheus()

    # -- autoscaler inputs ---------------------------------------------- #

    def signals(self) -> dict:
        """The scaling signals the ROADMAP autoscaler consumes, in one
        dict: queue depth, p99 latency, shed rate, burn rate, budget.

        `burn_rate` is the per-evaluation worst burn AVERAGED over the
        short window, not the instantaneous gauge: scaling decisions
        must ride trends, and a single hot evaluation between two quiet
        ones is noise, not load (the raw spike still reaches the
        `slo_burn_rate` gauge and the burn-transition dump trigger)."""
        reader = SeriesReader(self.source)
        now = self._clock.monotonic()
        short = min(self.windows.values())
        shed_total = (
            reader.counter("mmlspark_tpu_serving_requests_shed_total")
            + reader.counter("mmlspark_tpu_resilience_breaker_shed_total"))
        d_shed, _ = self._window_delta(self._shed_history, now, short,
                                       shed_total, 0.0)
        span = short
        if self._shed_history:
            span = max(min(now - self._shed_history[0][0], short), 1e-9)
        burn_pts = [b for t, b, _z in self._burn_history
                    if t > now - short]
        burn_windowed = (sum(burn_pts) / len(burn_pts)) if burn_pts \
            else 0.0
        budgets = [res["budget_remaining"]
                   for res in self._last_results.values()]
        up = reader.gauge("mmlspark_tpu_fleet_replicas_up_count")
        return {
            "queue_depth": reader.gauge("mmlspark_tpu_serving_queue_depth"),
            "p99_latency_s": reader.histogram_quantile(
                "mmlspark_tpu_serving_latency_seconds", 0.99),
            "shed_rate": d_shed / span,
            "burn_rate": burn_windowed,
            "budget_remaining": min(budgets, default=1.0),
            "replicas_up": up,
        }
