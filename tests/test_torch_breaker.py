"""The port's circuit breaker (mmlspark_tpu_torch/resilience/breaker.py)
against the JAX package's, step for step: the same seeded sequence of
admissions, outcomes and clock advances on each package's FakeClock gives
the same state, retry-after, failure rate and counters after every step."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mmlspark_tpu.core.schema import Table as RefTable  # noqa: E402
from mmlspark_tpu.ops.stages import DropColumns as RefDropColumns  # noqa: E402
from mmlspark_tpu.resilience import breaker as ref_breaker  # noqa: E402
from mmlspark_tpu.resilience.policy import FakeClock as RefFakeClock  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.ops.stages import DropColumns  # noqa: E402
from mmlspark_tpu_torch.resilience import breaker  # noqa: E402
from mmlspark_tpu_torch.resilience.policy import FakeClock  # noqa: E402

CONFIGS = [
    dict(failure_rate_threshold=0.5, window=4, min_calls=2, open_duration_s=5.0),
    dict(failure_rate_threshold=0.3, window=8, min_calls=4, open_duration_s=2.5,
         half_open_max_calls=2),
    dict(failure_rate_threshold=0.9, window=20, min_calls=10, open_duration_s=30.0),
]


def _observe(br) -> tuple:
    return (br.state, round(br.retry_after_s(), 9), round(br.failure_rate(), 9),
            br.times_opened, br.calls_shed)


def _walk(mod, clock, config: dict, seed: int, steps: int = 300) -> list:
    """A seeded walk: each step admits (allow) or not, records a success or
    a failure, advances the clock, or calls through `call`."""
    rng = np.random.default_rng(seed)
    br = mod.CircuitBreaker(name="dep", clock=clock, **config)
    trace = [_observe(br)]
    for _ in range(steps):
        op = rng.integers(0, 5)
        if op == 0:
            trace.append(("allow", br.allow()))
        elif op == 1:
            br.record_success()
        elif op == 2:
            br.record_failure()
        elif op == 3:
            clock.advance(float(rng.uniform(0, config["open_duration_s"])))
        else:
            ok = bool(rng.random() < 0.4)

            def fn():
                if not ok:
                    raise ValueError("dependency down")
                return 1

            try:
                trace.append(("call", br.call(fn)))
            except mod.CircuitOpenError as e:
                trace.append(("open", round(e.retry_after_s, 9)))
            except ValueError:
                trace.append(("failed",))
        trace.append(_observe(br))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config", CONFIGS, ids=["w4", "w8_probes2", "w20"])
def test_state_machine_steps_alike(config, seed):
    port = _walk(breaker, FakeClock(), config, seed)
    ref = _walk(ref_breaker, RefFakeClock(), config, seed)
    assert port == ref
    states = {t[0] for t in port if len(t) == 5}
    assert "open" in states or config["min_calls"] >= 10


def test_full_cycle_closed_open_half_open_closed():
    for mod, clock in ((breaker, FakeClock()), (ref_breaker, RefFakeClock())):
        br = mod.CircuitBreaker(min_calls=2, window=2, open_duration_s=5.0, clock=clock)
        br.record_failure()
        br.record_failure()
        assert br.state == "open" and not br.allow() and br.retry_after_s() == 5.0
        clock.advance(5.0)
        assert br.state == "half_open" and br.allow() and not br.allow()
        br.record_success()
        assert br.state == "closed" and br.failure_rate() == 0.0


def test_registry_keys_endpoints_alike():
    urls = ["http://a:1/x", "http://a:1/y?q=1", "https://b/z", "relative/path"]
    for url in urls:
        assert breaker.BreakerRegistry.endpoint_key(url) == \
            ref_breaker.BreakerRegistry.endpoint_key(url)
    states = []
    for mod, clock in ((breaker, FakeClock()), (ref_breaker, RefFakeClock())):
        reg = mod.BreakerRegistry(clock=clock, min_calls=2, window=2)
        for url in urls:
            reg.breaker_for(url).record_failure()
        reg.breaker_for(urls[0]).record_failure()
        states.append(reg.states())
    assert states[0] == states[1]
    assert states[0]["http://a:1"] == "open"


def test_transformer_passthrough_and_raise_alike():
    outcomes = []
    for mod, clock, drop, table in (
            (breaker, FakeClock(), DropColumns, Table),
            (ref_breaker, RefFakeClock(), RefDropColumns, RefTable)):
        t = table({"a": np.arange(3.0), "b": np.arange(3.0)})
        cb = mod.CircuitBreakerTransformer(inner=drop(cols=["zz"]), min_calls=2, window=2,
                                           open_mode="passthrough")
        cb.clock = clock
        seen = []
        for _ in range(3):
            try:
                cb.transform(t)
                seen.append("ok")
            except Exception as e:  # noqa: BLE001 — the inner stage's failure
                seen.append(type(e).__name__)
        seen.append(cb.breaker.state)
        seen.append(cb.transform(t).columns)
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][3] == "open"


def test_metric_families_match():
    from mmlspark_tpu.observability.metrics import MetricsRegistry as RefRegistry
    from mmlspark_tpu_torch.observability.metrics import MetricsRegistry

    texts = []
    for mod, reg, clock in ((breaker, MetricsRegistry(), FakeClock()),
                            (ref_breaker, RefRegistry(), RefFakeClock())):
        mod.ensure_metrics(reg)
        br = mod.CircuitBreaker(name="m", min_calls=1, window=1, clock=clock, metrics=reg)
        br.record_failure()
        br.allow()
        texts.append(reg.render_prometheus())
    assert texts[0] == texts[1]
    assert 'mmlspark_tpu_resilience_breaker_transitions_total{breaker="m",to="open"} 1' \
        in texts[0]
