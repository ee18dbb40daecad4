"""The port's preemptible hyperband sweep (automl/sweep.py) held against
the JAX package's, on the CPU.

tests/test_automl_sweep.py's cases: the `HyperbandPruner`'s rung math on a
private registry, in both packages; the worker claim/heartbeat/status
protocol driven in-process (shared bins: one build, a hit a fold); a
serial sweep (one worker process) that prunes and picks; and a P=2 sweep
whose worker is SIGKILLed before its 3rd sub-checkpoint save, which must
land the serial sweep's digest byte for byte. tests/test_torch_sweep_parity.py
holds the serial sweep to the JAX package's. Worker processes run the
port on the CPU; every rung has a 120 s limit.
"""

import json
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.automl import sweep as jax_sweep  # noqa: E402
from mmlspark_tpu.gbdt import GBDTClassifier as JaxClassifier  # noqa: E402
from mmlspark_tpu.observability.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from mmlspark_tpu_torch.automl.sweep import (HyperbandPruner, SweepScheduler,  # noqa: E402
                                             SweepWorkerFactory, _score_gauge)
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassifier  # noqa: E402
from mmlspark_tpu_torch.gbdt.shared_bins import bin_counters, set_shared_bin_context  # noqa: E402
from mmlspark_tpu_torch.io_http.schema import HTTPRequestData  # noqa: E402
from mmlspark_tpu_torch.observability.metrics import MetricsRegistry  # noqa: E402

SPACE = [{"learning_rate": lr, "num_leaves": nl} for lr in (0.05, 0.1, 0.2) for nl in (4, 8)]
EST = dict(features_col="features", label_col="label", num_iterations=8, num_leaves=4, seed=7)


def sweep_cols(n=120, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    return {"features": x, "label": (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)}


def make_scheduler(ckpt, workers, chaos=None, jax=False):
    pkg_sched, pkg_pruner = ((jax_sweep.SweepScheduler, jax_sweep.HyperbandPruner) if jax
                             else (SweepScheduler, HyperbandPruner))
    est = JaxClassifier(**EST) if jax else GBDTClassifier(device="cpu", **EST)
    return pkg_sched(
        [est], trials=[(0, p) for p in SPACE], evaluation_metric="accuracy",
        label_col="label", num_folds=2, seed=0, checkpoint_dir=str(ckpt), workers=workers,
        pruner=pkg_pruner(min_resource=4, max_resource=8, eta=2), rung_timeout_s=120.0,
        chaos=chaos)


class TestHyperbandPruner:
    def test_budget_geometry_and_invalid_configs(self):
        for args in [(4, 8, 2), (2, 18, 3), (2, 7, 2), (5, 5, 2)]:
            assert (HyperbandPruner(*args).rung_budgets()
                    == jax_sweep.HyperbandPruner(*args).rung_budgets())
        for args in [(10, 5, 3), (0, 5, 3), (1, 5, 1)]:
            with pytest.raises(ValueError):
                HyperbandPruner(*args)

    @pytest.mark.parametrize("case", [
        (0, {0: 0.9, 1: 0.5, 2: float("nan"), 3: 0.7}, True, 2),
        (1, {0: 0.9, 1: 0.5, 2: 0.7}, False, 3),
        (0, {4: 0.5, 7: 0.5, 9: 0.5}, True, 2),
        (2, {i: float(i % 3) for i in range(7)}, True, 3),
    ])
    def test_decisions_match_the_jax_package(self, case):
        rung, scores, maximize, eta = case
        out = []
        for pkg_gauge, reg, pruner in (
                (_score_gauge, MetricsRegistry(), HyperbandPruner(2, 8, eta=eta)),
                (jax_sweep._score_gauge, JaxRegistry(), jax_sweep.HyperbandPruner(2, 8, eta=eta))):
            g = pkg_gauge(reg)
            for ti, v in scores.items():
                g.labels(trial=str(ti), rung=str(rung)).set(v)
            out.append(pruner.decide(rung, sorted(scores), maximize=maximize, registry=reg))
        assert out[0] == out[1]

    def test_barrier_violation_all_nan_and_rung_isolation(self):
        reg = MetricsRegistry()
        g = _score_gauge(reg)
        g.labels(trial="0", rung="0").set(0.9)
        with pytest.raises(RuntimeError, match="not a barrier"):
            HyperbandPruner(2, 8, eta=2).decide(0, [0, 1], maximize=True, registry=reg)
        g.labels(trial="0", rung="1").set(float("nan"))
        g.labels(trial="1", rung="1").set(float("nan"))
        with pytest.raises(RuntimeError, match="NaN"):
            HyperbandPruner(2, 8, eta=2).decide(1, [0, 1], maximize=True, registry=reg)
        g.labels(trial="1", rung="0").set(0.1)
        g.labels(trial="0", rung="2").set(0.1)
        g.labels(trial="1", rung="2").set(0.9)
        assert HyperbandPruner(2, 8, eta=2).decide(2, [0, 1], maximize=True,
                                                    registry=reg) == [1]


def _reply(handler, body):
    out = handler(Table({"request": [HTTPRequestData.from_json("/", body)]}))
    r = out["reply"][0]
    return r.status_code, json.loads(r.entity.decode())


class TestWorkerProtocol:
    @pytest.fixture()
    def handler(self, tmp_path):
        sched = make_scheduler(tmp_path, workers=1)
        sched._write_spec(Table(sweep_cols()))
        try:
            yield SweepWorkerFactory(str(tmp_path))()
        finally:
            set_shared_bin_context(None)

    def _await_done(self, handler, timeout=90.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            code, doc = _reply(handler, {"op": "heartbeat"})
            assert code == 200
            if doc["state"] in ("done", "failed"):
                return doc
            time.sleep(0.05)
        raise AssertionError("trial never finished")

    def test_unknown_op_is_an_error_reply_not_a_crash(self, handler):
        code, doc = _reply(handler, {"op": "explode"})
        assert code == 500 and "error" in doc
        code, doc = _reply(handler, {"op": "heartbeat"})
        assert code == 200 and doc["state"] == "idle"

    def test_claim_fit_report_and_idempotence(self, handler):
        before = bin_counters()
        code, doc = _reply(handler, {"op": "claim", "trial": 0, "rung": 0, "budget": 4})
        assert code == 200 and doc == {"ok": True}
        done = self._await_done(handler)
        assert done["state"] == "done" and math.isfinite(done["metric"])
        code, doc = _reply(handler, {"op": "claim", "trial": 0, "rung": 0, "budget": 4})
        assert code == 200 and doc["done"] is True and doc["metric"] == done["metric"]
        _reply(handler, {"op": "claim", "trial": 1, "rung": 0, "budget": 4})
        self._await_done(handler)
        code, doc = _reply(handler, {"op": "status"})
        assert code == 200 and set(doc["done"]) == {"0:0", "1:0"}
        assert doc["counters"]["builds"] - before["builds"] == 1.0
        assert doc["counters"]["hits"] - before["hits"] == 4.0   # 2 trials x 2 folds


@pytest.fixture(scope="module")
def serial_sweep(tmp_path_factory):
    """The port's undisturbed P=1 sweep (tests/test_torch_sweep_parity.py
    holds it to the JAX package's)."""
    return make_scheduler(tmp_path_factory.mktemp("port-serial"), workers=1).run(
        Table(sweep_cols()))


class TestSweepEndToEnd:
    def test_serial_sweep_prunes_and_picks(self, serial_sweep):
        assert serial_sweep.pruned and sum(len(v) for v in serial_sweep.pruned.values()) >= 1
        assert serial_sweep.best_trial in serial_sweep.survivors
        assert math.isfinite(serial_sweep.best_metric)
        assert [c["builds"] for c in serial_sweep.worker_counters] == [1.0]

    def test_sigkill_mid_trial_matches_serial(self, serial_sweep, tmp_path):
        res = make_scheduler(tmp_path, workers=2,
                             chaos={"nth": 3, "mode": "before_save"}).run(Table(sweep_cols()))
        assert (tmp_path / "_chaos_fired").exists()
        assert res.resumed_trials >= 1
        assert res.digest == serial_sweep.digest
        assert res.best_blob == serial_sweep.best_blob
        assert res.pruned == serial_sweep.pruned
        assert all(c["builds"] == 1.0 for c in res.worker_counters)
