"""Early stopping in the port against the JAX package, on the CPU:
`get_validation_loss` for every objective (float32 means in another
order: rtol 1e-5); `best_iteration` and the rounds kept for binary,
multiclass and a regression through `Booster.train(valid=...)`; rf and
single-class dart ignoring it. The estimators' `validation_fraction` and
warm start are in test_torch_gbdt_warm_start.py.

Trees are compared by `chip_smoke.compare_fits`, every tree. The JAX side
runs under kernel mode "xla", restored in `finally`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.gbdt import objectives as jobj  # noqa: E402
from mmlspark_tpu_torch.gbdt import objectives as tobj  # noqa: E402
from test_torch_gbdt_boosting import _fit_both, chip_smoke  # noqa: E402

ADULT = chip_smoke.make_dataset(1600, 14)
CUT = 1200


def compare_all(port, ref, x):
    parity = chip_smoke.compare_fits(ref, port, ref.bin_mapper.transform(x))
    assert parity["trees_compared"] == ref.num_trees == port.num_trees, parity["near_ties"]


@pytest.mark.parametrize("objective,kw", [
    ("binary", {}), ("multiclass", {}), ("regression", {}), ("l2", {}), ("huber", {}),
    ("fair", {}), ("l1", {}), ("mae", {}), ("regression_l1", {}),
    ("mean_absolute_error", {}), ("quantile", dict(alpha=0.3)), ("mape", {}),
    ("poisson", {}), ("gamma", {}), ("tweedie", dict(tweedie_variance_power=1.3)),
    ("tweedie", dict(tweedie_variance_power=1.0)), ("tweedie", dict(tweedie_variance_power=2.0)),
])
def test_validation_loss_matches_jax(objective, kw):
    rng = np.random.default_rng(5)
    n = 700
    if objective == "multiclass":
        raw = rng.normal(size=(n, 4)).astype(np.float32)
        y = rng.integers(0, 4, n)
        y_t = torch.as_tensor(y)
    else:
        raw = rng.normal(size=n).astype(np.float32)
        y = (rng.random(n) < 0.4).astype(np.float32) if objective == "binary" else \
            np.abs(rng.normal(size=n) * 3).astype(np.float32)
        y_t = torch.as_tensor(y)
    want = float(jobj.get_validation_loss(objective, **kw)(jnp.asarray(raw), jnp.asarray(y)))
    got = tobj.get_validation_loss(objective, **kw)(torch.as_tensor(raw), y_t)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("objective,lr,rounds", [
    ("binary", 0.3, 60), ("regression", 0.3, 60), ("multiclass", 0.5, 40),
])
def test_best_iteration_and_kept_rounds_match_jax(objective, lr, rounds):
    x, y = ADULT
    kw = dict(objective=objective, num_iterations=rounds, num_leaves=7, learning_rate=lr,
              early_stopping_round=3, bagging_fraction=0.8, bagging_freq=1)
    if objective == "regression":
        y = 2.0 * x[:, 0] + y
    if objective == "multiclass":
        # three classes of the Adult stand-in's noisy logit: noise keeps
        # leaves mixed and gains apart, as in the binary case
        logit = x[:, 0] - 0.7 * x[:, 1] + 0.4 * x[:, 2] * x[:, 4] + y
        y = np.digitize(logit, np.quantile(logit, [1 / 3, 2 / 3])).astype(np.float64)
        kw.update(num_class=3)
    port, ref = _fit_both(x[:CUT], y[:CUT], valid=(x[CUT:], y[CUT:]), **kw)
    assert 0 <= ref.best_iteration < rounds - 1, "the fit must stop early"
    assert port.best_iteration == ref.best_iteration
    k = 3 if objective == "multiclass" else 1
    assert port.num_trees == (ref.best_iteration + 1) * k
    compare_all(port, ref, x[:CUT])


@pytest.mark.parametrize("boosting", ["rf", "dart"])
def test_rf_and_single_class_dart_ignore_early_stopping(boosting):
    x, y = ADULT
    logs = []
    kw = dict(objective="binary", boosting_type=boosting, num_iterations=6, num_leaves=7,
              early_stopping_round=1, bagging_fraction=0.8, bagging_freq=1, seed=42)
    port, ref = _fit_both(x[:CUT], y[:CUT], valid=(x[CUT:], y[CUT:]), log=logs.append, **kw)
    assert port.num_trees == ref.num_trees == 6
    assert port.best_iteration == ref.best_iteration == -1
    assert any("ignored" in m for m in logs), logs
    compare_all(port, ref, x[:CUT])
