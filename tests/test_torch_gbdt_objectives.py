"""Every regression objective of the port (mmlspark_tpu_torch) against the
JAX package's, on the CPU: the objective functions themselves, the initial
score, leaf renewal, and whole fits.

Data and sizes are tests/test_gbdt.py's objective test
(`make_regression(n=800)`, |y| + 1 for poisson, gamma, tweedie and mape,
10 rounds, 7 leaves). Trees must be equal; leaf values and predictions
agree within rtol 1e-5, as test_torch_gbdt_fit.py holds them, split gains
within rtol 1e-4 (see below); a leaf
renewed to a residual percentile (l1, quantile, mape) agrees within one
refinement bin of its renewal (learning rate x residual span / 256**2).
The JAX side runs under kernel mode "xla", restored in `finally`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.gbdt import objectives as jobj  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu_torch.gbdt import objectives as tobj  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions  # noqa: E402

OBJECTIVES = ["regression", "l1", "huber", "fair", "poisson", "quantile", "mape",
              "gamma", "tweedie"]
POSITIVE = ("poisson", "gamma", "tweedie", "mape")
RENEWED = ("l1", "quantile", "mape")
FIT = dict(num_iterations=10, num_leaves=7)
TREE_FIELDS = ("feature", "threshold_bin", "left", "right", "is_categorical")


def make_regression(n=800, f=8, seed=1):
    """tests/test_gbdt.py's regression data set."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = 3.0 * x[:, 0] - 2.0 * x[:, 1] + np.sin(x[:, 2]) + 0.1 * rng.normal(size=n)
    return x, y


def _data(objective):
    x, y = make_regression()
    return x, (np.abs(y) + 1.0 if objective in POSITIVE else y)


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


@pytest.mark.parametrize("objective", ["binary", *OBJECTIVES])
@pytest.mark.parametrize("kw", [{}, dict(alpha=0.3, tweedie_variance_power=1.2, fair_c=2.0)],
                         ids=["defaults", "params"])
def test_gradients_and_hessians_match_jax(objective, kw):
    rng = np.random.default_rng(4)
    raw = rng.normal(size=500).astype(np.float32)
    y = (rng.random(500) < 0.4).astype(np.float32) if objective == "binary" else \
        (np.abs(rng.normal(size=500)) * 3).astype(np.float32)
    jg, jh = jobj.get_objective(objective, **kw)(jnp.asarray(y), jnp.asarray(raw))
    tg, th = tobj.get_objective(objective, **kw)(torch.from_numpy(y), torch.from_numpy(raw))
    assert tg.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("objective", ["binary", "multiclass", *OBJECTIVES, "mae", "mse"])
def test_init_score_and_renewal_spec_match_jax(objective):
    x, y = _data(objective)
    y = (y > 0).astype(float) if objective == "binary" else y
    w = np.linspace(0.5, 2.0, len(y))
    for alpha in (0.9, 0.25):
        assert tobj.init_raw_score(objective, y, w, True, alpha) == \
            jobj.init_raw_score(objective, y, w, True, alpha)
        assert tobj.get_leaf_renewal(objective, alpha) == jobj.get_leaf_renewal(objective, alpha)
    assert tobj.init_raw_score(objective, y, None, False) == 0.0


def test_unknown_objective_raises():
    with pytest.raises(ValueError, match="unknown objective"):
        tobj.get_objective("hinge")


def _renewal_bin(port, x, y, t):
    """One refinement bin of tree t's renewal, bounded above by the span of
    every row's residual before the tree (a node's span is within it)."""
    before = port.predict_raw(x, device="host", num_iteration=t) if t else \
        np.full(len(y), port.init_score, np.float32)
    resid = (y.astype(np.float32) - before).astype(np.float64)
    return 0.1 * (resid.max() - resid.min()) / 256 ** 2


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_fit_matches_jax(objective):
    x, y = _data(objective)
    ref = _jax(lambda: JaxBooster.train(x, y, JaxOptions(objective=objective, **FIT)))
    port = Booster.train(x, y, TrainOptions(objective=objective, device="cpu", **FIT))
    assert port.num_trees == ref.num_trees == 10 and port.objective == objective
    assert port.init_score == ref.init_score
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    # a gain is the difference of three leaf objectives (sum g)^2 / sum h,
    # each of f32 sums taken in another order, so it keeps fewer correct
    # digits than the sums: fair's largest gap is 1.9e-5 relative
    np.testing.assert_allclose(port.gain, ref.gain, rtol=1e-4, atol=1e-5)
    for t in range(port.num_trees):
        if objective in RENEWED:
            atol = _renewal_bin(port, x, y, t)
            np.testing.assert_allclose(port.value[t], ref.value[t], rtol=0, atol=atol,
                                       err_msg=f"tree {t}")
        else:
            np.testing.assert_allclose(port.value[t], ref.value[t], rtol=1e-5, atol=1e-7,
                                       err_msg=f"tree {t}")
    got, want = port.predict(x), ref.predict(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the port's two routes add in the same order: equal bits
    np.testing.assert_array_equal(port.predict_raw(x, device="host"),
                                  port.predict_raw(x, device="device"))


def test_renewal_sets_leaves_to_the_residual_percentile():
    # quantile at alpha 0.9: each renewed leaf of the first tree is the 0.9
    # quantile of its rows' residuals (to within a refinement bin) times the
    # learning rate
    x, y = _data("quantile")
    port = Booster.train(x, y, TrainOptions(objective="quantile", alpha=0.9, device="cpu",
                                            num_iterations=1, num_leaves=7))
    leaf = port.predict_leaf(x)[:, 0]
    resid = y - port.init_score
    for node in np.unique(leaf):
        rows = resid[leaf == node]
        want = 0.1 * np.quantile(rows, 0.9, method="inverted_cdf")
        span = 0.1 * (rows.max() - rows.min())
        assert abs(port.value[0, node] - want) <= span / 256 ** 2 * 2 + 1e-6, node
