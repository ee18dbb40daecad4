"""The port's binary GBDT fit and score (mmlspark_tpu_torch) against the JAX
package's, on the CPU: `Booster.train` then `predict`, the
GBDTClassifier -> GBDTClassificationModel stages, and ComputeModelStatistics.

Trees must be equal; predictions agree within rtol 1e-5, atol 1e-6, the
tolerance of tests/test_gbdt.py:900 (float32 sums in another order). The
JAX side runs under kernel mode "xla", restored in `finally`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.automl.metrics import ComputeModelStatistics as JaxCMS  # noqa: E402
from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.gbdt import GBDTClassifier as JaxClassifier  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu_torch.automl import ComputeModelStatistics  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassifier  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions  # noqa: E402

FIT = dict(objective="binary", num_iterations=10, num_leaves=15)
TREE_FIELDS = ("feature", "threshold_bin", "left", "right", "is_categorical")


def make_classification(n=2000, f=10, seed=0):
    """tests/test_gbdt.py's binary data set. Seed 0 has no near-tied split
    (seed 2 has one; see ROADMAP.md Queue 3)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    logits = x[:, 0] * 2.0 + x[:, 1] - 0.5 * x[:, 2] + 0.3 * rng.normal(size=n)
    return x, (logits > 0).astype(np.float64)


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


def _assert_same_trees(port, ref):
    assert port.num_trees == ref.num_trees
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(port.value, ref.value, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.gain, ref.gain, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.threshold_value, ref.threshold_value)
    assert port.init_score == ref.init_score


@pytest.fixture(scope="module")
def data():
    return make_classification()


@pytest.fixture(scope="module")
def jax_booster(data):
    x, y = data
    return _jax(lambda: JaxBooster.train(x, y, JaxOptions(**FIT)))


@pytest.mark.parametrize("bin_dtype", ["int32", "uint8"])
def test_train_and_predict_match_jax(data, jax_booster, bin_dtype):
    x, y = data
    port = Booster.train(x, y, TrainOptions(device="cpu", bin_dtype=bin_dtype, **FIT))
    assert port.device == "cpu"
    _assert_same_trees(port, jax_booster)
    for route in ("host", "device"):
        np.testing.assert_allclose(port.predict(x, device=route),
                                   jax_booster.predict(x, device=route),
                                   rtol=1e-5, atol=1e-6)
    # the two routes of the port add in the same order: equal bits
    np.testing.assert_array_equal(port.predict_raw(x, device="host"),
                                  port.predict_raw(x, device="device"))


def test_estimator_transform_and_metrics_match_jax(data):
    x, y = data
    cut = 1500
    params = dict(num_iterations=10, num_leaves=15)
    jmodel = _jax(lambda: JaxClassifier(**params).fit(
        JaxTable({"features": x[:cut], "label": y[:cut]})))
    model = GBDTClassifier(device="cpu", **params).fit(
        Table({"features": x[:cut], "label": y[:cut]}))
    # 500 held-out rows take the host walk, 2000 rows the batched traversal
    for rows in (slice(cut, None), slice(None)):
        jout = jmodel.transform(JaxTable({"features": x[rows], "label": y[rows]}))
        out = model.transform(Table({"features": x[rows], "label": y[rows]}))
        for col in ("raw_prediction", "probability"):
            np.testing.assert_allclose(out[col], jout[col], rtol=1e-5, atol=1e-6)
            assert out.meta(col) == jout.meta(col)
        np.testing.assert_array_equal(out["prediction"], jout["prediction"])
        cms = dict(scored_labels_col="prediction")
        got = ComputeModelStatistics(**cms).transform(out)
        want = JaxCMS(**cms).transform(jout)
        assert got["accuracy"][0] == want["accuracy"][0] > 0.9
        np.testing.assert_allclose(got["AUC"][0], want["AUC"][0], rtol=1e-12)


def test_cuda_without_a_card_raises(data, monkeypatch):
    x, y = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Booster.train(x, y, TrainOptions(**FIT))          # device defaults to cuda
    with pytest.raises(RuntimeError, match="is_available"):
        GBDTClassifier(num_iterations=2).fit(Table({"features": x, "label": y}))


@pytest.mark.parametrize("opts", [
    dict(checkpoint_dir="ckpt", checkpoint_every_n=2),
    dict(tree_learner="voting_parallel"),
], ids=lambda d: ",".join(d))
def test_options_outside_the_slice_raise(data, opts):
    x, y = data
    kw = {**FIT, "device": "cpu", **opts}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Booster.train(x, y, TrainOptions(**kw))


@pytest.mark.parametrize("params", [
    dict(use_mesh=True),
    dict(elastic_workers=2),
], ids=lambda d: ",".join(d))
def test_estimator_options_outside_the_slice_raise(data, params):
    x, y = data
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GBDTClassifier(device="cpu", num_iterations=2, **params).fit(
            Table({"features": x, "label": y}))
