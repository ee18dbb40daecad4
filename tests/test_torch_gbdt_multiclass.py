"""The port's multiclass fit (mmlspark_tpu_torch) against the JAX package's,
on the CPU: K trees a round, one objective call on the (n, K) margins, the
trees in class order.

Data: tests/test_gbdt.py's `make_classification(classes=4)` (chip_smoke.py's
copy); 20 rounds, 15
leaves. Trees and their classes must be equal, but for near-tied splits
on a run of empty bins (ROADMAP.md Queue 3): at three nodes (trees 19, 47
and 68) the two packages take the first and the last bin of a run that
holds no training row of the node, at gains 1e-6 apart, so both route
every training row alike. `_assert_same_trees` asserts exactly that for
every node where the trees part. Leaf values and margins agree within
rtol 1e-5, as test_torch_gbdt_fit.py holds them; the estimators give the
same predictions and metrics on the rows they were fitted on. The JAX side
runs under kernel mode "xla", restored in `finally`.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.automl.metrics import ComputeModelStatistics as JaxCMS  # noqa: E402
from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.gbdt import GBDTClassifier as JaxClassifier  # noqa: E402
from mmlspark_tpu.gbdt import objectives as jobj  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu_torch.automl import ComputeModelStatistics  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassifier  # noqa: E402
from mmlspark_tpu_torch.gbdt import objectives as tobj  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

K = 4
FIT = dict(objective="multiclass", num_class=K, num_iterations=20, num_leaves=15)
TREE_FIELDS = ("feature", "left", "right", "is_categorical", "tree_class")


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


def _assert_same_trees(port, ref, x):
    """Equal trees, but where they part at a near tie that routes every
    training row of the node alike (chip_smoke.compare_fits, slice_parity's
    rule). Returns the ties."""
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    parity = chip_smoke.compare_fits(port, ref, port.bin_mapper.transform(x))
    assert parity["trees_compared"] == port.num_trees, parity["near_ties"]
    return [(tie["tree"], tie["node"]) for tie in parity["near_ties"]]


@pytest.fixture(scope="module")
def data():
    return chip_smoke.make_classification(classes=K)


@pytest.fixture(scope="module")
def fits(data):
    x, y = data
    ref = _jax(lambda: JaxBooster.train(x, y, JaxOptions(**FIT)))
    port = Booster.train(x, y, TrainOptions(device="cpu", **FIT))
    return port, ref


def test_softmax_gradients_match_jax():
    rng = np.random.default_rng(3)
    raw = rng.normal(size=(300, K)).astype(np.float32)
    onehot = np.eye(K, dtype=np.float32)[rng.integers(0, K, 300)]
    jg, jh = jobj.get_objective("multiclass")(jnp.asarray(onehot), jnp.asarray(raw))
    tg, th = tobj.get_objective("multiclass")(torch.from_numpy(onehot), torch.from_numpy(raw))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-7)


def test_multiclass_trees_match_jax(data, fits):
    port, ref = fits
    assert port.num_class == ref.num_class == K
    assert port.num_trees == ref.num_trees == 20 * K
    np.testing.assert_array_equal(port.tree_class, np.tile(np.arange(K), 20))
    parted = _assert_same_trees(port, ref, data[0])
    assert len(parted) <= 3, parted          # the ties named in the docstring
    np.testing.assert_allclose(port.value, ref.value, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.gain, ref.gain, rtol=1e-4, atol=1e-5)
    assert port.init_score == ref.init_score == 0.0


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("num_iteration", [None, 5])
def test_multiclass_margins_match_jax(data, fits, route, num_iteration):
    x, _ = data
    port, ref = fits
    got = port.predict_raw(x, device=route, num_iteration=num_iteration)
    want = ref.predict_raw(x, device=route, num_iteration=num_iteration)
    assert got.shape == (len(x), K)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    prob = port.predict(x, device=route, num_iteration=num_iteration)
    np.testing.assert_allclose(prob.sum(-1), 1.0, atol=1e-12)
    # the port's routes add in the same order: equal bits
    np.testing.assert_array_equal(got, port.predict_raw(
        x, device="host" if route == "device" else "device", num_iteration=num_iteration))


def test_multiclass_estimator_matches_jax(data):
    x, y = data
    cut = 1500
    params = dict(num_iterations=20, num_leaves=15)
    jmodel = _jax(lambda: JaxClassifier(**params).fit(
        JaxTable({"features": x[:cut], "label": y[:cut]})))
    model = GBDTClassifier(device="cpu", **params).fit(
        Table({"features": x[:cut], "label": y[:cut]}))
    assert model.booster.objective == "multiclass" and model.booster.num_class == K
    _assert_same_trees(model.booster, jmodel.booster, x[:cut])
    # the fitted rows: a near tie routes every one of them alike (1,500
    # rows take the batched traversal)
    jout = jmodel.transform(JaxTable({"features": x[:cut], "label": y[:cut]}))
    out = model.transform(Table({"features": x[:cut], "label": y[:cut]}))
    for col in ("raw_prediction", "probability"):
        np.testing.assert_allclose(out[col], jout[col], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out["prediction"], jout["prediction"])
    cms = dict(scored_labels_col="prediction")
    got = ComputeModelStatistics(**cms).transform(out)
    want = JaxCMS(**cms).transform(jout)
    assert got["accuracy"][0] == want["accuracy"][0] > 0.8
    for name in ("macro_precision", "macro_recall"):
        assert got[name][0] == want[name][0]
