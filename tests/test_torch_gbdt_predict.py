"""Device binning and the fused bin -> traverse scoring program of the port
(mmlspark_tpu_torch) against the JAX package's, on the CPU.

- `BinMapper.transform_device` equals the JAX `transform_device` bit for
  bit, NaN, +-inf and single-bin columns included;
- a `device_binning=True` fit snaps the boundaries through f32 and grows
  the JAX package's trees;
- `Booster.device_predict_fn` equals the port's own
  `predict_raw(device="device")` bit for bit on f32-representable values,
  and, on the JAX model carried into the port, the JAX package's own fused
  program bit for bit;
- `truncated`, `predict_leaf`, `num_iteration` and the importances match.

The JAX side runs under kernel mode "xla", restored in `finally`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.gbdt.binning import BinMapper as JaxMapper  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTRegressor  # noqa: E402
from mmlspark_tpu_torch.gbdt.binning import BinMapper  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions, booster_from_arrays  # noqa: E402,E501
from mmlspark_tpu_torch.core import Table  # noqa: E402

TREE_FIELDS = ("feature", "threshold_bin", "left", "right", "is_categorical", "tree_class")
CARRIED = ("feature", "threshold_bin", "is_categorical", "left", "right", "value", "gain",
           "cat_bitset", "tree_class")


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


def _data(n=1500, f=8, seed=7):
    """Continuous, discrete, constant and partly missing columns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[:, 3] = np.round(np.abs(x[:, 3]) * 4)            # a few distinct values
    x[:, 5] = np.nan                                   # no finite value: nb <= 1
    x[rng.random(n) < 0.05, 2] = np.nan
    y = x[:, 0] - 0.7 * x[:, 1] + 0.4 * x[:, 3] + 0.3 * rng.normal(size=n)
    return x, y


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.mark.parametrize("max_bin", [255, 15])
def test_transform_device_equals_jax_bit_for_bit(data, max_bin):
    x, _ = data
    probe = x.copy()
    probe[:4, 0] = [np.inf, -np.inf, np.nan, 1e30]
    probe[4:8, 4] = [np.inf, -np.inf, np.nan, -1e30]
    jm = JaxMapper(max_bin=max_bin).fit(x)
    tm = BinMapper.from_dict(jm.to_dict())
    want = np.asarray(jm.transform_device(probe))
    got = tm.transform_device(probe, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 5] == 0).all()                      # the single-bin column
    # with boundaries snapped through f32, device and host binning agree on
    # f32 values (a value between two f32 neighbours of a boundary may not)
    tm.upper_bounds = np.float64(np.float32(tm.upper_bounds))
    probe32 = probe.astype(np.float32)
    np.testing.assert_array_equal(tm.transform_device(probe32, device="cpu").numpy(),
                                  tm.transform(probe32.astype(np.float64)))


def test_transform_device_refuses_categorical_maps(data):
    x, _ = data
    mapper = BinMapper(categorical_indexes=(3,)).fit(x)
    assert mapper.category_maps
    with pytest.raises(ValueError, match="categorical"):
        mapper.transform_device(x, device="cpu")


@pytest.mark.parametrize("bin_dtype", ["int32", "uint8"])
def test_device_binning_fit_matches_jax(data, bin_dtype):
    x, y = data
    kw = dict(objective="regression", num_iterations=8, num_leaves=15, device_binning=True,
              bin_dtype=bin_dtype)
    ref = _jax(lambda: JaxBooster.train(x, y, JaxOptions(**kw)))
    port = Booster.train(x, y, TrainOptions(device="cpu", **kw))
    np.testing.assert_array_equal(port.bin_mapper.upper_bounds, ref.bin_mapper.upper_bounds)
    assert np.array_equal(port.bin_mapper.upper_bounds,
                          np.float64(np.float32(port.bin_mapper.upper_bounds)))
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(port.value, ref.value, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(port.threshold_value, ref.threshold_value)
    # the host-binned fit of the same data: boundaries not snapped
    host = Booster.train(x, y, TrainOptions(device="cpu", **{**kw, "device_binning": False}))
    assert not np.array_equal(host.bin_mapper.upper_bounds, port.bin_mapper.upper_bounds)


@pytest.fixture(scope="module", params=["regression", "binary", "multiclass"])
def boosters(request, data):
    x, y = data
    kw = dict(objective=request.param, num_iterations=66, num_leaves=7)
    if request.param == "binary":
        y = (y > 0).astype(float)
    elif request.param == "multiclass":
        y = np.digitize(y, [-1.0, 0.0, 1.0]).astype(float)
        kw.update(num_class=4, num_iterations=17)
    ref = _jax(lambda: JaxBooster.train(x, y, JaxOptions(**kw)))
    return Booster.train(x, y, TrainOptions(device="cpu", **kw)), ref


def test_device_predict_fn_equals_predict_raw_bit_for_bit(data, boosters):
    x, _ = data
    port, ref = boosters
    # 66 trees (68 in 4 classes): two blocks of 64, the second padded
    params, fn = port.device_predict_fn()
    assert set(params) == {"keys", "nb", "trees"} and params["keys"].dtype == torch.float32
    assert params["trees"]["feature"].shape[1] == 64
    x32 = x.astype(np.float32)
    got = fn(params, x32)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    want = port.predict_raw(x32, device="device")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fn(params, torch.from_numpy(x32)).numpy(), want)
    # the reference's model carried into the port scores as the
    # reference's fused program does, bit for bit (the two fits may part at
    # a near-tied split on an empty-bin run, ROADMAP Queue 3, which an f32
    # rounded value can fall into)
    carried = booster_from_arrays({k: getattr(ref, k) for k in CARRIED},
                                  ref.bin_mapper.to_dict(),
                                  {"objective": ref.objective, "num_class": ref.num_class,
                                   "init_score": ref.init_score, "class_labels": None},
                                  device="cpu")
    jparams, jfn = ref.device_predict_fn()
    cparams, cfn = carried.device_predict_fn()
    np.testing.assert_array_equal(cfn(cparams, x32).numpy(),
                                  np.asarray(jfn(jparams, jnp.asarray(x32))))


def test_truncated_and_num_iteration_match_jax(data, boosters):
    x, _ = data
    port, ref = boosters
    per_round = port.num_class if port.objective == "multiclass" else 1
    for n in (1, 2, 5):
        view = port.truncated(n)
        assert view.num_trees == ref.truncated(n).num_trees == n * per_round
        assert port.truncated(n) is view                         # cached
        for route in ("host", "device"):
            got = port.predict_raw(x, device=route, num_iteration=n)
            np.testing.assert_array_equal(got, view.predict_raw(x, device=route))
            np.testing.assert_allclose(got, ref.predict_raw(x, device=route, num_iteration=n),
                                       rtol=1e-5, atol=1e-5)
    assert port.truncated(0) is port and port.truncated(None) is port


def test_predict_leaf_and_importances_match_jax(data, boosters):
    x, _ = data
    port, ref = boosters
    leaf = port.predict_leaf(x)
    assert leaf.shape == (len(x), port.num_trees) and leaf.dtype == np.int32
    np.testing.assert_array_equal(leaf, ref.predict_leaf(x))
    # the leaves' values added in tree order are the host walk's margins
    k = port.num_class
    acc = (np.zeros((len(x), k), np.float32) if k > 1
           else np.full(len(x), port.init_score, np.float32))
    for t in range(port.num_trees):
        val = port.value[t][leaf[:, t]]
        if k > 1:
            acc[:, port.tree_class[t]] += val
        else:
            acc = acc + val
    np.testing.assert_array_equal(acc, port.predict_raw(x, device="host"))
    np.testing.assert_array_equal(port.feature_importances("split"),
                                  ref.feature_importances("split"))
    np.testing.assert_allclose(port.feature_importances("gain"),
                               ref.feature_importances("gain"), rtol=1e-4)
    with pytest.raises(ValueError, match="importance_type"):
        port.feature_importances("cover")


def test_regressor_importances_and_native_scorer(data):
    x, y = data
    model = GBDTRegressor(num_iterations=10, num_leaves=7, device="cpu").fit(
        Table({"features": x, "label": y}))
    imp = model.get_feature_importances()
    assert imp == list(model.booster.feature_importances("split")) and sum(imp) > 0
    score = model.native_score_fn()
    np.testing.assert_array_equal(score(x[:20]),
                                  model.transform(Table({"features": x[:20]}))["prediction"])
    # since fusion came (core/fusion.py), the regressor's kernel is the
    # fused bin -> traverse program
    kernel = model.device_kernel()
    assert kernel.kernel_label == "fused_traverse"
    assert kernel.input_cols == ("features",) and kernel.output_cols == ("prediction",)
