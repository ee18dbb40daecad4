"""Categorical splits of the port's GBDT fit (mmlspark_tpu_torch) against the
JAX package's, on the CPU: LightGBM's many-vs-many sorted-subset search,
its per-node bitsets, and the routing of unseen categories and NaN.

The cases of tests/test_gbdt.py:264-340 run on the port with that file's
own assertions, and each is held tree for tree against the JAX package:
splits, `is_categorical` and `cat_bitset` equal, leaf values within rtol
1e-5, atol 1e-7 and gains within rtol 1e-5 (tests/test_torch_gbdt_fit.py's
tolerance). Those data sets are separable by their categorical column:
once a tree has used it, every further split has zero gain in exact
arithmetic, and f32 rounding leaves gains of ~1e-4 whose argmax follows
each package's order of sums. So the trees are held at min_gain_to_split
0.01, which keeps every split of real gain. Fits on noisy data (the
estimator, multiclass, goss, 600 categories) are held by
`chip_smoke.compare_fits`: equal trees, or trees that part only at a
near-tie (gains within 1e-5) whose two splits route every row alike,
bitsets included; there two categories whose grad/hess ratios differ by
rounding can swap across the end of a prefix. The JAX side runs under
kernel mode "xla" (one case under "xla_scatter", which says why),
restored in `finally`.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.gbdt import GBDTClassifier as JaxClassifier  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassifier  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

TREE_FIELDS = ("feature", "threshold_bin", "left", "right", "is_categorical", "cat_bitset")


def _jax(fn, mode="xla"):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode(mode)
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


def _fit_both(x, y, mode="xla", **kw):
    port = Booster.train(x, y, TrainOptions(device="cpu", **kw))
    ref = _jax(lambda: JaxBooster.train(x, y, JaxOptions(**kw)), mode)
    return port, ref


def _assert_same_trees(port, ref):
    assert port.num_trees == ref.num_trees
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(port.value, ref.value, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.gain, ref.gain, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.threshold_value, ref.threshold_value)


def _assert_compared(port, ref, x, min_trees):
    out = chip_smoke.compare_fits(ref, port, port.bin_mapper.transform(x))
    assert out["trees_compared"] >= min_trees, out["near_ties"]
    return out


def _split_cat_nodes(b):
    return b.is_categorical & (b.feature >= 0)


def _five_categories():
    rng = np.random.default_rng(3)
    cat = rng.integers(0, 5, size=2000).astype(np.float64)
    y = np.isin(cat, [1.0, 3.0]).astype(np.float64)
    return np.stack([cat, rng.normal(size=2000)], axis=1), y


def _planted_subset():
    rng = np.random.default_rng(0)
    cats = rng.integers(0, 10, 4000).astype(np.float64)
    y = np.isin(cats, [0, 3, 5, 8]).astype(np.float64)
    return np.column_stack([cats, rng.normal(size=4000)]), y


PLANTED = dict(objective="binary", num_iterations=3, num_leaves=4, categorical_indexes=(0,),
               min_data_in_leaf=5, learning_rate=0.5)


def test_five_category_fit():
    x, y = _five_categories()
    kw = dict(objective="binary", num_iterations=20, num_leaves=7, categorical_indexes=(0,),
              min_data_in_leaf=5)
    b = Booster.train(x, y, TrainOptions(device="cpu", **kw))
    assert ((b.predict(x) >= 0.5) == y).mean() > 0.98
    port, ref = _fit_both(x, y, min_gain_to_split=0.01, **kw)
    _assert_same_trees(port, ref)
    assert _split_cat_nodes(port).any()
    np.testing.assert_allclose(port.predict(x), ref.predict(x), rtol=1e-5, atol=1e-6)


def test_planted_four_of_ten_subset_separates_in_one_split():
    x, y = _planted_subset()
    b = Booster.train(x, y, TrainOptions(device="cpu", **PLANTED))
    assert ((b.predict(x) >= 0.5) == y).mean() > 0.999
    # the first split is the subset itself, which one-vs-rest cannot give
    assert bool(b.is_categorical[0, 0])
    assert int(b.cat_bitset[0, 0].sum()) == 4
    # the JAX package under "xla_scatter", whose histogram adds rows in row
    # order as histogram_torch does: under "xla" (a one-hot product) the
    # second tree's root gain, 1354.1212 in f64, is 1354.1277 there and
    # 1354.1136 here, 1.04e-5 apart; the JAX package's two variants part
    # by the same
    port, ref = _fit_both(x, y, mode="xla_scatter", min_gain_to_split=0.01, **PLANTED)
    _assert_same_trees(port, ref)
    assert int(port.cat_bitset[0, 0].sum()) == 4


def test_unseen_categories_and_nan_route_right():
    x, y = _planted_subset()
    port, ref = _fit_both(x, y, **PLANTED)
    # bin 0 (other, unseen, NaN) is never in a left set
    assert not port.cat_bitset[..., 0].any()
    probe = np.array([[42.0, 0.0], [np.nan, 0.0], [-7.0, 0.0]])
    p = port.predict(probe)
    assert p[0] == p[1] == p[2]
    np.testing.assert_allclose(p, ref.predict(probe), rtol=1e-5, atol=1e-6)
    # the root sends bin 0 right: an unseen row's walk goes through the
    # root's right child
    leaf = port.predict_leaf(probe[:1])[0, 0]
    assert leaf != port.left[0, 0] and leaf >= port.right[0, 0]


def test_max_cat_threshold_caps_the_smaller_side():
    rng = np.random.default_rng(1)
    cats = rng.integers(0, 8, 3000).astype(np.float64)
    y = np.isin(cats, [1, 4, 6]).astype(np.float64)
    x = np.column_stack([cats, rng.normal(size=3000)])
    kw = dict(objective="binary", num_iterations=4, num_leaves=8, categorical_indexes=(0,),
              min_data_in_leaf=5, max_cat_threshold=1)
    b = Booster.train(x, y, TrainOptions(device="cpu", **kw))
    sizes = b.cat_bitset[_split_cat_nodes(b)].sum(axis=-1)
    assert _split_cat_nodes(b).any() and (np.minimum(sizes, 8 - sizes) <= 1).all(), sizes
    port, ref = _fit_both(x, y, min_gain_to_split=0.01, **kw)
    _assert_same_trees(port, ref)


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_uint8_bins_give_the_int32_model(boosting):
    rng = np.random.default_rng(4)
    cats = rng.integers(0, 7, 2000).astype(np.float64)
    x = np.column_stack([rng.normal(size=(2000, 5)), cats])
    y = ((x[:, 0] > 0) ^ np.isin(cats, [1, 4])).astype(np.float64)
    kw = dict(objective="binary", boosting_type=boosting, num_iterations=8, num_leaves=15,
              categorical_indexes=(5,), min_data_in_leaf=5)
    b32 = Booster.train(x, y, TrainOptions(device="cpu", **kw))
    b8 = Booster.train(x, y, TrainOptions(device="cpu", bin_dtype="uint8", **kw))
    assert b8.to_text() == b32.to_text()
    port, ref = _fit_both(x, y, min_gain_to_split=0.01, **kw)
    _assert_same_trees(port, ref)
    assert _split_cat_nodes(port).any()


# the Adult schema (chip_smoke.make_adult_categorical, the data of the
# smoke's slice_categorical) at a CPU test's size
ADULT_X, ADULT_Y = chip_smoke.make_adult_categorical(3000, seed=5)
ADULT_CAT = list(chip_smoke.ADULT_CATEGORICAL)


def test_estimator_fits_and_scores_categorical_slots_as_jax_does():
    cut = 2400
    params = dict(num_iterations=8, num_leaves=15, categorical_slot_indexes=ADULT_CAT)
    train = dict(features=ADULT_X[:cut], label=ADULT_Y[:cut])
    model = GBDTClassifier(device="cpu", **params).fit(Table(train))
    jmodel = _jax(lambda: JaxClassifier(**params).fit(JaxTable(train)))
    _assert_compared(model.booster, jmodel.booster, ADULT_X[:cut], min_trees=8)
    assert _split_cat_nodes(model.booster).any()
    assert (model.booster.cat_bitset[_split_cat_nodes(model.booster)].sum(-1) > 1).any()
    held = dict(features=ADULT_X[cut:], label=ADULT_Y[cut:])
    out = model.transform(Table(held))
    jout = jmodel.transform(JaxTable(held))
    np.testing.assert_allclose(out["probability"], jout["probability"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out["prediction"], jout["prediction"])


@pytest.mark.parametrize("kw", [
    dict(objective="multiclass", num_class=3),
    dict(objective="binary", boosting_type="goss"),
], ids=["multiclass", "goss"])
def test_multiclass_and_goss_grow_the_jax_packages_categorical_trees(kw):
    x, y = ADULT_X[:2000], ADULT_Y[:2000]
    if kw["objective"] == "multiclass":
        y = y + (x[:, chip_smoke.ADULT_COLUMNS.index("sex")] == 1)
    port, ref = _fit_both(x, y, num_iterations=4, num_leaves=15, categorical_indexes=ADULT_CAT,
                          **kw)
    _assert_compared(port, ref, x, min_trees=2)
    assert _split_cat_nodes(port).any()


def test_categorical_model_round_trips_through_json():
    x, y = ADULT_X[:1500], ADULT_Y[:1500]
    b = Booster.train(x, y, TrainOptions(device="cpu", objective="binary", num_iterations=5,
                                         num_leaves=15, categorical_indexes=ADULT_CAT))
    assert _split_cat_nodes(b).any()
    text = b.to_text()
    back = Booster.from_text(text, device="cpu")
    np.testing.assert_array_equal(back.cat_bitset, b.cat_bitset)
    for route in ("host", "device"):
        np.testing.assert_array_equal(back.predict_raw(x, device=route),
                                      b.predict_raw(x, device=route))
    # the JAX package reads the port's file and scores it alike
    jb = JaxBooster.from_text(text)
    np.testing.assert_allclose(jb.predict_raw(x), b.predict_raw(x), rtol=1e-6, atol=1e-6)


def test_600_categories_at_max_bin_511():
    # more categories than max_bin keeps: the 511 most frequent get bins
    # 1..511, the rest fall in bin 0 with unseen ones; 512 bins
    rng = np.random.default_rng(5)
    n = 6000
    z = chip_smoke._zipf_codes(rng, n, 600, 1.1)
    y = (rng.normal(size=600)[z] + 0.8 * rng.normal(size=n) > 0).astype(np.float64)
    x = np.column_stack([z.astype(np.float64), rng.normal(size=n)])
    port, ref = _fit_both(x, y, objective="binary", num_iterations=6, num_leaves=15,
                          max_bin=511, categorical_indexes=(0,))
    assert port.bin_mapper.num_bins[0] == 512 and port.cat_bitset.shape[-1] == 512
    _assert_compared(port, ref, x, min_trees=1)
    assert (port.cat_bitset[_split_cat_nodes(port)].sum(-1) > 1).any()


@pytest.mark.parametrize("route", ["host", "device"])
def test_version_1_one_vs_rest_models_route_as_jax_does(route):
    # tests/test_gbdt.py:468-503: a version-1 file's categorical split is
    # one-vs-rest on its threshold bin; bins above it go right
    import json

    payload = {
        "format": "mmlspark_tpu.gbdt", "version": 1, "objective": "regression",
        "num_class": 1, "init_score": 0.0, "best_iteration": -1, "feature_names": [],
        "class_labels": None, "tree_class": [0],
        "trees": {"feature": [[0, -1, -1]], "threshold_bin": [[5, 0, 0]],
                  "threshold_value": [[5.0, 0.0, 0.0]],
                  "is_categorical": [[True, False, False]],
                  "left": [[1, -1, -1]], "right": [[2, -1, -1]],
                  "value": [[0.0, 1.0, -1.0]], "gain": [[1.0, 0.0, 0.0]]},
        "bin_mapper": {"max_bin": 16, "categorical_indexes": [0], "num_features": 1,
                       "num_bins": [10], "upper_bounds": [[np.inf] * 11],
                       "category_maps": {"0": {str(float(v)): v + 1 for v in range(9)}}},
    }
    text = json.dumps(payload)
    probe = np.array([[4.0], [7.0], [0.0], [np.nan]])
    got = Booster.from_text(text, device="cpu").predict(probe, device=route)
    np.testing.assert_allclose(got, [1.0, -1.0, -1.0, -1.0])
    np.testing.assert_array_equal(got, JaxBooster.from_text(text).predict(probe, device=route))
