"""LightGBM's own model.txt in the port (mmlspark_tpu_torch) against the JAX
package, on the CPU: `Booster.from_lightgbm_text`, `to_lightgbm_text`,
`save_native_model(format="lightgbm")` and `load_native_model`'s detection
of the format.

Import: each `model_zoo/gbdt_*.model` gives the JAX package's tree arrays
and BinMapper field for field, and equal scores. Export: a booster carried
into both packages through the JSON format (binary with a nonzero
init_score, multiclass, regression, categorical) writes the same text,
character for character. The hand-written fixtures of
tests/test_external_truth.py (:361, :610; that file is in the slow tier)
give their hand-computed predictions, with its rtol 1e-6, atol 1e-7, and
every refusal raises the JAX package's exception type with its message.
The boosters are fitted by the port: no JAX program is compiled here.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassificationModel, GBDTRegressionModel  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = os.path.join(REPO, "model_zoo")
ZOO_MODELS = ("gbdt_adult_census_synthetic", "gbdt_wdbc", "gbdt_diabetes")
ARRAYS = ("feature", "threshold_bin", "threshold_value", "is_categorical", "cat_bitset",
          "left", "right", "value", "gain", "tree_class")
TOL = dict(rtol=1e-6, atol=1e-7)    # tests/test_external_truth.py:483-486

# tests/test_external_truth.py:361: two trees, raw = leaf(t0) + leaf(t1)
LIGHTGBM_MODEL_TXT = """tree
version=v3
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=2
objective=binary sigmoid:1
feature_names=f0 f1 f2
feature_infos=[-5:5] [-5:5] [-5:5]

Tree=0
num_leaves=3
num_cat=0
split_feature=0 1
split_gain=10 5
threshold=1.5 -0.25
decision_type=2 2
left_child=1 -1
right_child=-3 -2
leaf_value=0.2 -0.1 0.4
leaf_weight=10 10 10
leaf_count=10 10 10
internal_value=0 0
internal_count=30 20
shrinkage=0.1


Tree=1
num_leaves=2
num_cat=0
split_feature=2
split_gain=3
threshold=0.5
decision_type=2
left_child=-1
right_child=-2
leaf_value=-0.05 0.15
leaf_weight=15 15
leaf_count=15 15
internal_value=0
internal_count=30
shrinkage=0.1


end of trees

feature importances:
f0=1
f1=1
f2=1
"""

# tests/test_external_truth.py:610: one categorical split; word 18 = 2^1 +
# 2^4, so categories {1, 4} go left
LIGHTGBM_CAT_MODEL_TXT = """tree
version=v3
num_class=1
num_tree_per_iteration=1
label_index=0
max_feature_idx=1
objective=binary sigmoid:1
feature_names=c0 f1
feature_infos=none none

Tree=0
num_leaves=2
num_cat=1
split_feature=0
split_gain=7
threshold=0
decision_type=1
left_child=-1
right_child=-2
cat_boundaries=0 1
cat_threshold=18
leaf_value=0.6 -0.4
leaf_weight=10 10
leaf_count=10 10
internal_value=0
internal_count=20
shrinkage=0.1

end of trees
"""


def _zoo_text(name):
    with open(os.path.join(ZOO, f"{name}.model")) as fh:
        return fh.read()


def _rows(f, n=400, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)) * 2.0
    x[::17, 0] = np.nan
    return x


def _assert_same_model(port, ref):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
        assert getattr(port, name).dtype == getattr(ref, name).dtype, name
    for name in ("objective", "num_class", "init_score", "feature_names", "class_labels"):
        assert getattr(port, name) == getattr(ref, name), name
    pm, rm = port.bin_mapper, ref.bin_mapper
    for name in ("max_bin", "categorical_indexes", "num_features", "category_maps"):
        assert getattr(pm, name) == getattr(rm, name), name
    for name in ("num_bins", "upper_bounds"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(rm, name), err_msg=name)
        assert getattr(pm, name).dtype == getattr(rm, name).dtype, name


@pytest.mark.parametrize("name", ZOO_MODELS)
def test_zoo_model_imports_as_in_the_jax_package(name):
    text = _zoo_text(name)
    port = Booster.from_lightgbm_text(text, device="cpu")
    ref = JaxBooster.from_lightgbm_text(text)
    assert port.device == "cpu" and port.num_trees == ref.num_trees > 0
    _assert_same_model(port, ref)
    x = _rows(port.num_features)
    want = np.asarray(ref.predict_raw(x, device="host"))
    # the host walk and the batched traversal of the port give the JAX
    # package's host-walk margins bit for bit
    np.testing.assert_array_equal(port.predict_raw(x, device="host"), want)
    np.testing.assert_array_equal(port.predict_raw(x, device="device"), want)
    np.testing.assert_array_equal(port.predict(x, device="host"),
                                  np.asarray(ref.predict(x, device="host")))


def test_zoo_model_exports_the_text_the_jax_package_writes():
    text = _zoo_text("gbdt_wdbc")
    port = Booster.from_lightgbm_text(text, device="cpu")
    assert port.to_lightgbm_text() == JaxBooster.from_lightgbm_text(text).to_lightgbm_text()


def _binary():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(600, 5))
    y = (x[:, 0] - 0.5 * x[:, 1] + 0.3 * rng.normal(size=600) > 0.4).astype(np.float64)
    return x, y, dict(objective="binary", num_leaves=7, num_iterations=4)


def _multiclass():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 5))
    y = ((x[:, 0] > 0.5).astype(int) + (x[:, 1] > 0).astype(int)).astype(np.float64)
    return x, y, dict(objective="multiclass", num_class=3, num_leaves=7, num_iterations=4,
                      min_data_in_leaf=5)


def _regression():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(500, 4))
    y = 3.0 + 2.0 * x[:, 0] - x[:, 1] * x[:, 2] + 0.2 * rng.normal(size=500)
    return x, y, dict(objective="regression", num_leaves=7, num_iterations=4)


def _categorical():
    rng = np.random.default_rng(0)
    cats = rng.integers(0, 7, 2000).astype(np.float64)
    y = np.isin(cats, [1, 2, 5]).astype(np.float64)
    x = np.column_stack([cats, rng.normal(size=2000)])
    return x, y, dict(objective="binary", num_leaves=6, num_iterations=4, min_data_in_leaf=5,
                      categorical_indexes=(0,))


CARRIED = {"binary": _binary, "multiclass": _multiclass, "regression": _regression,
           "categorical": _categorical}


@pytest.fixture(scope="module", params=sorted(CARRIED))
def carried(request):
    x, y, kw = CARRIED[request.param]()
    fitted = Booster.train(x, y, TrainOptions(device="cpu", **kw))
    text = fitted.to_text()
    return request.param, x, Booster.from_text(text, device="cpu"), JaxBooster.from_text(text)


def test_export_equals_the_jax_packages_text(carried):
    name, _, port, ref = carried
    if name == "binary":
        assert port.init_score != 0.0      # folded into tree 0's leaves
    if name == "categorical":
        assert port.is_categorical.any()
    txt = port.to_lightgbm_text()
    assert txt == ref.to_lightgbm_text()
    if name == "multiclass":
        assert "num_class=3" in txt and "num_tree_per_iteration=3" in txt
    if name == "categorical":
        assert "cat_boundaries=" in txt and "cat_threshold=" in txt


def test_export_round_trips_through_both_importers(carried):
    """tests/test_external_truth.py:466-531: the exported text reloads with
    the model's predictions, in the port as in the JAX package."""
    name, x, port, _ = carried
    txt = port.to_lightgbm_text()
    again = Booster.from_lightgbm_text(txt, device="cpu")
    _assert_same_model(again, JaxBooster.from_lightgbm_text(txt))
    probe = x[:500]
    if name == "categorical":       # an unseen category and NaN route right
        probe = np.vstack([probe, [[99.0, 0.0], [np.nan, 0.0]]])
    tol = dict(rtol=1e-5, atol=1e-6) if name == "multiclass" else TOL
    np.testing.assert_allclose(again.predict(probe), port.predict(probe), **tol)
    assert again.feature_names == [f"Column_{j}" for j in range(x.shape[1])]


def test_hand_computed_predictions():
    """tests/test_external_truth.py:396-415 and :644-646 on the port."""
    b = Booster.from_lightgbm_text(LIGHTGBM_MODEL_TXT, device="cpu")
    assert (b.objective, b.num_trees, b.feature_names) == ("binary", 2, ["f0", "f1", "f2"])
    rows = np.array([[0.0, -1.0, 0.0], [0.0, 0.5, 1.0], [2.0, 9.9, 0.5], [1.5, -0.25, 0.6]])
    want_raw = np.array([0.2 - 0.05, -0.1 + 0.15, 0.4 - 0.05, 0.2 + 0.15])
    for route in ("host", "device"):
        np.testing.assert_allclose(b.predict_raw(rows, device=route), want_raw, **TOL)
        np.testing.assert_allclose(b.predict(rows, device=route),
                                   1.0 / (1.0 + np.exp(-want_raw)), **TOL)
    # +-inf bin by comparison, NaN takes the missing bin (left)
    inf = np.inf
    rows = np.array([[inf, 0.0, -inf], [-inf, -1.0, inf], [np.nan, np.nan, np.nan]])
    np.testing.assert_allclose(b.predict_raw(rows), [0.4 - 0.05, 0.2 + 0.15, 0.2 - 0.05], **TOL)
    # the fused bin -> traverse program gives the same margins
    params, fn = b.device_predict_fn()
    np.testing.assert_array_equal(fn(params, rows).numpy(), b.predict_raw(rows, device="device"))
    # and the JSON format keeps them
    x = np.random.default_rng(1).normal(size=(100, 3)) * 3
    np.testing.assert_array_equal(Booster.from_text(b.to_text(), device="cpu").predict(x),
                                  b.predict(x))


def test_hand_computed_categorical_predictions():
    b = Booster.from_lightgbm_text(LIGHTGBM_CAT_MODEL_TXT, device="cpu")
    rows = np.array([[1.0, 0.0], [4.0, 9.9], [0.0, 0.0], [2.0, 0.0], [40.0, 0.0], [np.nan, 0.0]])
    want_raw = np.array([0.6, 0.6, -0.4, -0.4, -0.4, -0.4])
    for route in ("host", "device"):
        np.testing.assert_allclose(b.predict_raw(rows, device=route), want_raw, **TOL)
    np.testing.assert_allclose(b.predict(rows), 1.0 / (1.0 + np.exp(-want_raw)), **TOL)
    probe = np.array([[1.0, 0.0], [3.0, 0.0], [4.0, 1.0], [7.0, 2.0]])
    np.testing.assert_array_equal(Booster.from_text(b.to_text(), device="cpu").predict(probe),
                                  b.predict(probe))
    again = Booster.from_lightgbm_text(b.to_lightgbm_text(), device="cpu")
    np.testing.assert_allclose(again.predict(probe), b.predict(probe), **TOL)
    with pytest.raises(ValueError, match="categorical"):
        b.device_predict_fn()


def _replace(old, new, text=LIGHTGBM_MODEL_TXT):
    assert old in text
    return text.replace(old, new)


REFUSED_TEXTS = {
    "average_output": _replace("feature_names=f0", "average_output\nfeature_names=f0"),
    "linear_tree": _replace("feature_names=f0", "linear_tree=1\nfeature_names=f0"),
    "leaf_coeff": _replace("shrinkage=0.1\n\n\nTree=1", "leaf_coeff=0.5 0 0\nshrinkage=0.1\n\n\n"
                           "Tree=1"),
    "nan_right": _replace("decision_type=2 2", "decision_type=8 2"),
    "missing_zero": _replace("decision_type=2 2", "decision_type=6 2"),
    "malformed_categorical": _replace("decision_type=2 2", "decision_type=3 2"),
    "nonunit_sigmoid": _replace("objective=binary sigmoid:1", "objective=binary sigmoid:2"),
    "unknown_objective": _replace("objective=binary sigmoid:1", "objective=lambdarank"),
    "not_a_model": "hello\nworld\n",
    "malformed_block": _replace("leaf_value=-0.05 0.15\n", ""),
    # feature 0 split as a category in tree 0 and by a threshold in tree 1
    "mixed_feature": _replace("end of trees", "Tree=1\nnum_leaves=2\nnum_cat=0\n"
                              "split_feature=0\nsplit_gain=1\nthreshold=0.5\ndecision_type=2\n"
                              "left_child=-1\nright_child=-2\nleaf_value=0.1 -0.1\n"
                              "shrinkage=1\n\nend of trees", LIGHTGBM_CAT_MODEL_TXT),
}


def _raised(fn):
    with pytest.raises(Exception) as ei:
        fn()
    return type(ei.value), str(ei.value)


@pytest.mark.parametrize("case", sorted(REFUSED_TEXTS))
def test_import_refuses_as_the_jax_package_does(case):
    text = REFUSED_TEXTS[case]
    got = _raised(lambda: Booster.from_lightgbm_text(text, device="cpu"))
    want = _raised(lambda: JaxBooster.from_lightgbm_text(text))
    assert got == want
    assert got[0] is ValueError


def test_export_refuses_non_integer_categories_as_the_jax_package_does():
    """tests/test_external_truth.py:516-531 on the port."""
    rng = np.random.default_rng(2)
    cats = rng.choice([0.5, 1.5, 2.5, 3.5], 1000)
    y = np.isin(cats, [0.5, 2.5]).astype(np.float64)
    x = np.column_stack([cats, rng.normal(size=1000)])
    b = Booster.train(x, y, TrainOptions(objective="binary", num_leaves=4, num_iterations=2,
                                         min_data_in_leaf=5, categorical_indexes=(0,),
                                         device="cpu"))
    got = _raised(b.to_lightgbm_text)
    assert got[0] is ValueError and "non-integer" in got[1]
    assert got == _raised(JaxBooster.from_text(b.to_text()).to_lightgbm_text)


def test_export_refuses_an_unseen_category_routed_left_as_the_jax_package_does():
    b = Booster.from_lightgbm_text(LIGHTGBM_CAT_MODEL_TXT, device="cpu")
    b.cat_bitset[0, 0, 0] = True        # the other bin would go left
    got = _raised(b.to_lightgbm_text)
    assert got[0] is ValueError and "unseen" in got[1]
    assert got == _raised(JaxBooster.from_text(b.to_text()).to_lightgbm_text)


@pytest.mark.parametrize("fmt", ["json", "lightgbm"])
def test_load_native_model_detects_the_format(tmp_path, fmt):
    b = Booster.from_lightgbm_text(LIGHTGBM_MODEL_TXT, device="cpu")
    path = str(tmp_path / f"model.{fmt}")
    b.save_native_model(path, format=fmt)
    with open(path) as fh:
        head = fh.read(5)
    assert head.startswith("{" if fmt == "json" else "tree\n")
    loaded = Booster.load_native_model(path, device="cpu")
    assert loaded.device == "cpu"
    x = np.random.default_rng(0).normal(size=(50, 3))
    np.testing.assert_array_equal(loaded.predict(x), b.predict(x))
    # the JAX package reads the port's file
    np.testing.assert_array_equal(np.asarray(JaxBooster.load_native_model(path).predict(x)),
                                  b.predict(x))
    with pytest.raises(ValueError, match="format must be"):
        b.save_native_model(path, format="xgboost")


def test_estimator_models_load_lightgbm_text():
    path = os.path.join(ZOO, "gbdt_wdbc.model")
    clf = GBDTClassificationModel.load_native_model(path, device="cpu")
    assert clf.booster.objective == "binary" and list(clf.classes) == [0.0, 1.0]
    reg = GBDTRegressionModel.load_native_model(os.path.join(ZOO, "gbdt_diabetes.model"),
                                                device="cpu")
    assert reg.booster.objective == "regression" and reg.booster.num_trees > 0
