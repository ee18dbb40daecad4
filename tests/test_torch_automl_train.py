"""The port's featurize-then-fit trainers (mmlspark_tpu_torch.automl.train:
TrainClassifier, TrainRegressor and their models) against the JAX
package's, on the CPU, along examples/07_tabular_pipeline.py's path: its
census CSV (4,000 rows, a few wage cells blank) -> read_csv ->
CleanMissingData -> TrainClassifier / TrainRegressor(GBDT, 10 rounds of 15
leaves). The featurized matrices are equal bit for bit; the trees follow
tests/test_torch_gbdt_fit.py's rule (split fields equal, values within rtol
1e-5); predictions agree within rtol 1e-5, atol 1e-6 (tests/test_gbdt.py:900)
and decoded labels are equal; saved models load across the packages; a fit
from Cacher'd columns is the fit of the f32-rounded matrix."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import mmlspark_tpu.ops as ref_ops  # noqa: E402
from mmlspark_tpu.automl import TrainClassifier as RefTrainClassifier  # noqa: E402
from mmlspark_tpu.automl import TrainRegressor as RefTrainRegressor  # noqa: E402
from mmlspark_tpu.core import Pipeline as RefPipeline  # noqa: E402
from mmlspark_tpu.core import kernels as ref_kernels  # noqa: E402
from mmlspark_tpu.core import read_csv as ref_read_csv  # noqa: E402
from mmlspark_tpu.core import serialize as ref_serialize  # noqa: E402
from mmlspark_tpu.core.schema import Table as RefTable  # noqa: E402
from mmlspark_tpu.gbdt import GBDTClassifier as RefClassifier  # noqa: E402
from mmlspark_tpu.gbdt import GBDTRegressor as RefRegressor  # noqa: E402
import mmlspark_tpu_torch.ops as ops  # noqa: E402
from mmlspark_tpu_torch.automl import (  # noqa: E402
    TrainClassifier,
    TrainedClassifierModel,
    TrainedRegressorModel,
    TrainRegressor,
)
from mmlspark_tpu_torch.core import Pipeline, Table, read_csv, serialize  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassifier, GBDTRegressor  # noqa: E402
from test_torch_tabular_common import assert_same_table, assert_same_value  # noqa: E402

TREE_FIELDS = ("feature", "threshold_bin", "left", "right", "is_categorical")
FIT = dict(num_iterations=10, num_leaves=15)


def write_census_csv(path, n=4_000, seed=11):
    """examples/07_tabular_pipeline.py's writer, with ~2% of the wage cells
    left blank (missing numbers for CleanMissingData)."""
    rng = np.random.default_rng(seed)
    age = rng.integers(18, 80, n)
    wage = rng.normal(45_000, 12_000, n)
    edu = rng.choice(["HS", "BS", "MS", "PhD"], n, p=[0.4, 0.35, 0.18, 0.07])
    edu_boost = {"HS": 0.0, "BS": 0.6, "MS": 1.0, "PhD": 1.5}
    z = (0.02 * (age - 40) + (wage - 45_000) / 20_000
         + np.vectorize(edu_boost.get)(edu) + rng.normal(0, 0.45, n))
    label = (z > 0.5).astype(int)
    blank = rng.random(n) < 0.02
    with open(path, "w") as fh:
        fh.write("age,wage,education,income\n")
        for a, w, e, y, b in zip(age, wage, edu, label, blank):
            fh.write("%d,%s,%s,%d\n" % (a, "" if b else "%.2f" % w, e, y))


def _jax(fn):
    prior = ref_kernels.kernel_mode()
    try:
        ref_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        ref_kernels.set_kernel_mode(prior)


def assert_same_trees(port, ref):
    """tests/test_torch_gbdt_fit.py's rule: equal split fields and
    thresholds, leaf values within rtol 1e-5. Gains within rtol 1e-5 with
    an absolute floor of 1e-4 of the tree's largest gain (compare_fits'
    `gain_floor`, chip_smoke.CATEGORICAL_TIES): a one-hot column's gain is
    a small difference of its node's large objective terms, whose f32
    rounding in the two packages' summation orders moves it by up to
    ~2.4e-4 of itself here (0.03 of 126 at tree 0, where the tree's
    largest gain is 562)."""
    assert port.num_trees == ref.num_trees
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(port.value, ref.value, rtol=1e-5, atol=1e-7)
    for t in range(ref.num_trees):
        np.testing.assert_allclose(port.gain[t], ref.gain[t], rtol=1e-5,
                                   atol=1e-4 * float(np.max(np.abs(ref.gain[t]))),
                                   err_msg=f"tree {t}")
    np.testing.assert_array_equal(port.threshold_value, ref.threshold_value)


@pytest.fixture(scope="module")
def census(tmp_path_factory):
    path = tmp_path_factory.mktemp("census") / "census.csv"
    write_census_csv(path)
    port, ref = read_csv(str(path)), ref_read_csv(str(path))
    assert_same_table(port, ref)
    assert np.isnan(port["wage"]).any()
    return port, ref


def _pipelines(kind: str):
    clean = dict(input_cols=["age", "wage"], output_cols=["age", "wage"])
    if kind == "classifier":
        return (Pipeline([ops.CleanMissingData(**clean), TrainClassifier(
                    model=GBDTClassifier(device="cpu", **FIT), label_col="income")]),
                RefPipeline([ref_ops.CleanMissingData(**clean), RefTrainClassifier(
                    model=RefClassifier(**FIT), label_col="income")]))
    return (Pipeline([ops.CleanMissingData(**clean), TrainRegressor(
                model=GBDTRegressor(device="cpu", **FIT), label_col="wage")]),
            RefPipeline([ref_ops.CleanMissingData(**clean), RefTrainRegressor(
                model=RefRegressor(**FIT), label_col="wage")]))


@pytest.fixture(scope="module", params=["classifier", "regressor"])
def fits(request, census):
    port_t, ref_t = census
    port, ref = _pipelines(request.param)
    train_p, train_r = port_t.slice(0, 3200), ref_t.slice(0, 3200)
    fp = port.fit(train_p)
    fr = _jax(lambda: ref.fit(train_r))
    return request.param, fp, fr, census


def test_featurized_matrices_are_equal_bit_for_bit(fits):
    _, fp, fr, (port_t, ref_t) = fits
    mp = fp.stages[1].featurizer.transform(fp.stages[0].transform(port_t))
    mr = fr.stages[1].featurizer.transform(fr.stages[0].transform(ref_t))
    assert fp.stages[1].featurizer.stages[0].specs == fr.stages[1].featurizer.stages[0].specs
    assert_same_value(mp["features"], mr["features"])
    assert_same_value(dict(mp.meta("features")), dict(mr.meta("features")))


def test_trees_and_predictions_follow_the_reference(fits):
    kind, fp, fr, (port_t, ref_t) = fits
    assert_same_trees(fp.stages[1].inner_model.booster, fr.stages[1].inner_model.booster)
    held_p, held_r = port_t.slice(3200, 4000), ref_t.slice(3200, 4000)
    got = fp.transform(held_p)
    want = _jax(lambda: fr.transform(held_r))
    assert got.columns == want.columns
    if kind == "classifier":
        assert fp.stages[1].levels == fr.stages[1].levels == [0, 1]
        np.testing.assert_allclose(got["probability"], np.asarray(want["probability"]),
                                   rtol=1e-5, atol=1e-6)
        assert_same_value(got["prediction"], np.asarray(want["prediction"]))
        assert (got["prediction"] == np.asarray(held_p["income"])).mean() > 0.8
    else:
        assert fp.stages[1].levels is None
        np.testing.assert_allclose(got["prediction"], np.asarray(want["prediction"]),
                                   rtol=1e-5, atol=1e-6)


def test_saved_models_load_across_the_packages(fits, tmp_path):
    kind, fp, fr, (port_t, ref_t) = fits
    trained_p, trained_r = fp.stages[1], fr.stages[1]
    held_p, held_r = port_t.slice(3200, 4000), ref_t.slice(3200, 4000)
    cleaned_p, cleaned_r = fp.stages[0].transform(held_p), fr.stages[0].transform(held_r)
    serialize.save_stage(trained_p, str(tmp_path / "port"))
    ref_serialize.save_stage(trained_r, str(tmp_path / "ref"))
    as_port = serialize.load_stage(str(tmp_path / "ref"))
    as_ref = ref_serialize.load_stage(str(tmp_path / "port"))
    cls = TrainedClassifierModel if kind == "classifier" else TrainedRegressorModel
    assert type(as_port) is cls
    # the nested featurizer and booster resolve to the port's classes
    assert type(as_port.inner_model).__module__ == "mmlspark_tpu_torch.gbdt.estimators"
    assert type(as_port.featurizer.stages[0]).__module__ == "mmlspark_tpu_torch.ops.featurize"
    assert type(as_ref.inner_model).__module__ == "mmlspark_tpu.gbdt.estimators"
    as_port.inner_model.to("cpu")
    # each package scores the other's booster as the other does
    assert_same_table(as_port.transform(cleaned_p), _jax(lambda: trained_r.transform(cleaned_r)))
    assert_same_table(_jax(lambda: as_ref.transform(cleaned_r)), trained_p.transform(cleaned_p))
    # the whole fitted pipeline, saved by the port and loaded back
    fp.save(str(tmp_path / "pipeline"))
    loaded = serialize.load_stage(str(tmp_path / "pipeline"))
    loaded.stages[1].inner_model.to("cpu")
    assert_same_table(loaded.transform(held_p), fp.transform(held_p))


def test_inner_estimator_params_pass_through(census):
    port_t, _ = census
    inner = GBDTClassifier(device="cpu", learning_rate=0.3, **FIT)
    trained = TrainClassifier(model=inner, label_col="income", features_col="fv",
                              number_of_features=64).fit(port_t.slice(0, 500))
    booster = trained.inner_model.booster
    assert booster.device == "cpu" and trained.inner_model.get("features_col") == "fv"
    assert inner.get("device") == "cpu" and inner.get("features_col") == "features"
    assert "fv" not in trained.transform(port_t.slice(0, 10)).columns
    with pytest.raises(TypeError, match="Estimator"):
        TrainClassifier(model=ops.DropColumns(cols=["age"]), label_col="income").fit(port_t.slice(0, 10))


def test_string_labels_decode_as_the_reference():
    """tests/test_automl.py's mixed table: string labels, string features."""
    rng = np.random.default_rng(0)
    n = 300
    num = rng.normal(size=n)
    cat = rng.choice(["r", "g", "b"], n)
    y = np.where(num + (cat == "r") > 0.3, "yes", "no")
    cols = {"num": num, "cat": list(cat), "label": list(y)}
    port = TrainClassifier(model=GBDTClassifier(device="cpu", num_iterations=5, num_leaves=7),
                           label_col="label").fit(Table(cols))
    ref = _jax(lambda: RefTrainClassifier(model=RefClassifier(num_iterations=5, num_leaves=7),
                                          label_col="label").fit(RefTable(cols)))
    assert port.levels == ref.levels == ["no", "yes"]
    got = port.transform(Table(cols))["prediction"]
    want = _jax(lambda: ref.transform(RefTable(cols)))["prediction"]
    assert got.dtype == want.dtype and list(got) == list(want)


def test_a_fit_from_cacher_columns_is_the_f32_fit(census):
    """Cacher -> GBDTClassifier: the port's fit of the device columns is its
    fit of the f32-rounded host matrix byte for byte, and follows the
    reference's Cacher -> fit."""
    port_t, ref_t = census
    cols = {"x": np.stack([np.nan_to_num(np.asarray(port_t["wage"])) / 7.0,
                           np.asarray(port_t["age"])], 1),
            "label": np.asarray(port_t["income"])}
    pt = ops.Cacher(device="cpu").transform(Table(cols))
    rt = ref_ops.Cacher().transform(RefTable(cols))
    assert pt["x"].dtype == torch.float32 and pt["label"].dtype == torch.float32
    kw = dict(features_col="x", **FIT)
    port = GBDTClassifier(device="cpu", **kw).fit(pt).booster
    rounded = GBDTClassifier(device="cpu", **kw).fit(Table(
        {"x": cols["x"].astype(np.float32), "label": cols["label"]})).booster
    assert port.to_text() == rounded.to_text()
    ref = _jax(lambda: RefClassifier(**kw).fit(rt)).booster
    assert_same_trees(port, ref)
    gathered = GBDTClassifier(device="cpu", **kw).fit(pt.gather(np.arange(0, 4000, 2))).booster
    rounded_half = GBDTClassifier(device="cpu", **kw).fit(Table(
        {"x": cols["x"][::2].astype(np.float32), "label": cols["label"][::2]})).booster
    assert gathered.to_text() == rounded_half.to_text()
