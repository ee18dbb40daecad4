"""The port's regressor (mmlspark_tpu_torch) against the JAX package's, on
the CPU: GBDTRegressor -> GBDTRegressionModel -> ComputeModelStatistics
regression metrics, regression and multiclass boosters carried from the
JAX package, and the objectives quality gate of
tests/benchmarks/test_gbdt_benchmarks.py:86-114 run through chip_smoke.py's
`objectives_gate` (the function the smoke runs on the card) against
tests/benchmarks/benchmarks_objectives.csv.

Predictions agree within rtol 1e-5 (test_torch_gbdt_fit.py's tolerance);
the metrics, float32 reductions in another order, within rtol 1e-5. The
JAX side runs under kernel mode "xla", restored in `finally`.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.automl.metrics import ComputeModelStatistics as JaxCMS  # noqa: E402
from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.core.serialize import save_stage as jax_save_stage  # noqa: E402
from mmlspark_tpu.gbdt import GBDTRegressor as JaxRegressor  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu_torch.automl import ComputeModelStatistics  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.core.serialize import load_stage  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTRegressionModel, GBDTRegressor  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, booster_from_arrays  # noqa: E402

from benchmarks import datasets  # noqa: E402  (tests/benchmarks)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

ARRAYS = ("feature", "threshold_bin", "is_categorical", "left", "right",
          "value", "gain", "cat_bitset", "tree_class")
METRICS = ("mean_squared_error", "root_mean_squared_error", "R^2", "mean_absolute_error")


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


def _data(n=1200, f=6, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = 2.0 * x[:, 0] - x[:, 1] * x[:, 2] + np.sin(x[:, 3]) + 0.2 * rng.normal(size=n)
    return x, y


@pytest.mark.parametrize("objective", ["regression", "quantile", "gamma"])
def test_regressor_and_metrics_match_jax(objective):
    x, y = _data()
    if objective == "gamma":
        y = np.abs(y) + 0.5
    cut = 900
    params = dict(objective=objective, num_iterations=12, num_leaves=15, alpha=0.7)
    jmodel = _jax(lambda: JaxRegressor(**params).fit(
        JaxTable({"features": x[:cut], "label": y[:cut]})))
    model = GBDTRegressor(device="cpu", **params).fit(
        Table({"features": x[:cut], "label": y[:cut]}))
    assert isinstance(model, GBDTRegressionModel) and model.booster.objective == objective
    # 300 held-out rows take the host walk, 1,200 the batched traversal
    for rows in (slice(cut, None), slice(None)):
        jout = jmodel.transform(JaxTable({"features": x[rows], "label": y[rows]}))
        out = model.transform(Table({"features": x[rows], "label": y[rows]}))
        np.testing.assert_allclose(out["prediction"], jout["prediction"], rtol=1e-5, atol=1e-5)
        assert out.meta("prediction") == jout.meta("prediction")
        cms = dict(scored_labels_col="prediction")
        got = ComputeModelStatistics(**cms).transform(out)
        want = JaxCMS(**cms).transform(jout)
        assert set(got.columns) == set(want.columns) == set(METRICS)
        for name in METRICS:
            np.testing.assert_allclose(got[name][0], want[name][0], rtol=1e-5, err_msg=name)
    if objective == "regression":      # the conditional mean: a fit that learned
        assert ComputeModelStatistics(scored_labels_col="prediction").transform(
            out)["R^2"][0] > 0.5


def test_regression_metrics_by_name_match_jax():
    rng = np.random.default_rng(9)
    labels, preds = rng.normal(size=500) * 3, rng.normal(size=500) * 3
    tables = [cls({"label": labels, "pred": preds}) for cls in (Table, JaxTable)]
    for metric in ("regression", "mean_absolute_error"):
        kw = dict(scored_labels_col="pred", evaluation_metric=metric)
        got = ComputeModelStatistics(**kw).transform(tables[0])
        want = JaxCMS(**kw).transform(tables[1])
        for name in METRICS:
            np.testing.assert_allclose(got[name][0], want[name][0], rtol=1e-5, err_msg=name)
    # constant labels: R^2's denominator is 0 in both
    flat = [cls({"label": np.ones(10), "pred": np.arange(10.0)}) for cls in (Table, JaxTable)]
    kw = dict(scored_labels_col="pred", evaluation_metric="regression")
    assert ComputeModelStatistics(**kw).transform(flat[0])["R^2"][0] == \
        JaxCMS(**kw).transform(flat[1])["R^2"][0]


def _carry(jb):
    return booster_from_arrays(
        {k: getattr(jb, k) for k in ARRAYS}, jb.bin_mapper.to_dict(),
        {"objective": jb.objective, "num_class": jb.num_class,
         "init_score": jb.init_score, "class_labels": jb.class_labels},
        device="cpu")


@pytest.mark.parametrize("opts", [
    dict(objective="l1"),
    dict(objective="tweedie"),
    dict(objective="multiclass", num_class=3),
], ids=lambda d: d["objective"])
def test_carried_boosters_score_bit_for_bit(opts):
    x, y = _data(n=600)
    if opts["objective"] == "tweedie":
        y = np.abs(y)
    elif opts["objective"] == "multiclass":
        y = np.digitize(y, [-1.0, 1.0]).astype(float)
    jb = _jax(lambda: JaxBooster.train(x, y, JaxOptions(num_iterations=6, num_leaves=7, **opts)))
    for port in (_carry(jb), Booster.from_text(jb.to_text(), device="cpu")):
        assert port.num_class == jb.num_class and port.objective == jb.objective
        for route in ("host", "device"):
            np.testing.assert_array_equal(port.predict_raw(x, device=route),
                                          jb.predict_raw(x, device=route), err_msg=route)
        np.testing.assert_array_equal(port.predict(x), jb.predict(x))


def test_diabetes_zoo_model_serves_as_a_regression_stage(tmp_path):
    # model_zoo/gbdt_diabetes.model read through the JAX importer, saved as
    # a JAX GBDTRegressionModel stage and loaded by the port
    from mmlspark_tpu.gbdt import GBDTRegressionModel as JaxModel

    with open(os.path.join(REPO, "model_zoo", "gbdt_diabetes.model")) as fh:
        jb = JaxBooster.from_lightgbm_text(fh.read())
    path = os.path.join(REPO, "tests", "benchmarks", "data", "diabetes.csv")
    with open(path) as fh:
        header = fh.readline().strip().split(",")
    x = np.delete(np.loadtxt(path, delimiter=",", skiprows=1), header.index("Label"), axis=1)
    assert x.shape[1] == jb.num_features
    jmodel = JaxModel(features_col="features", prediction_col="prediction")
    jmodel.booster = jb
    jax_save_stage(jmodel, str(tmp_path / "model"))
    model = load_stage(str(tmp_path / "model"))
    assert isinstance(model, GBDTRegressionModel)
    got = model.to("cpu").transform(Table({"features": x}))["prediction"]
    want = jmodel.transform(JaxTable({"features": x}))["prediction"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["airfoil_like", "counts_like"])
def test_smoke_generators_are_the_benchmark_generators(name):
    table = getattr(datasets, name)()
    x, y = getattr(chip_smoke, name)()
    assert np.array_equal(x, np.asarray(table["features"]))
    assert np.array_equal(y, np.asarray(table["label"]))


def test_objectives_gate_passes_on_cpu():
    rows = chip_smoke.objectives_gate("cpu")
    assert [r["name"] for r in rows] == ["airfoil_l1", "airfoil_huber", "airfoil_quantile",
                                         "counts_poisson_deviance", "counts_tweedie_deviance"]
    bad = [r for r in rows if not r["within"]]
    assert not bad, bad
