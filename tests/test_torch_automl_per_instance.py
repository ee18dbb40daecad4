"""The port's `ComputePerInstanceStatistics` and `native.predict_trees`,
held against the JAX package's.

Per-row statistics run the reference's own cases (tests/test_ops.py:291-302,
:383-386) through both packages, equal within rtol 1e-6. `predict_trees`
scores the zoo's LightGBM models (model_zoo/gbdt_*.model) through both
packages' native tree walk, bit for bit, and gives None when the native
library is unavailable.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu import native as jax_native  # noqa: E402
from mmlspark_tpu.automl.metrics import (  # noqa: E402
    ComputePerInstanceStatistics as JaxPerInstance)
from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.utils.datagen import load_label_csv  # noqa: E402
from mmlspark_tpu_torch import automl, native  # noqa: E402
from mmlspark_tpu_torch.automl import ComputePerInstanceStatistics  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    # tests/test_ops.py:291-302
    "binary_probabilities": (
        {"label": np.array([0, 1]), "scores": np.array([0.2, 0.9])},
        {"scores_col": "scores"}),
    "two_column_probabilities": (
        {"label": np.array([1, 0, 1]),
         "scores": np.array([[0.3, 0.7], [0.6, 0.4], [0.1, 0.9]])},
        {"scores_col": "scores", "evaluation_metric": "classification"}),
    "multiclass_probabilities": (
        {"label": np.array([2.0, 0.0, 1.0, 2.0]),
         "scores": np.array([[0.1, 0.2, 0.7], [0.5, 0.3, 0.2],
                             [0.2, 0.6, 0.2], [0.3, 0.3, 0.4]])},
        {"scores_col": "scores"}),
    "regression": (
        {"label": np.array([1.0, 2.5, -3.0]),
         "scored_labels": np.array([1.5, 2.0, -1.0])},
        {}),
    "regression_forced_over_scores": (
        {"label": np.array([1.0, 0.0]), "scores": np.array([0.2, 0.9]),
         "scored_labels": np.array([0.5, 0.25])},
        {"scores_col": "scores", "evaluation_metric": "regression"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_per_instance_statistics_match_jax(case):
    cols, params = CASES[case]
    want = JaxPerInstance(**params).transform(JaxTable(dict(cols)))
    got = ComputePerInstanceStatistics(**params).transform(Table(dict(cols)))
    assert got.columns == want.columns
    for name in want.columns:
        np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                   np.asarray(want[name], np.float64), rtol=1e-6)


def test_per_instance_binary_log_loss():
    """tests/test_ops.py:291-302 on the port."""
    t = Table({"label": np.array([0, 1]), "scores": np.array([0.2, 0.9])})
    out = ComputePerInstanceStatistics(scores_col="scores").transform(t)
    np.testing.assert_allclose(out["log_loss"], [-np.log(0.8), -np.log(0.9)], rtol=1e-6)


@pytest.mark.parametrize("stage", [ComputePerInstanceStatistics, JaxPerInstance],
                         ids=["port", "jax"])
def test_per_instance_classification_without_scores_raises(stage):
    """tests/test_ops.py:383-386, on both packages."""
    table_cls = Table if stage is ComputePerInstanceStatistics else JaxTable
    t = table_cls({"label": np.array([0, 1]), "scored_labels": np.array([0, 1])})
    with pytest.raises(ValueError):
        stage(evaluation_metric="classification").transform(t)


def test_per_instance_label_outside_classes_raises():
    t = Table({"label": np.array([0.0, 5.0]), "scores": np.array([[0.5, 0.5], [0.5, 0.5]])})
    t = t.with_meta("scores", {"class_labels": [0.0, 1.0]})
    with pytest.raises(ValueError, match="not in class set"):
        ComputePerInstanceStatistics(scores_col="scores").transform(t)


def test_automl_exports_per_instance_statistics():
    assert automl.ComputePerInstanceStatistics is ComputePerInstanceStatistics
    assert "ComputePerInstanceStatistics" in automl.__all__


def _tree_arrays(name: str, dataset: str):
    booster = Booster.load_native_model(os.path.join(REPO, "model_zoo", f"{name}.model"),
                                        device="cpu")
    x, _ = load_label_csv(os.path.join(REPO, "tests", "benchmarks", "data", f"{dataset}.csv"))
    bins = booster.bin_mapper.transform(x)
    max_steps = int(booster.feature.shape[1] // 2 + 1)
    args = (booster.feature, booster.threshold_bin, booster.is_categorical, booster.left,
            booster.right, booster.value, booster.tree_class, booster.num_class, max_steps,
            booster.init_score)
    return booster, bins, args


@pytest.mark.parametrize("name,dataset", [("gbdt_wdbc", "breast_cancer_wdbc"),
                                          ("gbdt_diabetes", "diabetes")])
def test_predict_trees_matches_jax_bit_for_bit(name, dataset):
    if not (native.available() and jax_native.available()):
        pytest.skip("needs the native host library (g++)")
    booster, bins, args = _tree_arrays(name, dataset)
    got = native.predict_trees(bins, *args, cat_bitset=booster.cat_bitset)
    want = jax_native.predict_trees(bins, *args, cat_bitset=booster.cat_bitset)
    assert got is not None and got.dtype == np.float32 and got.shape == (len(bins),)
    np.testing.assert_array_equal(got, want)
    # the one-shot wrapper is the prepared predictor's call
    prepared = native.make_tree_predictor(*args, cat_bitset=booster.cat_bitset)
    np.testing.assert_array_equal(got, prepared(bins))


def test_predict_trees_is_none_without_the_native_library(monkeypatch):
    _, bins, args = _tree_arrays("gbdt_wdbc", "breast_cancer_wdbc")
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.predict_trees(bins, *args) is None
    assert "predict_trees" in native.__all__
