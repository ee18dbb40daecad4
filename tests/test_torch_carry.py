"""Carrying GBDT models from the JAX package into the port.

A GBDT's weights are its tree arrays and its bin boundaries: a booster the
JAX package fitted or loaded, carried across with `booster_from_arrays`, a
JSON model text or a saved stage, must score bit for bit the same in the
port, through the host walk and through the batched traversal.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.core.serialize import save_stage as jax_save_stage  # noqa: E402
from mmlspark_tpu.core.serialize import stage_to_blob as jax_stage_to_blob  # noqa: E402
from mmlspark_tpu.gbdt import GBDTClassifier as JaxClassifier  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.core.serialize import load_stage, stage_from_blob  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassificationModel  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, booster_from_arrays  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = ("feature", "threshold_bin", "is_categorical", "left", "right",
          "value", "gain", "cat_bitset", "tree_class")


def carry(jb, device="cpu"):
    return booster_from_arrays(
        {k: getattr(jb, k) for k in ARRAYS},
        jb.bin_mapper.to_dict(),
        {"objective": jb.objective, "num_class": jb.num_class,
         "init_score": jb.init_score, "class_labels": jb.class_labels},
        device=device,
    )


def assert_scores_equal(port, ref, x):
    for route in ("host", "device"):
        want = ref.predict_raw(x, device=route)
        got = port.predict_raw(x, device=route)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=route)


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


def _data(n=1200, f=8, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[:7, 2] = np.nan                       # missing values take bin 0
    y = (x[:, 0] - 0.7 * x[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return x, y


@pytest.fixture(scope="module")
def fitted():
    x, y = _data()
    opts = JaxOptions(objective="binary", num_iterations=8, num_leaves=7)
    return x, y, _jax(lambda: JaxBooster.train(x, y, opts))


def test_booster_from_arrays_scores_bit_for_bit(fitted):
    x, _, jb = fitted
    port = carry(jb)
    assert port.device == "cpu" and port.num_trees == jb.num_trees
    np.testing.assert_array_equal(port.threshold_value, jb.threshold_value)
    assert_scores_equal(port, jb, x)
    np.testing.assert_array_equal(port.predict(x[:50]), jb.predict(x[:50]))


def _csv(name, label="Label"):
    path = os.path.join(REPO, "tests", "benchmarks", "data", name)
    with open(path) as fh:
        header = fh.readline().strip().split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1)
    return np.delete(data, header.index(label), axis=1)


@pytest.mark.parametrize("model,inputs", [
    ("gbdt_wdbc", lambda: _csv("breast_cancer_wdbc.csv")),
    ("gbdt_diabetes", lambda: _csv("diabetes.csv")),
    ("gbdt_adult_census_synthetic",
     lambda: np.random.default_rng(11).normal(size=(700, 28))),
])
def test_model_zoo_models_score_the_same(model, inputs):
    with open(os.path.join(REPO, "model_zoo", f"{model}.model")) as fh:
        jb = JaxBooster.from_lightgbm_text(fh.read())
    x = inputs()
    assert x.shape[1] == jb.num_features
    port = carry(jb)
    assert_scores_equal(port, jb, x)
    np.testing.assert_array_equal(port.predict(x), jb.predict(x))


@pytest.mark.parametrize("source", ["fitted", "gbdt_wdbc"])
def test_text_round_trip_is_byte_identical(fitted, source):
    if source == "fitted":
        jb = fitted[2]
    else:
        with open(os.path.join(REPO, "model_zoo", f"{source}.model")) as fh:
            jb = JaxBooster.from_lightgbm_text(fh.read())
    text = jb.to_text()
    port = Booster.from_text(text)
    assert port.device == "cuda"                    # a loaded model defaults to the card
    assert port.to_text() == text
    assert_scores_equal(port.to("cpu"), jb, fitted[0][:, :jb.num_features]
                        if source == "fitted" else _csv("breast_cancer_wdbc.csv"))


def test_saved_stage_loads_and_scores_the_same(fitted, tmp_path):
    x, y, _ = fitted
    table = {"features": x, "label": y}
    jmodel = _jax(lambda: JaxClassifier(num_iterations=5, num_leaves=7).fit(JaxTable(table)))
    want = _jax(lambda: jmodel.transform(JaxTable(table)))
    jax_save_stage(jmodel, str(tmp_path / "model"))
    loaded = [load_stage(str(tmp_path / "model")), stage_from_blob(jax_stage_to_blob(jmodel))]
    for model in loaded:
        assert isinstance(model, GBDTClassificationModel)
        assert model.booster.device == "cuda"
        got = model.to("cpu").transform(Table(table))
        for col in ("raw_prediction", "probability", "prediction"):
            np.testing.assert_array_equal(got[col], want[col], err_msg=col)
        np.testing.assert_array_equal(model.classes, jmodel.classes)
