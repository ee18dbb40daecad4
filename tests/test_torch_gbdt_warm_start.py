"""Warm start and the estimators' held-out rows in the port against the JAX
package, on the CPU: `validation_fraction` with `early_stopping_round`
(the seeded split, `best_iteration`, the classifier's class set over the
training and held-out labels), warm start from `model_string`, rf
included (its 1/T scale undone and redone), and early stopping after a
warm start. Trees are compared by `chip_smoke.compare_fits`, every tree.
The JAX side runs under kernel mode "xla", restored in `finally`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.gbdt import GBDTClassifier as JaxClassifier  # noqa: E402
from mmlspark_tpu.gbdt import GBDTRegressor as JaxRegressor  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassifier, GBDTRegressor  # noqa: E402
from test_torch_gbdt_boosting import _fit_both, _jax, chip_smoke  # noqa: E402
from test_torch_gbdt_early_stopping import ADULT, CUT, compare_all  # noqa: E402


def test_classifier_validation_fraction_matches_jax():
    x, y = ADULT
    params = dict(num_iterations=60, num_leaves=7, learning_rate=0.3,
                  validation_fraction=0.2, early_stopping_round=3, seed=7)
    jmodel = _jax(lambda: JaxClassifier(**params).fit(JaxTable({"features": x, "label": y})))
    model = GBDTClassifier(device="cpu", **params).fit(Table({"features": x, "label": y}))
    assert 0 <= model.booster.best_iteration == jmodel.booster.best_iteration < 59
    assert model.booster.num_trees == jmodel.booster.num_trees
    np.testing.assert_array_equal(model.booster.feature, jmodel.booster.feature)
    np.testing.assert_array_equal(model.classes, jmodel.classes)


def test_classifier_class_set_spans_the_held_out_labels():
    # class 2 only among the rows the seed holds out
    x, y = chip_smoke.make_classification(n=400, classes=3)
    perm = np.random.default_rng(3).permutation(400)
    held = perm[:40]
    y = np.where(y == 2, 1.0, y)
    y[held[:5]] = 2.0
    model = GBDTClassifier(device="cpu", num_iterations=3, num_leaves=4, min_data_in_leaf=5,
                           validation_fraction=0.1, early_stopping_round=2,
                           seed=3).fit(Table({"features": x, "label": y}))
    assert list(model.classes) == [0.0, 1.0, 2.0]
    assert model.booster.num_class == 3


@pytest.mark.parametrize("boosting", ["gbdt", "rf"])
def test_warm_start_from_model_string_matches_jax(boosting):
    x, y = ADULT
    first = dict(num_iterations=6, num_leaves=7, boosting_type=boosting,
                 bagging_fraction=0.8, bagging_freq=1)
    jwarm = _jax(lambda: JaxRegressor(**first).fit(JaxTable({"features": x, "label": y})))
    text = jwarm.booster.to_text()
    second = dict(first, num_iterations=10, model_string=text)
    jmodel = _jax(lambda: JaxRegressor(**second).fit(JaxTable({"features": x, "label": y})))
    model = GBDTRegressor(device="cpu", **second).fit(Table({"features": x, "label": y}))
    port, ref = model.booster, jmodel.booster
    assert port.num_trees == ref.num_trees == 10
    # the warm model's trees come first (rf: their 1/6 undone, then 1/10)
    scale = 6 / 10 if boosting == "rf" else 1.0
    np.testing.assert_allclose(port.value[:6], jwarm.booster.value * np.float32(scale),
                               rtol=1e-6)
    np.testing.assert_array_equal(port.feature[:6], jwarm.booster.feature)
    compare_all(port, ref, x)
    np.testing.assert_allclose(model.transform(Table({"features": x}))["prediction"],
                               jmodel.transform(JaxTable({"features": x}))["prediction"],
                               rtol=1e-5, atol=1e-6)


def test_early_stopping_after_a_warm_start_matches_jax():
    # the validation margins start from the warm model's scores, and
    # best_iteration counts the warm rounds
    x, y = ADULT
    kw = dict(objective="binary", num_leaves=7, learning_rate=0.3)
    warm_port, warm_ref = _fit_both(x[:CUT], y[:CUT], num_iterations=4, **kw)
    port, ref = _fit_both(x[:CUT], y[:CUT], valid=(x[CUT:], y[CUT:]),
                          init_models=(warm_port, warm_ref), num_iterations=40,
                          early_stopping_round=2, **kw)
    assert 4 <= port.best_iteration == ref.best_iteration < 39
    assert port.num_trees == ref.best_iteration + 1
    compare_all(port, ref, x[:CUT])
