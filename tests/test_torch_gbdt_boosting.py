"""The port's random and boosting options against the JAX package's, on the
CPU: bagging with feature sampling, goss, rf and dart, each binary and l2,
and dart with drop_rate=0 scoring bit-equal to gbdt. Multiclass and a
renewed objective under goss are in test_torch_gbdt_boosting_multiclass.py.

Every draw of a fit comes from the same threefry keys in both packages
(core/prng.py), so the trees must be the JAX package's: compared by
`chip_smoke.compare_fits`, equal splits or splits that part only at
near-ties (gains within 1e-5 relative) whose two thresholds route every
row alike, leaf values within rtol 1e-5. Every tree must be compared.
The JAX side runs under kernel mode "xla", restored in `finally`.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


def _regression(n=1500, f=8, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    return x, 2.0 * x[:, 0] - x[:, 1] * x[:, 2] + np.sin(x[:, 3]) + 0.3 * rng.normal(size=n)


# the Adult stand-in and a smooth regression. Label noise keeps leaves
# mixed, so GOSS's top-|g| bar does not fall between leaves whose values
# differ only by rounding: the same rows pass it in both packages
DATA = {"binary": chip_smoke.make_dataset(1500, 14), "regression": _regression()}

BOOSTING = {
    "bagged": dict(boosting_type="gbdt", bagging_fraction=0.8, bagging_freq=2,
                   feature_fraction=0.8),
    "goss": dict(boosting_type="goss", feature_fraction=0.7),
    "rf": dict(boosting_type="rf", bagging_fraction=0.85, bagging_freq=1),
    "dart": dict(boosting_type="dart", bagging_fraction=0.85, bagging_freq=1,
                 feature_fraction=0.9, seed=42),
}


def _fit_both(x, y, valid=None, log=None, init_models=(None, None), **kw):
    """(port, JAX) Boosters of one fit; init_models = (port's, JAX's)."""
    jax_booster = _jax(lambda: JaxBooster.train(
        x, y, JaxOptions(init_model=init_models[1], **kw), valid=valid, log=log))
    port = Booster.train(x, y, TrainOptions(device="cpu", init_model=init_models[0], **kw),
                         valid=valid, log=log)
    return port, jax_booster


def _assert_same_fit(port, ref, x):
    assert port.num_trees == ref.num_trees
    parity = chip_smoke.compare_fits(ref, port, ref.bin_mapper.transform(x))
    assert parity["trees_compared"] == ref.num_trees, parity["near_ties"]
    assert port.init_score == ref.init_score
    np.testing.assert_allclose(port.predict_raw(x), ref.predict_raw(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("boosting", list(BOOSTING))
def test_fit_matches_jax(boosting, objective):
    x, y = DATA[objective]
    port, ref = _fit_both(x, y, objective=objective, num_iterations=8, num_leaves=15,
                          **BOOSTING[boosting])
    _assert_same_fit(port, ref, x)


def test_dart_with_no_drops_scores_bit_equal_to_gbdt():
    x, y = chip_smoke.make_classification(n=1200)
    kw = dict(device="cpu", objective="binary", num_iterations=8, num_leaves=15)
    gbdt = Booster.train(x, y, TrainOptions(**kw))
    dart = Booster.train(x, y, TrainOptions(boosting_type="dart", drop_rate=0.0, **kw))
    np.testing.assert_array_equal(dart.predict_raw(x), gbdt.predict_raw(x))
    np.testing.assert_array_equal(dart.value, gbdt.value)


def test_a_seed_change_changes_the_bags_and_the_trees():
    x, y = DATA["binary"]
    kw = dict(device="cpu", objective="binary", num_iterations=3, num_leaves=7,
              bagging_fraction=0.5, bagging_freq=1)
    a = Booster.train(x, y, TrainOptions(seed=1, **kw))
    b = Booster.train(x, y, TrainOptions(seed=2, **kw))
    assert not np.array_equal(a.value, b.value)
    np.testing.assert_array_equal(a.value, Booster.train(x, y, TrainOptions(seed=1, **kw)).value)


def test_round_hook_sees_the_bags_and_masks_each_tree_grew_from():
    from mmlspark_tpu_torch.core import prng
    from mmlspark_tpu_torch.gbdt import fused

    x, y = DATA["binary"]
    seen = []
    fused.round_hook = lambda it, cls, mask, fmask, drop: seen.append((it, cls, mask, fmask, drop))
    try:
        Booster.train(x, y, TrainOptions(
            device="cpu", objective="binary", num_iterations=3, num_leaves=7, seed=5,
            bagging_fraction=0.8, bagging_freq=2, feature_fraction=0.8))
    finally:
        fused.round_hook = None
    assert [(it, cls) for it, cls, *_ in seen] == [(0, 0), (1, 0), (2, 0)]
    key = prng.prng_key(5)
    for it, _, mask, fmask, drop in seen:
        # the bag refreshes every second round and is carried between
        bag_round = it - it % 2
        u = prng.uniform(prng.fold_in(prng.fold_in(key, bag_round), 1), (len(x),), "cpu")
        assert torch.equal(mask, (u < float(np.float32(0.8))).to(torch.float32))
        assert torch.equal(fmask, fused.feature_mask_of(
            prng.fold_in(prng.fold_in(key, it), 100), x.shape[1], 0.8, "cpu"))
        assert drop is None
    assert torch.equal(seen[0][2], seen[1][2]) and not torch.equal(seen[1][2], seen[2][2])
