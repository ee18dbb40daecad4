"""The port's boosting options against the JAX package's on the CPU, past
binary and l2: multiclass bagged with feature sampling, multiclass dart
(which runs the gbdt loop on one key, as in the reference), and quantile,
a renewed objective, under goss, whose renewal weighs rows by bag
membership, not by GOSS's amplified weights.

Trees are compared as in test_torch_gbdt_boosting.py (`compare_fits`).
The JAX side runs under kernel mode "xla", restored in `finally`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_torch_gbdt_boosting import (  # noqa: E402
    BOOSTING,
    DATA,
    _assert_same_fit,
    _fit_both,
    chip_smoke,
)


@pytest.mark.parametrize("boosting", ["bagged", "dart"])
def test_multiclass_matches_jax(boosting):
    x, y = chip_smoke.make_classification(n=1000, classes=3)
    kw = dict(BOOSTING[boosting], feature_fraction=0.8)
    port, ref = _fit_both(x, y, objective="multiclass", num_class=3, num_iterations=4,
                          num_leaves=7, **kw)
    _assert_same_fit(port, ref, x)
    assert list(port.tree_class) == [0, 1, 2] * 4


def test_quantile_under_goss_matches_jax():
    # alpha 0.75: the gradients are +-0.25 and +-0.75 and GOSS amplifies by
    # 8, so every histogram sum is exact in f32 and both packages see the
    # same gains, ties included: the whole fit must compare
    x, y = DATA["regression"]
    port, ref = _fit_both(x, y, objective="quantile", alpha=0.75, boosting_type="goss",
                          num_iterations=6, num_leaves=7)
    _assert_same_fit(port, ref, x)


def test_quantile_under_goss_parts_only_at_near_ties():
    # alpha 0.7: two gradient values, so many splits tie exactly, and sums
    # of 0.3 and 0.7 round by summation order: a tie may break either way
    # (ROADMAP.md Queue 3, near-tie splits). Where the trees part, the two
    # gains must be within 1e-5 relative; the trees before agree
    x, y = DATA["regression"]
    port, ref = _fit_both(x, y, objective="quantile", alpha=0.7, boosting_type="goss",
                          num_iterations=6, num_leaves=7)
    parity = chip_smoke.compare_fits(ref, port, ref.bin_mapper.transform(x))
    assert all(t["relative_gap"] <= 1e-5 for t in parity["near_ties"])
    assert np.isfinite(port.predict_raw(x)).all()
