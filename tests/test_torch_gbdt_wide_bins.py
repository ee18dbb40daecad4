"""The port's GBDT fit past the bins one feature a block once held (about
14,000 on the card, before K1's bin ranges) against the JAX package's, on
the CPU: 20,000 rows of 4 continuous features at max_bin 16383, so the
histograms have 16,384 bins.

Trees are held by `chip_smoke.compare_fits`: equal, or parted only at a
near-tie (gains within 1e-5) whose two thresholds route every row alike,
leaf values within rtol 1e-5; every tree must be compared. The JAX side
runs under kernel mode "xla_scatter" (its histogram adds rows in row order,
as `histogram_torch` does), restored in `finally`.
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

FIT = dict(objective="binary", num_iterations=5, num_leaves=7, max_bin=16383)


def test_fit_at_16384_bins_matches_jax():
    x, y = chip_smoke.make_classification(n=20000, f=4, seed=3)
    port = Booster.train(x, y, TrainOptions(device="cpu", **FIT))
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla_scatter")
        ref = JaxBooster.train(x, y, JaxOptions(**FIT))
    finally:
        jax_kernels.set_kernel_mode(prior)
    assert int(port.bin_mapper.num_bins.max()) == 16384
    out = chip_smoke.compare_fits(ref, port, port.bin_mapper.transform(x))
    assert out["trees_compared"] == FIT["num_iterations"], out["near_ties"]
    # splits past the old limit are taken
    assert (port.threshold_bin[port.feature >= 0] > 14376).any()
    np.testing.assert_allclose(port.predict(x), ref.predict(x), rtol=1e-5, atol=1e-6)
