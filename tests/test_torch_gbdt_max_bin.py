"""The port's GBDT fit above 255 bins (mmlspark_tpu_torch) against the JAX
package's, on the CPU: numeric fits at max_bin 511 and 1023 (512 and 1024
bins, int32 storage), and bin_dtype="uint8" at more than 256 bins, which
warns and stores int32 as the reference does (mmlspark_tpu/gbdt/
booster.py:231-245).

Trees are held by `chip_smoke.compare_fits`: equal, or parted only at a
near-tie (gains within 1e-5) whose two thresholds route every row alike
(around a run of empty bins, which wider bins make common), leaf values
within rtol 1e-5 (tests/test_torch_gbdt_fit.py's tolerance); every tree
must be compared. The JAX side runs under kernel mode "xla", restored in
`finally`.
"""

import os
import sys
import warnings
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu_torch.gbdt import engine  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

X, Y = chip_smoke.make_classification(n=3000, f=6, seed=0)
FIT = dict(objective="binary", num_iterations=8, num_leaves=15)


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


@pytest.mark.parametrize("max_bin", [511, 1023])
def test_fit_above_255_bins_matches_jax(max_bin):
    port = Booster.train(X, Y, TrainOptions(device="cpu", max_bin=max_bin, **FIT))
    ref = _jax(lambda: JaxBooster.train(X, Y, JaxOptions(max_bin=max_bin, **FIT)))
    assert int(port.bin_mapper.num_bins.max()) == max_bin + 1
    out = chip_smoke.compare_fits(ref, port, port.bin_mapper.transform(X))
    assert out["trees_compared"] == FIT["num_iterations"], out["near_ties"]
    # splits past bin 255 are taken
    assert (port.threshold_bin[port.feature >= 0] > 255).any()
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5, atol=1e-6)


def test_uint8_above_256_bins_warns_and_stores_int32():
    seen, histogram = [], engine.histogram

    def spy(bins, stats, num_bins):      # the dtype the fit stores its bins in
        seen.append((bins.dtype, num_bins))
        return histogram(bins, stats, num_bins)

    kw = dict(max_bin=511, **FIT)
    with mock.patch.object(engine, "histogram", spy), \
            pytest.warns(UserWarning, match="storing bins as int32") as got:
        b8 = Booster.train(X, Y, TrainOptions(device="cpu", bin_dtype="uint8", **kw))
    assert set(seen) == {(torch.int32, 512)}
    with warnings.catch_warnings(record=True) as ref_warns:
        warnings.simplefilter("always")
        _jax(lambda: JaxBooster.train(X, Y, JaxOptions(bin_dtype="uint8", **kw)))
    # the reference's message, word for word
    assert str(got[0].message) in {str(w.message) for w in ref_warns}
    b32 = Booster.train(X, Y, TrainOptions(device="cpu", **kw))
    assert b8.to_text() == b32.to_text()
    # at 256 bins or fewer uint8 stays uint8, silently
    seen.clear()
    with mock.patch.object(engine, "histogram", spy), warnings.catch_warnings():
        warnings.simplefilter("error")
        Booster.train(X, Y, TrainOptions(device="cpu", bin_dtype="uint8", max_bin=255, **FIT))
    assert set(seen) == {(torch.uint8, 256)}
