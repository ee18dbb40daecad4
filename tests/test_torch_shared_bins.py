"""The port's shared binned dataset (gbdt/shared_bins.py) and its hook in
`Booster.train`, on the CPU, held against the JAX package.

tests/test_automl_sweep.py:186-230's cases in both packages (binning is
row-wise; a seed builds once, a lookup of a slice hits and gathers the
slice's bins; a config mismatch or foreign rows miss), then the hook: a
fit from a hit writes the same `to_text()` as a fit that binned itself
with the same mapper, a fold's fit from a hit grows the JAX package's
trees from its own hit, and `bin_counters` counts builds and hits under
the reference's metric names.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.gbdt.binning import BinMapper as JaxBinMapper  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu.gbdt import shared_bins as jax_shared  # noqa: E402
from mmlspark_tpu_torch.gbdt.binning import BinMapper  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions  # noqa: E402
from mmlspark_tpu_torch.gbdt.shared_bins import (SharedBinContext, bin_counters,  # noqa: E402
                                                 set_shared_bin_context)
from mmlspark_tpu_torch.observability.metrics import get_registry  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import compare_fits  # noqa: E402

FIT = dict(objective="binary", num_iterations=6, num_leaves=7)
LOOKUP = dict(categorical_indexes=(), bin_construct_sample_cnt=200_000)


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


@pytest.fixture()
def no_context():
    set_shared_bin_context(None)
    jax_shared.set_shared_bin_context(None)
    try:
        yield
    finally:
        set_shared_bin_context(None)
        jax_shared.set_shared_bin_context(None)


class TestSharedBins:
    def test_row_gather_identity(self):
        rng = np.random.default_rng(3)
        x = rng.normal(size=(60, 5))
        idx = np.asarray([3, 17, 42, 3])
        mapper = BinMapper(max_bin=16).fit(x)
        np.testing.assert_array_equal(mapper.transform(x[idx]), mapper.transform(x)[idx])
        np.testing.assert_array_equal(mapper.transform(x),
                                      JaxBinMapper(max_bin=16).fit(x).transform(x))

    def test_seed_once_lookup_hits(self):
        rng = np.random.default_rng(4)
        x = rng.normal(size=(50, 3))
        before = bin_counters()
        ctx = SharedBinContext()
        ctx.seed(x, max_bin=16, device="cpu")
        ctx.seed(x, max_bin=16, device="cpu")          # idempotent: no second build
        hit = ctx.lookup(x[10:30], max_bin=16, device="cpu", **LOOKUP)
        assert hit is not None
        bins = hit.device_bins()
        assert bins.dtype == torch.int32 and bins.device.type == "cpu"
        np.testing.assert_array_equal(bins.numpy(), hit.mapper.transform(x)[10:30])
        np.testing.assert_array_equal(hit.device_bins(5, 9).numpy(),
                                      hit.mapper.transform(x)[15:19])
        jctx = jax_shared.SharedBinContext()
        jctx.seed(x, max_bin=16)
        jhit = jctx.lookup(x[10:30], max_bin=16, **LOOKUP)
        np.testing.assert_array_equal(bins.numpy(), np.asarray(jhit.device_bins()))
        after = bin_counters()
        assert after["builds"] - before["builds"] == 1.0
        assert after["hits"] - before["hits"] == 1.0
        reg = get_registry()
        assert reg.counter("mmlspark_tpu_gbdt_bin_builds_total").value == after["builds"]
        assert reg.counter("mmlspark_tpu_gbdt_bin_cache_hits_total").value == after["hits"]

    def test_config_mismatch_misses(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(30, 3))
        ctx = SharedBinContext()
        ctx.seed(x, max_bin=16, device="cpu")
        assert ctx.lookup(x, max_bin=32, device="cpu", **LOOKUP) is None
        assert ctx.lookup(x + 1.0, max_bin=16, device="cpu", **LOOKUP) is None
        # the device is part of the config: a fit elsewhere bins itself
        assert ctx.lookup(x, max_bin=16, device="meta", **LOOKUP) is None


class TestBoosterHook:
    def test_a_hit_fit_writes_the_same_text_as_a_fit_without_one(self, no_context):
        rng = np.random.default_rng(6)
        x = rng.normal(size=(500, 6))
        y = (x[:, 0] - 0.4 * x[:, 1] > 0).astype(np.float64)
        opts = TrainOptions(device="cpu", **FIT)
        plain = Booster.train(x, y, opts)
        ctx = SharedBinContext()
        ctx.seed(x, device="cpu")
        set_shared_bin_context(ctx)
        before = bin_counters()
        shared = Booster.train(x, y, opts)
        after = bin_counters()
        assert shared.to_text() == plain.to_text()
        assert after["hits"] - before["hits"] == 1.0
        assert after["builds"] == before["builds"]

    @pytest.mark.parametrize("bin_dtype", ["int32", "uint8"])
    def test_a_fold_fit_from_a_hit_grows_the_jax_packages_trees(self, no_context, bin_dtype):
        rng = np.random.default_rng(7)
        x = rng.normal(size=(800, 5))
        y = (x[:, 0] + 0.5 * x[:, 1] + 0.2 * rng.normal(size=800) > 0).astype(np.float64)
        fold = np.sort(rng.permutation(800)[:520])
        ctx = SharedBinContext()
        ctx.seed(x, device="cpu")
        set_shared_bin_context(ctx)
        port = Booster.train(x[fold], y[fold], TrainOptions(device="cpu", bin_dtype=bin_dtype,
                                                            **FIT))
        jctx = jax_shared.SharedBinContext()
        jctx.seed(x)
        jax_shared.set_shared_bin_context(jctx)
        ref = _jax(lambda: JaxBooster.train(x[fold], y[fold], JaxOptions(bin_dtype=bin_dtype,
                                                                         **FIT)))
        # both fits binned with the full table's mapper
        assert port.bin_mapper.to_dict() == ref.bin_mapper.to_dict()
        out = compare_fits(Booster.from_text(ref.to_text(), device="cpu"), port)
        assert out["trees_equal"] and out["trees_compared"] == port.num_trees, out

    def test_device_binning_builds_its_own(self, no_context):
        rng = np.random.default_rng(8)
        x = rng.normal(size=(300, 4))
        y = (x[:, 0] > 0).astype(np.float64)
        ctx = SharedBinContext()
        ctx.seed(x, device="cpu")
        set_shared_bin_context(ctx)
        before = bin_counters()
        Booster.train(x, y, TrainOptions(device="cpu", device_binning=True, **FIT))
        after = bin_counters()
        assert after["hits"] == before["hits"]
        assert after["builds"] - before["builds"] == 1.0
