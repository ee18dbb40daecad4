"""The port's histogram wrapper (mmlspark_tpu_torch/gbdt/hist_kernel.py)
against the JAX package's histogram variants.

On the CPU the wrapper runs its plain version (`histogram_torch`); the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py and by tests/test_torch_gpu.py. Tolerance rtol = atol =
1e-5, the one tests/test_gbdt.py uses between the JAX variants: the sums
run in another order than the one-hot matmul.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.gbdt.hist_kernel import (  # noqa: E402
    histogram_pallas_interpret,
    histogram_xla,
)
from mmlspark_tpu_torch.gbdt import hist_kernel as hk  # noqa: E402

# (n, F, B): the reference test's shape, the Adult width at 256 bins, and a
# ragged n that fills no power-of-two chunk
SHAPES = [(700, 5, 16), (700, 14, 256), (1001, 7, 64)]


def _inputs(n, f, b, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, f)).astype(np.int32)
    stats = rng.normal(size=(n, 3)).astype(np.float32)
    return bins, stats


def _port(bins, stats, b):
    return hk.histogram(torch.from_numpy(bins), torch.from_numpy(stats), b).numpy()


@pytest.mark.parametrize("dtype", ["int32", "uint8"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_jax_variants(shape, dtype):
    n, f, b = shape
    bins, stats = _inputs(n, f, b)
    bins = bins.astype(dtype)
    got = _port(bins, stats, b)
    assert got.shape == (f, b, 3) and got.dtype == np.float32
    jb, js = jnp.asarray(bins), jnp.asarray(stats)
    np.testing.assert_allclose(got, np.asarray(histogram_xla(jb, js, b)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(histogram_pallas_interpret(jb, js, b)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_uint8_and_int32_give_equal_bits(shape):
    n, f, b = shape
    bins, stats = _inputs(n, f, b, seed=1)
    np.testing.assert_array_equal(_port(bins, stats, b),
                                  _port(bins.astype(np.uint8), stats, b))


def test_zero_stat_rows_change_nothing():
    bins, stats = _inputs(700, 6, 32, seed=2)
    extra_bins, _ = _inputs(300, 6, 32, seed=3)
    padded_bins = np.concatenate([bins, extra_bins])
    padded_stats = np.concatenate([stats, np.zeros((300, 3), np.float32)])
    np.testing.assert_array_equal(_port(bins, stats, 32),
                                  _port(padded_bins, padded_stats, 32))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    bins, stats = _inputs(64, 4, 16)
    tb, ts = torch.from_numpy(bins), torch.from_numpy(stats)
    with pytest.raises(ValueError, match="num_bins"):
        hk.histogram(tb, ts, 257)
    with pytest.raises(ValueError, match="contiguous"):
        hk.histogram(torch.from_numpy(np.asfortranarray(bins)), ts, 16)
    with pytest.raises(ValueError, match="contiguous"):
        hk.histogram(tb, torch.from_numpy(np.asfortranarray(stats)), 16)
    with pytest.raises(ValueError, match="uint8 or int32"):
        hk.histogram(tb.long(), ts, 16)
    with pytest.raises(ValueError, match="float32"):
        hk.histogram(tb, ts.double(), 16)
    # a tensor that is neither on the CPU nor on a card is refused, never
    # computed some other way
    with pytest.raises(ValueError, match="cuda or cpu"):
        hk.histogram(tb.to("meta"), ts.to("meta"), 16)


@pytest.mark.parametrize("n,f", [(32768, 14), (1 << 20, 28), (1001, 5), (5, 3)])
def test_tiling_covers_every_row_and_fills_the_card(n, f):
    rows, chunks, warps = hk.tiling(n, f, num_sms=132)
    groups = -(-f // warps)
    assert warps == min(f, 8)
    assert rows * chunks >= n > rows * (chunks - 1)      # every row, no empty chunk
    assert rows <= 8192
    if n >= 2 * 132 * groups:
        assert chunks * groups >= 2 * 132                # at least two blocks per SM

