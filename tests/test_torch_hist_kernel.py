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


# above 256 bins (max_bin 511 and 1023 give 512 and 1024): the Adult width
# and the Amazon-access width; the JAX package's XLA histogram takes any B
WIDE_SHAPES = [(700, 14, 512), (900, 9, 1024)]


@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_jax_above_256_bins(shape):
    n, f, b = shape
    bins, stats = _inputs(n, f, b, seed=4)
    got = _port(bins, stats, b)
    assert got.shape == (f, b, 3)
    np.testing.assert_allclose(got, np.asarray(histogram_xla(jnp.asarray(bins), jnp.asarray(stats), b)),
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
        hk.histogram(tb, ts, 0)
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


# (n, F, B, bin bytes): the Adult and Higgs shapes, a ragged n, n = 1 and
# 31 (one block along the rows), B = 2 and 64, F = 17 (W = 17 warps, one
# copy), F = 48 int32 (a smaller tile, no split) and F = 100 (feature
# groups along grid_y), and F = 10,000 (more groups than SMs)
PLAN_SHAPES = [(32768, 14, 256, 4), (1 << 20, 28, 256, 1), (10007, 14, 256, 4),
               (1, 14, 256, 4), (31, 5, 16, 1), (5000, 5, 2, 1), (5000, 5, 64, 4),
               (20000, 17, 256, 4), (50000, 48, 256, 4), (50000, 100, 256, 4),
               (50, 100, 256, 4), (100000, 10000, 256, 4)]


@pytest.mark.parametrize("n,f,b,bin_bytes", PLAN_SHAPES)
def test_tiling_covers_every_row_and_fills_the_card(n, f, b, bin_bytes):
    sms = 132
    plan = hk.launch_plan(n, f, b, bin_bytes, sms)
    rows = plan.tile_rows * plan.tiles_per_block
    # every row in exactly one block along the rows, and no block empty
    assert rows * plan.grid_x >= n > rows * (plan.grid_x - 1)
    # every feature in exactly one group, and no group empty
    fg = plan.feats_per_group
    assert fg * plan.grid_y >= f > fg * (plan.grid_y - 1)
    # the block: every feature of a group owned by one warp of each copy,
    # at most 1,024 threads, the tile's rows and stats within its threads
    assert plan.warps_per_copy == min(fg, 32) and plan.threads <= 1024
    assert plan.tile_rows % 32 == 0 and 3 * plan.tile_rows <= 2 * plan.threads
    assert plan.smem_bytes <= 232448
    # a feature split only where one block cannot hold every histogram
    # (the shapes sit far from the edge: 48 x 256 bins take 147 KB, 100 x
    # 256 bins 307 KB)
    assert (plan.grid_y == 1) == (f * b * 12 <= 200_000)
    # the grid: co-resident (the grid barrier) unless one block along the
    # rows needs none; the card filled as far as the rows allow
    tiles = -(-n // plan.tile_rows)
    assert plan.grid_x == -(-tiles // plan.tiles_per_block)
    if plan.grid_x > 1:
        assert plan.grid_x * plan.grid_y <= sms
    if plan.grid_y <= sms // 2:
        assert plan.grid_x == min(tiles, plan.grid_x) and (plan.grid_x >= 2 or tiles == 1)
    if plan.tiles_per_block > 1:       # one tile fewer a block would not fit on the card
        assert -(-tiles // (plan.tiles_per_block - 1)) * plan.grid_y > sms


def test_launch_plans_take_each_branch():
    sms = 132
    adult = hk.launch_plan(32768, 14, 256, 4, sms)
    assert (adult.grid_x, adult.grid_y, adult.copies, adult.tile_rows) == (128, 1, 2, 256)
    assert adult.tiles_per_block == 1 and adult.branch == "rows"
    higgs = hk.launch_plan(1 << 20, 28, 256, 1, sms)
    assert (higgs.grid_x, higgs.copies, higgs.tiles_per_block) == (128, 1, 32)
    assert higgs.branch == "capped"
    assert hk.launch_plan(31, 5, 16, 1, sms).branch == "one_block"
    assert hk.launch_plan(50, 100, 256, 4, sms)[:2] == (1, 2)
    assert hk.launch_plan(50, 100, 256, 4, sms).branch == "one_block"
    narrow_tile = hk.launch_plan(50000, 48, 256, 4, sms)
    assert narrow_tile.grid_y == 1 and narrow_tile.tile_rows < 256
    assert narrow_tile.branch == "small_tile"
    split = hk.launch_plan(50000, 100, 256, 4, sms)
    assert split.grid_y == 2 and split.grid_x * 2 <= sms and split.branch == "split"
    wide = hk.launch_plan(100000, 10000, 256, 4, sms)
    assert wide.grid_y > sms and wide.grid_x == 1


# (n, F, B, the plan's branch, groups): above 256 bins a block holds one
# histogram copy of F warps ("rows") or feature groups ("split"); the Adult
# shape at B 512, 1024 and 4096 (the widest split), the Amazon-access shape
# and the Higgs shape at 1024
WIDE_PLANS = [(32768, 14, 512, "rows", 1), (32768, 14, 1024, "split", 2),
              (32769, 9, 1024, "rows", 1), (1 << 20, 28, 1024, "split", 3),
              (32768, 14, 4096, "split", 5)]


@pytest.mark.parametrize("n,f,b,branch,groups", WIDE_PLANS)
def test_plans_above_256_bins_fit_shared_memory(n, f, b, branch, groups):
    sms = 132
    plan = hk.launch_plan(n, f, b, 4, sms)
    assert (plan.branch, plan.grid_y, plan.copies) == (branch, groups, 1)
    assert plan.warps_per_copy == plan.feats_per_group == -(-f // groups)
    # one copy's histograms and lane masks, a tile and its buffers
    assert plan.feats_per_group * b * 16 < plan.smem_bytes <= 232448
    # a tile's rows are one a thread (its stats may take two reads a thread)
    assert plan.tile_rows % 32 == 0 and plan.tile_rows <= plan.threads
    rows = plan.tile_rows * plan.tiles_per_block
    assert rows * plan.grid_x >= n > rows * (plan.grid_x - 1)
    assert plan.grid_x * plan.grid_y <= sms


def test_no_launch_past_the_bins_shared_memory_holds():
    limit = hk.max_bins(14, 4)
    # one feature a block: 16 bytes a bin (histogram and lane masks) and a
    # tile's buffers
    assert 14000 < limit < 232448 // 16
    assert hk.launch_plan(32768, 14, limit, 4, 132).feats_per_group == 1
    with pytest.raises(ValueError, match=f"no launch fits 14 features of 16384 bins.*at most {limit}"):
        hk.launch_plan(32768, 14, 16384, 4, 132)
    # the CPU's plain version has no such limit
    bins, stats = _inputs(50, 2, 16384, seed=5)
    assert _port(bins, stats, 16384).shape == (2, 16384, 3)
