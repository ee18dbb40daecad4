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
# groups along grid_y), F = 10,000 (more groups than SMs), and the
# featurized fits of chip_smoke's slice_tabular: the one-hot Adult matrix
# (F 108) and the hashed text matrix (F 4,096 at the 27 bins its mapper
# gives)
PLAN_SHAPES = [(32768, 14, 256, 4), (1 << 20, 28, 256, 1), (10007, 14, 256, 4),
               (1, 14, 256, 4), (31, 5, 16, 1), (5000, 5, 2, 1), (5000, 5, 64, 4),
               (20000, 17, 256, 4), (50000, 48, 256, 4), (50000, 100, 256, 4),
               (50, 100, 256, 4), (100000, 10000, 256, 4), (32768, 108, 256, 4),
               (6144, 4096, 27, 4)]


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


# (n, F, B): above 256 bins a block holds one histogram of a feature group
# and a range of its bins; the Adult shape at B 512, 1024 and 4096, the
# Amazon-access shape and the Higgs shape at 1024
WIDE_PLANS = [(32768, 14, 512), (32768, 14, 1024), (32769, 9, 1024), (1 << 20, 28, 1024),
              (32768, 14, 4096)]


def _assert_wide_plan(plan, n, f, b, sms, resident=hk.resident_blocks):
    """What the kernel's ranged variant needs of a plan: one histogram, a
    warp a feature and a part of the range, shared memory and threads in
    bounds, rows, groups and ranges each covered once, a co-resident grid
    where there is a grid barrier (`resident` blocks an SM)."""
    assert plan.copies == 1 and plan.warps_per_copy % plan.feats_per_group == 0
    assert plan.threads <= 1024 and plan.smem_bytes <= 232448
    assert plan.smem_bytes == hk._smem_bytes_wide(plan.feats_per_group, plan.bins_per_range,
                                                  plan.warps_per_copy, plan.tile_rows,
                                                  plan.bins_buf_bytes)
    # a tile's rows are one a thread (its stats may take two reads a thread)
    assert plan.tile_rows % 32 == 0 and plan.tile_rows <= plan.threads
    rows = plan.tile_rows * plan.tiles_per_block
    assert rows * plan.grid_x >= n > rows * (plan.grid_x - 1)
    groups = -(-f // plan.feats_per_group)
    assert plan.grid_y == groups * plan.ranges
    assert plan.feats_per_group * groups >= f > plan.feats_per_group * (groups - 1)
    # the ranges tile [0, B) of every feature once: none empty, none past B
    assert plan.bins_per_range * plan.ranges >= b > plan.bins_per_range * (plan.ranges - 1)
    if plan.grid_x > 1:
        # the grid barrier: every block resident at once, at most the
        # blocks the SMs hold of this size (one each up to 256 bins)
        held = resident(plan.threads, plan.smem_bytes)
        assert plan.grid_x * plan.grid_y <= held * sms and plan.grid_y <= 65535


@pytest.mark.parametrize("n,f,b", WIDE_PLANS)
def test_plans_above_256_bins_fit_shared_memory(n, f, b):
    sms = 132
    plan = hk.launch_plan(n, f, b, 4, sms)
    _assert_wide_plan(plan, n, f, b, sms)
    assert plan.branch in ("ranges", "split", "one_block", "rows", "capped", "small_tile")
    # the plan is the model's cheapest
    assert plan == min(hk.wide_plans(n, f, b, 4, sms), key=lambda cp: cp[0])[1]


@pytest.mark.parametrize("f", [9, 14, 28])
@pytest.mark.parametrize("b", [16384, 65536, 1 << 20])
def test_plans_past_one_feature_a_block(b, f):
    # past the ~14,000 bins of one feature's histogram and lane masks a
    # block held before bin ranges: every B launches
    sms = 132
    for n, bin_bytes in ((32768, 4), (1 << 20, 1)):
        plan = hk.launch_plan(n, f, b, bin_bytes, sms)
        _assert_wide_plan(plan, n, f, b, sms)
        assert plan.ranges > 1 and plan.bins_per_range * 16 < 232448


@pytest.mark.parametrize("n", [1, 31, 64])
def test_few_rows_at_many_bins_launch_one_block_along_the_rows(n):
    # more (group, range) blocks than the SMs hold at once: no cooperative
    # grid is co-resident, and one block along the rows (a plain launch,
    # grid_y over y and z) is always a plan
    sms, f, b = 132, 28, 1 << 20
    plan = hk.launch_plan(n, f, b, 4, sms)
    _assert_wide_plan(plan, n, f, b, sms)
    assert plan.grid_x == 1 and plan.branch == "one_block"
    assert plan.grid_y > hk.resident_blocks(plan.threads, plan.smem_bytes) * sms


@pytest.mark.parametrize("held", [1, 3])
def test_cooperative_plans_take_the_blocks_an_sm_holds_as_given(held):
    # on a card `resident` is the runtime's occupancy (device_plan): the
    # plans keep their cooperative grids within it, and skip blocks it says
    # an SM cannot hold at all
    def resident(threads, smem_bytes):
        return 0 if threads > 256 else held

    sms = 132
    for n, f, b in WIDE_PLANS + [(32768, 14, 16384), (32768, 14, 65536)]:
        plans = hk.wide_plans(n, f, b, 4, sms, resident)
        assert plans and all(p.threads <= 256 for _, p in plans)
        plan = hk.launch_plan(n, f, b, 4, sms, resident)
        assert plan == min(plans, key=lambda cp: cp[0])[1]
        _assert_wide_plan(plan, n, f, b, sms, resident)


def test_modelled_cost_at_the_mean_share_is_the_mix_mean():
    # launch_plan weighs a plan at _KEPT, the mean share of rows kept over
    # the fits' calls (tools/torch_hist_turns.py mix): the model is linear
    # in the share, so that is the mean cost of the fits' mix of calls
    shares, weights = [1.0, 0.4, 0.12, 0.03, 0.004], [0.05, 0.15, 0.3, 0.3, 0.2]
    mean = sum(s * w for s, w in zip(shares, weights))
    for n, f, b in WIDE_PLANS:
        for _, plan in hk.wide_plans(n, f, b, 4, 132)[::50]:
            def cost(kept):
                terms = hk._wide_terms(n, f, b, 132, plan, kept=kept)
                return sum(hk._WIDE_US[k] * v for k, v in terms.items())
            mixed = sum(w * cost(s) for s, w in zip(shares, weights))
            assert cost(mean) == pytest.approx(mixed, rel=1e-12)


def test_refused_only_where_the_jax_ids_overflow():
    # F x B at 2**31: the JAX package's int32 ids bins + f * B overflow
    # (mmlspark_tpu/gbdt/hist_kernel.py:93-94); one bin fewer launches
    with pytest.raises(ValueError, match=r"2\*\*31"):
        hk.launch_plan(1000, 4, 1 << 29, 4, 132)
    _assert_wide_plan(hk.launch_plan(1000, 4, (1 << 29) - 1, 4, 132), 1000, 4, (1 << 29) - 1,
                      132)
    # the CPU's plain version has no such limit of its own
    bins, stats = _inputs(50, 2, 16384, seed=5)
    assert _port(bins, stats, 16384).shape == (2, 16384, 3)


# The plans at chip_smoke.HIST_SHAPES up to 256 bins as they were before
# bin ranges, frozen field for field ((n, F, B, bin bytes) -> grid_x,
# grid_y, feats_per_group, warps_per_copy, copies, tile_rows,
# tiles_per_block, bins_buf_bytes, gather_pitch, smem_bytes) at 132 SMs:
# bin ranges change none of them
NARROW_PLANS = {
    (32768, 14, 256, 4): (128, 1, 14, 14, 2, 256, 1, 14368, 60, 154944),
    (32768, 14, 256, 1): (128, 1, 14, 14, 2, 256, 1, 3616, 20, 133440),
    (10007, 14, 256, 4): (40, 1, 14, 14, 2, 256, 1, 14368, 60, 154944),
    (1048576, 28, 256, 1): (128, 1, 28, 28, 1, 256, 32, 7200, 36, 140608),
    (1, 14, 256, 4): (1, 1, 14, 14, 2, 256, 1, 14368, 60, 154944),
    (31, 5, 16, 1): (1, 1, 5, 5, 6, 256, 1, 1312, 12, 21824),
    (5000, 5, 2, 1): (20, 1, 5, 5, 6, 256, 1, 1312, 12, 15104),
    (5000, 5, 64, 4): (20, 1, 5, 5, 6, 256, 1, 5152, 28, 52544),
    (20000, 17, 256, 4): (79, 1, 17, 17, 1, 256, 1, 17440, 76, 116032),
    (50000, 48, 256, 4): (131, 1, 48, 32, 1, 64, 6, 12320, 196, 207936),
    (50000, 100, 256, 4): (66, 2, 50, 32, 1, 64, 12, 13056, 204, 215552),
    (50000, 100, 256, 1): (66, 2, 50, 32, 1, 256, 3, 15360, 60, 228608),
    (50, 100, 256, 4): (1, 2, 50, 32, 1, 64, 1, 13056, 204, 215552),
    (32768, 108, 256, 4): (64, 2, 54, 32, 1, 64, 8, 14080, 220, 229888),
    (6144, 4096, 27, 4): (12, 11, 373, 32, 1, 32, 16, 48000, 1500, 221984),
}


@pytest.mark.parametrize("key", sorted(NARROW_PLANS), ids=lambda k: "x".join(map(str, k)))
def test_plans_up_to_256_bins_are_unchanged(key):
    n, f, b, bin_bytes = key
    plan = hk.launch_plan(n, f, b, bin_bytes, 132)
    assert tuple(plan)[:10] == NARROW_PLANS[key]
    assert (plan.bins_per_range, plan.ranges) == (b, 1)


def test_narrow_plans_cover_every_smoke_shape_up_to_256_bins():
    import chip_smoke

    shapes = {(n, f, b, 4 if dt == torch.int32 else 1)
              for _, n, f, dt, _, b in chip_smoke.HIST_SHAPES if b <= 256}
    assert shapes == set(NARROW_PLANS)


def _emulate(bins, stats, b, plan):
    """The kernel's partition of one launch, in plain torch: blocks along
    the rows (tiles_per_block tiles of tile_rows), each (feature group, bin
    range) along grid_y, and in a block above 256 bins each warp's feature
    and part of the range, as hist_kernel.cu computes them. Each part adds
    its rows in row order; the blocks' partials are summed in block order."""
    n, f = bins.shape
    rows_a_block = plan.tile_rows * plan.tiles_per_block
    parts = plan.warps_per_copy // plan.feats_per_group
    part_bins = -(-plan.bins_per_range // parts)
    owner = torch.zeros((f, b), dtype=torch.int64)     # how many warps own each bin
    partials = []
    for x in range(plan.grid_x):
        r0, r1 = x * rows_a_block, min(n, (x + 1) * rows_a_block)
        partial = torch.zeros((f, b, 3))
        for y in range(plan.grid_y):
            f0 = (y // plan.ranges) * plan.feats_per_group
            fg = min(plan.feats_per_group, f - f0)
            lo = (y % plan.ranges) * plan.bins_per_range
            nb = min(plan.bins_per_range, b - lo)
            for w in range(plan.warps_per_copy):
                j, first = w % plan.feats_per_group, (w // plan.feats_per_group) * part_bins
                width = max(0, min(part_bins, nb - first)) if j < fg else 0
                if width == 0:
                    continue
                base = lo + first
                if x == 0:
                    owner[f0 + j, base:base + width] += 1
                k = bins[r0:r1, f0 + j].long() - base
                keep = (k >= 0) & (k < width)
                # index_add_ adds the rows in row order on the CPU
                partial[f0 + j].index_add_(0, base + k[keep], stats[r0:r1][keep])
        partials.append(partial)
    assert torch.equal(owner, torch.ones_like(owner)), "a bin owned by no warp or by two"
    out = partials[0]
    for partial in partials[1:]:                   # block order
        out = out + partial
    return out


@pytest.mark.parametrize("b", [512, 4096, 16384])
def test_plan_partition_equals_the_plain_version(b):
    # a plan for 3,000 rows at a small card's SM count, so that the rows
    # spread over several blocks and the bins over several ranges; stats on
    # a 2**-10 grid (every sum exact in f32, in any order)
    n, f, sms = 3000, 3, 16
    plan = hk.launch_plan(n, f, b, 4, sms)
    assert plan.grid_x > 1 or plan.ranges > 1, plan
    bins, stats = _inputs(n, f, b, seed=11)
    stats = np.round(stats * 1024) / 1024
    tb, ts = torch.from_numpy(bins), torch.from_numpy(stats.astype(np.float32))
    assert torch.equal(_emulate(tb, ts, b, plan), hk.histogram_torch(tb, ts, b))
