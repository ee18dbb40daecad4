"""Tests of the port that need an NVIDIA GPU: the CUDA kernels have no CPU
mode. Each skips without a card. This file imports neither jax nor the JAX
package, so it also runs on a machine with a card and no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(`--noconftest`: tests/conftest.py sets up jax for the rest of the suite.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt import engine  # noqa: E402
from mmlspark_tpu_torch.gbdt import hist_kernel as hk  # noqa: E402
from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle  # noqa: E402
from mmlspark_tpu_torch.nn import attention as att  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# Every launch configuration the wrapper's launch_plan can choose, as
# (id, n, F, B, bin dtype, share of rows kept, the plan's branch): blocks
# along the rows fewer than the SMs, with two histogram copies a block
# (Adult) and one (F = 17); the grid capped at one block an SM (Higgs); one
# block along the rows (n = 1, n = 31, a feature split of 50 rows), which
# writes the output directly without the grid barrier; B = 2 and 64; a tile
# under 256 rows without a feature split (F = 48 int32); feature groups
# along grid_y (F = 100, int32 and uint8); above 256 bins, blocks that own
# a feature group and all its bins ("split": B 512 to 4096 at Adult, the
# Amazon-access and Higgs shapes at 1024), a range of them ("ranges": B
# 16,384, max_bin 16383's), and one block along the rows of a range (B
# 65,536; and 31 rows at 2**20 bins, more (group, range) blocks than the
# SMs hold at once). Each shape runs with every row kept (dense tiles) and
# with 3% kept (gathered rows)
HIST_CASES = [
    ("adult", 32768, 14, 256, np.int32, "rows"),
    ("adult_u8", 32768, 14, 256, np.uint8, "rows"),
    ("higgs", 1 << 20, 28, 256, np.uint8, "capped"),
    ("n1", 1, 14, 256, np.int32, "one_block"),
    ("n31", 31, 5, 16, np.uint8, "one_block"),
    ("b2", 5000, 5, 2, np.uint8, "rows"),
    ("b64", 5000, 5, 64, np.int32, "rows"),
    ("f17", 20000, 17, 256, np.int32, "rows"),
    ("f48_tile64", 50000, 48, 256, np.int32, "small_tile"),
    ("split_i32", 50000, 100, 256, np.int32, "split"),
    ("split_u8", 50000, 100, 256, np.uint8, "split"),
    ("split_one_block", 50, 100, 256, np.int32, "one_block"),
    ("adult_b512", 32768, 14, 512, np.int32, "split"),
    ("adult_b1024", 32768, 14, 1024, np.int32, "split"),
    ("amazon_b1024", 32769, 9, 1024, np.int32, "split"),
    ("higgs_b1024", 1 << 20, 28, 1024, np.int32, "split"),
    ("adult_b4096", 32768, 14, 4096, np.int32, "split"),
    ("adult_b16384", 32768, 14, 16384, np.int32, "ranges"),
    ("adult_b65536", 32768, 14, 65536, np.int32, "one_block"),
    ("n31_b1m", 31, 28, 1 << 20, np.int32, "one_block"),
]


@pytest.mark.parametrize("kept", [1.0, 0.03], ids=["all_rows", "3pct_rows"])
@pytest.mark.parametrize("name,n,f,b,dtype,branch", HIST_CASES, ids=[c[0] for c in HIST_CASES])
def test_cuda_kernel_matches_plain_version_and_repeats_its_bits(cuda, name, n, f, b, dtype,
                                                                branch, kept):
    rng = np.random.default_rng(4)
    plan = hk.device_plan(n, f, b, np.dtype(dtype).itemsize, torch.cuda.current_device())
    assert plan.branch == branch, plan
    bins = torch.from_numpy(rng.integers(0, b, size=(n, f)).astype(dtype)).to(cuda)
    stats = rng.normal(size=(n, 3)).astype(np.float32)
    stats[rng.random(n) >= kept] = 0.0
    # on a 2**-10 grid every partial sum is exact in f32, so any order of
    # adding gives the same bits: the kernel must equal the plain version
    grid = torch.from_numpy(np.round(stats * 1024) / 1024).to(cuda)
    stats = torch.from_numpy(stats).to(cuda)
    before = hk.histogram.launches
    exact = hk.histogram(bins, grid, b)
    assert hk.histogram.launches == before + 1
    assert torch.equal(exact, hk.histogram_torch(bins, grid, b))
    first = hk.histogram(bins, stats, b)
    again = hk.histogram(bins, stats, b)
    assert torch.equal(first, again)
    plain = hk.histogram_torch(bins, stats, b)
    if name.startswith("adult"):
        # the shape and gate of the first version of this test: rtol =
        # atol = 1e-5 as between the JAX variants (the plain version adds
        # with atomics in no fixed order)
        torch.testing.assert_close(first, plain, rtol=1e-5, atol=1e-5)
    # both against the float64 sum, relative to the bin's mass sum(|stats|),
    # which bounds the rounding of any order of f32 sums (chip_smoke.py's
    # gate; where a bin's many stats cancel, two orders part by more than
    # 1e-5 of the small result)
    ids = (bins.long() + torch.arange(f, device=cuda) * b).reshape(-1)
    exact64 = torch.zeros((f * b, 3), dtype=torch.float64, device=cuda)
    mass = torch.zeros_like(exact64)
    rows = stats.double()[:, None, :].expand(n, f, 3).reshape(-1, 3)
    exact64.index_add_(0, ids, rows)
    mass.index_add_(0, ids, rows.abs())
    for got in (first, plain):
        err = (got.reshape(-1, 3).double() - exact64).abs() / mass.clamp_min(1e-30)
        assert err.max().item() <= 1e-5


# The plans above 256 bins of the CPU tests (tests/test_torch_hist_kernel.py):
# (n, F, B, bin bytes)
WIDE_DEVICE_PLANS = ([(32768, 14, b, 4) for b in (512, 1024, 4096)]
                     + [(32769, 9, 1024, 4), (1 << 20, 28, 1024, 4)]
                     + [(n, f, b, bb) for f in (9, 14, 28) for b in (16384, 65536, 1 << 20)
                        for n, bb in ((32768, 4), (1 << 20, 1))]
                     + [(n, 28, 1 << 20, 4) for n in (1, 31, 64)])


def test_cooperative_plans_fit_what_the_runtime_says_an_sm_holds(cuda):
    # device_plan takes the blocks an SM holds from the runtime's occupancy
    # of the kernel: each cooperative grid is co-resident by it, and the
    # card takes every plan's launch (zero stats: an all-zero histogram)
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, f, b, bb in WIDE_DEVICE_PLANS:
        plan = hk.device_plan(n, f, b, bb, dev)
        held = hk._resident_on(dev, bb)(plan.threads, plan.smem_bytes)
        assert held >= 1, plan
        if plan.grid_x > 1:
            assert plan.grid_x * plan.grid_y <= held * sms, plan
        bins = torch.zeros((n, f), dtype=torch.int32 if bb == 4 else torch.uint8, device=cuda)
        stats = torch.zeros((n, 3), device=cuda)
        before = hk.histogram.launches
        out = hk.histogram(bins, stats, b)
        assert hk.histogram.launches == before + 1
        assert out.shape == (f, b, 3) and not out.any().item(), plan
        del bins, stats, out


def test_cuda_kernel_drops_out_of_range_bins_and_reads_unaligned_rows(cuda):
    # int32 bins below 0 and at or above B add nothing; views that start
    # one row into their tensors put the rows off every 16-byte boundary.
    # Stats on a 2**-10 grid: exact sums, so the kernel must equal the
    # plain version over the in-range bins
    rng = np.random.default_rng(5)
    n, f, b = 20000, 5, 64
    raw = rng.integers(-3, b + 3, size=(n + 1, f)).astype(np.int32)
    stats = np.round(rng.normal(size=(n + 1, 3)) * 1024) / 1024
    stats = torch.from_numpy(stats.astype(np.float32)).to(cuda)[1:]
    for bins in (torch.from_numpy(raw).to(cuda)[1:],
                 torch.from_numpy(np.clip(raw, 0, 255).astype(np.uint8)).to(cuda)[1:]):
        assert bins.data_ptr() % 16 != 0
        ok = (bins >= 0) & (bins < b)
        want = torch.zeros((f, b, 3), device=cuda)
        for j in range(f):
            keep = ok[:, j]
            want[j] = hk.histogram_torch(bins[keep, j:j + 1].contiguous(), stats[keep].contiguous(),
                                         b)[0]
        got = hk.histogram(bins, stats, b)
        assert torch.equal(got, want)
        assert torch.equal(got, hk.histogram(bins, stats, b))


@pytest.mark.parametrize("n,b", [(32768, 256), (31, 256), (32768, 1024), (32768, 16384)],
                         ids=["grid_barrier", "one_block", "grid_barrier_b1024_split",
                              "b16384_ranges"])
def test_histogram_in_a_cuda_graph_replays_the_eager_result(cuda, n, b):
    rng = np.random.default_rng(6)
    bins = torch.from_numpy(rng.integers(0, b, size=(n, 14)).astype(np.int32)).to(cuda)
    stats = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(cuda)
    hk.histogram(bins, stats, b)                   # warm-up: build, load, scratch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = hk.histogram.launches
    with torch.cuda.graph(graph):
        captured = hk.histogram(bins, stats, b)
    for seed in (7, 8):
        # new stats in the captured input: the replay must recompute
        stats.copy_(torch.from_numpy(
            np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, hk.histogram(bins, stats, b))
    assert hk.histogram.launches == before + 3


def test_histogram_calls_allocate_only_their_output_and_query_nothing(cuda, monkeypatch):
    rng = np.random.default_rng(9)
    bins = torch.from_numpy(rng.integers(0, 256, size=(32768, 14)).astype(np.int32)).to(cuda)
    stats = torch.from_numpy(rng.normal(size=(32768, 3)).astype(np.float32)).to(cuda)
    hk.histogram(bins, stats, 256)                 # warm-up: build, load, scratch
    torch.cuda.synchronize()
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a, **k: pytest.fail("a call queried the device"))
    allocs = torch.cuda.memory_stats(cuda)["allocation.all.allocated"]
    outs = [hk.histogram(bins, stats, 256) for _ in range(10)]
    # one allocation a call: its fresh output; the partials are reused
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] - allocs == len(outs)
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert len({o.data_ptr() for o in outs}) == len(outs)


def test_wrapper_raises_on_a_cuda_tensor_it_cannot_take(cuda):
    tb = torch.zeros((64, 4), dtype=torch.int32, device=cuda)
    ts = torch.zeros((64, 3), dtype=torch.float32, device=cuda)
    before = hk.histogram.launches
    with pytest.raises(ValueError, match="num_bins"):
        hk.histogram(tb, ts, 0)
    # F x B at 2**31, where the JAX package's int32 ids overflow: the one
    # refusal, before the output is allocated
    with pytest.raises(ValueError, match=r"2\*\*31"):
        hk.histogram(tb, ts, 1 << 29)
    with pytest.raises(ValueError, match="contiguous"):
        hk.histogram(tb.t().contiguous().t(), ts, 16)
    with pytest.raises(ValueError, match="bins on"):
        hk.histogram(tb, ts.cpu(), 16)
    assert hk.histogram.launches == before


def test_one_tree_on_the_card_equals_the_cpu_tree_bit_for_bit(cuda):
    # gradients and hessians on a 2**-10 grid: every histogram, cumulative
    # and node sum is exact in f32, so the card's sums in another order
    # give the CPU's bits and the two trees must be identical
    n, f, b = 1500, 6, 32
    rng = np.random.default_rng(7)
    bins = rng.integers(0, b, size=(n, f)).astype(np.int32)
    signal = (bins[:, 0] - b / 2) / b + 0.5 * (bins[:, 1] > b // 3)
    grad = np.round(np.tanh(signal + 0.3 * rng.normal(size=n)) * 1024) / 1024
    hess = np.round((0.05 + 0.2 * rng.random(n)) * 1024) / 1024
    args = [bins, grad.astype(np.float32), hess.astype(np.float32),
            np.ones(n, np.float32), np.ones(f, np.float32)]
    cfg = engine.GrowConfig(num_leaves=15, min_data_in_leaf=10.0)
    out = {}
    for dev in ("cpu", cuda):
        grow = engine.make_grow_fn(f, b, cfg, np.full(f, b), np.zeros(f, bool), device=dev)
        before = hk.histogram.launches
        tree, values, node = grow(*(torch.from_numpy(a).to(dev) for a in args))
        launched = hk.histogram.launches - before
        out[str(dev)] = (tree, values.cpu(), node.cpu(), launched)
    cpu, card = out["cpu"], out[str(cuda)]
    assert cpu[3] == 0 and card[3] == cfg.num_leaves
    for name in engine.TreeArrays._fields:
        assert torch.equal(getattr(cpu[0], name), getattr(card[0], name).cpu()), name
    assert torch.equal(cpu[1], card[1]) and torch.equal(cpu[2], card[2])
    assert int(cpu[0].is_leaf.sum()) == cfg.num_leaves


@pytest.mark.parametrize("b", [32, 1024])
def test_categorical_tree_on_the_card_equals_the_cpu_tree_and_reads_nothing_back(cuda, b):
    # two categorical features (one of b - 1 categories) beside numeric
    # ones, sums exact on a 2**-10 grid: the grad/hess orders, the subsets
    # and every tree field equal the CPU's, and the card's split loop runs
    # under sync debug mode "error"
    n, f = 4000, 5
    rng = np.random.default_rng(8)
    bins = rng.integers(1, 32, size=(n, f)).astype(np.int32)
    bins[:, 3] = rng.integers(0, b, size=n)
    effect = rng.normal(size=b)
    signal = effect[bins[:, 3]] + 0.5 * np.isin(bins[:, 1], [2, 5, 9, 17]) + 0.02 * bins[:, 0]
    grad = np.round(np.tanh(signal + 0.3 * rng.normal(size=n)) * 1024) / 1024
    hess = np.round((0.05 + 0.2 * rng.random(n)) * 1024) / 1024
    args = [bins, grad.astype(np.float32), hess.astype(np.float32),
            np.ones(n, np.float32), np.ones(f, np.float32)]
    nbins = np.array([32, 32, 32, b, 32])
    cat = np.array([False, True, False, True, False])
    cfg = engine.GrowConfig(num_leaves=15, min_data_in_leaf=10.0)
    out = {}
    for dev in ("cpu", cuda):
        grow = engine.make_grow_fn(f, b, cfg, nbins, cat, device=dev)
        tensors = [torch.from_numpy(a).to(dev) for a in args]
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out[str(dev)] = grow(*tensors)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    cpu, card = out["cpu"], out[str(cuda)]
    for name in engine.TreeArrays._fields:
        assert torch.equal(getattr(cpu[0], name), getattr(card[0], name).cpu()), name
    assert torch.equal(cpu[1], card[1].cpu()) and torch.equal(cpu[2], card[2].cpu())
    split = cpu[0].feature >= 0
    assert bool((cpu[0].is_categorical & split).any())
    assert int(cpu[0].cat_bitset[cpu[0].is_categorical].sum(-1).max()) > 1


@pytest.mark.parametrize("n", [14, 32768, 1 << 20])
def test_draws_on_the_card_equal_the_cpus_bit_for_bit(cuda, n):
    from mmlspark_tpu_torch.core import prng

    for seed in (0, 3, 42, 2**31 - 1):
        for it in (0, 7):
            for purpose in (1, 2, 100):
                key = prng.fold_in(prng.fold_in(prng.prng_key(seed), it), purpose)
                card = prng.uniform(key, (n,), cuda)
                assert card.device.type == "cuda"
                assert torch.equal(card.cpu().view(torch.int32),
                                   prng.uniform(key, (n,), "cpu").view(torch.int32))


def test_bagged_goss_rf_and_dart_rounds_read_nothing_back(cuda):
    # chip_smoke's check: two rounds of each loop under sync debug mode
    # "error" (the bag carried into the second round, GOSS's bar gathered
    # on the card, dart's drops and weights on the card)
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    x, y = chip_smoke.make_dataset(4096, 14)
    assert chip_smoke._rounds_without_sync(x, y) == ["gbdt_bagged", "goss", "rf", "dart"]


# K2 against its plain version, with chip_smoke.py's gates: f32 the
# reference's (tests/test_attention.py:56); bf16 two ulps of the output
# (rtol 2**-7) plus 2e-3 for outputs near 0, since p is rounded to bf16 at
# running maxima that differ between the kernel's and the plain version's
# key blocks
_F32_TOL, _BF16_TOL = (2e-5, 1e-5), (2e-3, 2.0 ** -7)


def _k2_path(dtype, d):
    """The kernel a (dtype, head dim) must take."""
    if dtype == torch.float32:
        return "tf32x3" if d <= 128 else "wide"
    if d <= 32:
        return "mma"
    return "wgmma" if d <= 256 else "wide"


# every head dim K2 is built for, so each of its instantiations runs; Tk
# 137 is ragged against every key tile, so a fragment element taken from
# the wrong lane shows as a wrong row. The mma path (bf16, D 8/16/32) takes
# 2-warp blocks at B 2 (16 blocks) and 8-warp blocks at B 16, Tq 300 (192
# blocks of 128 rows, the last one ragged, on the H100's 132 SMs); the
# wgmma path (bf16) takes 128-row items at D 64/128, and 64-row items with
# one consumer warpgroup at D 256 and at D 192 with B 2 (the next test
# holds its 128-row items at 192 to these bits)
@pytest.mark.parametrize("dtype,d,causal,tol,b,tq", [
    *[(torch.float32, d, causal, _F32_TOL, 2, 200) for d in (64, 8, 16, 32, 128)
      for causal in (False, True)],
    *[(torch.bfloat16, d, causal, _BF16_TOL, 2, 200) for d in (8, 16, 32, 64, 128, 192, 256)
      for causal in (False, True)],
    *[(torch.bfloat16, d, causal, _BF16_TOL, 16, 300) for d in (8, 16, 32)
      for causal in (False, True)],
])
def test_flash_kernel_matches_plain_version_and_repeats_its_bits(cuda, dtype, d, causal, tol, b,
                                                                 tq):
    rng = np.random.default_rng(8)
    q, k, v = (torch.tensor(rng.normal(size=(b, t, 4, d)), dtype=dtype, device=cuda)
               for t in (tq, 137, 137))
    with torch.no_grad():
        before = att.flash_attention.launches
        out, lse = att._flash_fwd_lse(q, k, v, causal)
        assert att.flash_attention.last_path == _k2_path(dtype, d)
        again, lse2 = att._flash_fwd_lse(q, k, v, causal)
        assert att.flash_attention.launches == before + 2
        ref, ref_lse = att.flash_attention_torch(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), atol=tol[0], rtol=tol[1])
    # rows with no visible key (causal, Tq > Tk) have lse +inf in both
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=2e-5, rtol=1e-5)
    assert torch.equal(out, again) and torch.equal(lse, lse2)


# At head dim 192 the wgmma path's 128-row items (two consumer
# warpgroups, where 128-row items give every SM one: 192 items at B 16,
# Tq 300) and its 64-row items (one warpgroup) run the same instructions on
# each 64 rows, key tile by key tile: a warpgroup's extra causal tiles are
# wholly masked for it and leave its state as it is. So the two give the
# same bits, and the 64-row items are held to the plain version above
@pytest.mark.parametrize("d", [136, 192])
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_two_warpgroups_give_the_bits_of_one(cuda, monkeypatch, causal, d):
    rng = np.random.default_rng(8)
    q, k, v = (torch.tensor(rng.normal(size=(16, t, 4, d)), dtype=torch.bfloat16, device=cuda)
               for t in (300, 137, 137))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = att.flash_plan(torch.bfloat16, d, 16, 4, 300, sms)
    assert plan.path == "wgmma" and plan.rows == 128
    with torch.no_grad():
        out, lse = att._flash_fwd_lse(q, k, v, causal)
        plain = att.flash_plan
        monkeypatch.setattr(att, "flash_plan", lambda *a: plain(*a)._replace(rows=64))
        out64, lse64 = att._flash_fwd_lse(q, k, v, causal)
        assert att.flash_attention.last_path == "wgmma"
    torch.cuda.synchronize()
    assert torch.equal(out, out64) and torch.equal(lse, lse64)
    assert torch.isfinite(out.float()).all() and out.abs().max() > 0


# head dims between the built ones run zero-padded to the next built one:
# D 24 on "mma" at 32 in bf16, D 96 on "wgmma" at 128, f32 on "tf32x3"
@pytest.mark.parametrize("dtype,d,path,tol", [
    (torch.bfloat16, 24, "mma", _BF16_TOL), (torch.bfloat16, 96, "wgmma", _BF16_TOL),
    (torch.float32, 24, "tf32x3", _F32_TOL), (torch.float32, 96, "tf32x3", _F32_TOL),
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_pads_head_dims_between_built_ones_at_the_true_scale(cuda, dtype, d, path,
                                                                          tol, causal):
    rng = np.random.default_rng(13)
    q, k, v = (torch.tensor(rng.normal(size=(2, t, 4, d)), dtype=dtype, device=cuda)
               for t in (200, 137, 137))
    with torch.no_grad():
        out, lse = att._flash_fwd_lse(q, k, v, causal)
        assert att.flash_attention.last_path == path
        again, lse2 = att._flash_fwd_lse(q, k, v, causal)
        ref, ref_lse = att.flash_attention_torch(q, k, v, causal)
        # the plain version at the padded width scales by that width's
        # d ** -0.5: the kernel's lse must be off from it by far more than
        # the gate, or the test could not tell the two scales apart
        dk = 32 if d == 24 else 128
        wide = [torch.nn.functional.pad(x, (0, dk - d)) for x in (q, k, v)]
        _, wrong_lse = att.flash_attention_torch(*wide, causal)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol[0], rtol=tol[1])
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=2e-5, rtol=1e-5)
    assert (lse[fin] - wrong_lse[fin]).abs().max().item() > 1e-2
    assert torch.equal(out, again) and torch.equal(lse, lse2)


# head dims above 128: bf16 up to 256 on "wgmma" at 192 or 256, reading
# the true D through its tensor maps (136, 160, 200: zeros past D), f32 and
# bf16 above on "wide", a block's warps splitting the head dim (320: five
# column warps; 132: the copies' zeros past D in f32), and beyond a block's
# columns (f32 384 and 1,000, bf16 704) in slices that each sum S over the
# head dim in groups; 129 rows are no 16 bytes, so they alone are padded.
# Tq 200 and Tk 137 are ragged against every tile; with no keys every row
# has l == 0 (output 0, lse +inf); q, k and v also as views of one fused
# qkv tensor
@pytest.mark.parametrize("dtype,tol,d", [
    *[(torch.bfloat16, _BF16_TOL, d) for d in (129, 136, 160, 192, 200, 256, 320, 704)],
    *[(torch.float32, _F32_TOL, d) for d in (129, 132, 136, 160, 192, 256, 320, 384, 1000)],
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_wide_kernel_matches_plain_version_above_128(cuda, causal, d, dtype, tol):
    rng = np.random.default_rng(14)
    q, k, v = (torch.tensor(rng.normal(size=(2, t, 4, d)), dtype=dtype, device=cuda)
               for t in (200, 137, 137))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = att.flash_plan(dtype, d, 2, 4, 200, sms)
    assert plan.path == _k2_path(dtype, d) and plan.pad == (d == 129), plan
    with torch.no_grad():
        before = att.flash_attention.launches
        out, lse = att._flash_fwd_lse(q, k, v, causal)
        assert att.flash_attention.last_path == plan.path
        again, lse2 = att._flash_fwd_lse(q, k, v, causal)
        assert att.flash_attention.launches == before + 2
        ref, ref_lse = att.flash_attention_torch(q, k, v, causal)
        padded = [torch.nn.functional.pad(x, (0, plan.d_kernel - d)) for x in (q, k, v)]
        _, wrong_lse = att.flash_attention_torch(*padded, causal)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype
    # no pad copy where the plan needs none: the output is the kernel's own
    assert out.is_contiguous() == (not plan.pad)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol[0], rtol=tol[1])
    assert torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
    fin = torch.isfinite(ref_lse)
    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=2e-5, rtol=1e-5)
    if plan.d_kernel != d:
        # the kernel's built D is wider: the scale must be the true D's
        assert (lse[fin] - wrong_lse[fin]).abs().max().item() > 1e-2
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    with torch.no_grad():
        none_out, none_lse = att._flash_fwd_lse(q, k[:, :0], v[:, :0], causal)
    assert torch.equal(none_out, torch.zeros_like(q)) and torch.isinf(none_lse).all()
    if plan.pad:
        return
    qkv = torch.tensor(rng.normal(size=(2, 200, 3, 4, d)), dtype=dtype, device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    with torch.no_grad():
        out, lse = att._flash_fwd_lse(q, k, v, causal)
        assert att.flash_attention.last_path == plan.path
        ref, ref_lse = att.flash_attention_torch(*(x.contiguous() for x in (q, k, v)), causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol[0], rtol=tol[1])
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, _BF16_TOL), (torch.float32, _F32_TOL)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_reads_q_k_v_through_the_strides_of_a_packed_tensor(cuda, causal, dtype,
                                                                         tol):
    # q, k and v as views of one packed (B, T, 3, H, D) tensor, the layout a
    # fused qkv projection gives: the tensor maps (bf16) and the async
    # copies (f32) must step by 3 H D a token
    rng = np.random.default_rng(12)
    qkv = torch.tensor(rng.normal(size=(2, 200, 3, 4, 64)), dtype=dtype, device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert q.stride() == (200 * 3 * 4 * 64, 3 * 4 * 64, 64, 1)
    with torch.no_grad():
        out, lse = att._flash_fwd_lse(q, k, v, causal)
        assert att.flash_attention.last_path == _k2_path(dtype, 64)
        ref, ref_lse = att.flash_attention_torch(*(x.contiguous() for x in (q, k, v)), causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol[0], rtol=tol[1])
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-5)


def test_flash_wrapper_raises_on_a_cuda_tensor_it_cannot_take(cuda):
    q = torch.zeros((1, 8, 2, 0), device=cuda)
    before = att.flash_attention.launches
    with pytest.raises(ValueError, match="head dim 0 is not a head dim"):
        att.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 16), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="trainer"):
        att.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="devices"):
        att.flash_attention(q.detach(), q.detach().cpu(), q.detach())
    flat = torch.zeros(8 * 2 * 16 + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(1, 8, 2, 16)            # rows 2 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="aligned"):
        att.flash_attention(shifted, shifted, shifted)
    # bf16 with D = 8: a row is one 16-byte copy, so it must be aligned too
    flat = torch.zeros(8 * 2 * 8 + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(1, 8, 2, 8)
    with pytest.raises(ValueError, match="aligned"):
        att.flash_attention(shifted, shifted, shifted)
    # f32 rows 4 bytes off, and an f32 head stride that is no multiple of 4
    flat = torch.zeros(8 * 2 * 8 + 1, device=cuda)
    shifted = flat[1:].view(1, 8, 2, 8)
    with pytest.raises(ValueError, match="aligned"):
        att.flash_attention(shifted, shifted, shifted)
    wide = torch.zeros((1, 8, 2, 10), device=cuda)[..., :8]    # head stride 10
    assert wide.stride(-1) == 1
    with pytest.raises(ValueError, match="aligned"):
        att.flash_attention(wide, wide, wide)
    assert att.flash_attention.launches == before


def test_transformer_serves_on_the_card_as_on_the_cpu(cuda):
    kw = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=100,
              num_outputs=3, max_len=64, attention_impl="flash")
    bundle = ModelBundle.init("transformer", (40,), seed=1, **kw)
    x = np.random.default_rng(9).integers(0, 100, size=(20, 40))
    outs = {}
    for dev in ("cpu", "cuda"):
        before = att.flash_attention.launches
        stage = DeepModelTransformer(input_col="x", mini_batch_size=8, device=dev,
                                     fetch_dict={"l": "logits"}).set_model(bundle)
        outs[dev] = np.asarray(stage.transform(Table({"x": x}))["l"])
        outs[dev + "_launches"] = att.flash_attention.launches - before
    assert outs["cpu_launches"] == 0 and outs["cuda_launches"] == 3 * 2
    # f32 throughout, TF32 off: sums in another order only
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=1e-4, rtol=1e-4)
