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
    # inputs that require grad launch the differentiable K2 (FlashAttention)
    assert att.flash_attention(q, q, q).requires_grad
    assert att.flash_attention.launches == before + 1
    before = att.flash_attention.launches
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


def _adult_like(n, f=14, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[:, 3] = np.round(np.abs(x[:, 3]) * 5)
    y = (x[:, 0] - 0.7 * x[:, 1] + 0.4 * x[:, 2] * x[:, 4] + rng.normal(scale=0.8, size=n)
         > 0).astype(np.float64)
    return x, y


def test_checkpointed_fit_on_the_card_equals_the_uninterrupted_fit(cuda, tmp_path):
    # chunks of 9 (checkpoint_every_n 10 aligned to the bag's 3 rounds),
    # then a fit preempted after its first snapshot and resumed: both
    # byte for byte the uninterrupted fit's model, K1 launched every split
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.resilience.elastic import (Preempted, PreemptionGuard,
                                                       set_active_guard)

    x, y = _adult_like(32768)
    tbl = Table({"features": x, "label": y})
    kw = dict(num_iterations=20, num_leaves=31, seed=3, bagging_fraction=0.8, bagging_freq=3,
              device="cuda")
    before = hk.histogram.launches
    ref = GBDTClassifier(**kw).fit(tbl)
    assert hk.histogram.launches - before == 20 * 31
    chunked = GBDTClassifier(checkpoint_dir=str(tmp_path / "a"), checkpoint_every_n=10,
                             **kw).fit(tbl)
    assert chunked.booster.to_text() == ref.booster.to_text()
    guard = PreemptionGuard(install=False)
    guard.request_drain("test")
    set_active_guard(guard)
    try:
        with pytest.raises(Preempted):
            GBDTClassifier(checkpoint_dir=str(tmp_path / "b"), checkpoint_every_n=10,
                           **kw).fit(tbl)
    finally:
        set_active_guard(None)
    resumed = GBDTClassifier(checkpoint_dir=str(tmp_path / "b"), checkpoint_every_n=10,
                             **kw).fit(tbl)
    assert resumed.booster.to_text() == ref.booster.to_text()
    assert np.array_equal(resumed.booster.predict_raw(x[:4096], device="device"),
                          ref.booster.predict_raw(x[:4096], device="device"))


def test_zoo_lightgbm_model_scores_on_the_card_as_the_host_walk(cuda):
    import os

    from mmlspark_tpu_torch.gbdt import Booster

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "model_zoo",
                        "gbdt_adult_census_synthetic.model")
    booster = Booster.load_native_model(path)
    assert booster.device.startswith("cuda")
    x = np.random.default_rng(8).normal(size=(8192, 28)).astype(np.float32).astype(np.float64)
    host = booster.predict_raw(x, device="host")
    assert np.array_equal(booster.predict_raw(x, device="device"), host)
    params, fn = booster.device_predict_fn()
    assert np.array_equal(fn(params, x).cpu().numpy(), host)


def test_two_rank_gloo_mesh_fit_on_the_card_agrees_with_the_one_device_fit(cuda, tmp_path):
    # two spawned ranks share the card over gloo (NCCL takes one rank a
    # card): both hold the same model, each launched K1 once a split on
    # its own rows, and the model meets the one-device card fit by
    # chip_smoke.compare_fits at 1e-4 (K1's block-order sums and the
    # merge add in other orders), every tree compared or the comparison
    # ended by a near-tie, with predictions then within 1e-3
    import os
    import sys

    import test_torch_mesh_jobs as jobs
    from mmlspark_tpu_torch.gbdt import Booster
    from mmlspark_tpu_torch.gbdt.booster import TrainOptions
    from mmlspark_tpu_torch.parallel import RankPool

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))
    import chip_smoke

    x, y = _adult_like(32768)
    opts = dict(objective="binary", num_iterations=10, num_leaves=31)
    single = Booster.train(x, y, TrainOptions(device="cuda", **opts))
    with RankPool(2, backend="gloo", workdir=str(tmp_path), timeout_s=300) as pool:
        out = pool.run(jobs.train, x, y, opts, [0, 1], device="cuda")
    assert out[0][0] == out[1][0]
    assert [o[1] for o in out] == [10 * 31] * 2
    assert all(o[2]["calls"] == 10 * 31 for o in out)
    mesh = Booster.from_text(out[0][0], device="cuda")
    parity = chip_smoke.compare_fits(single, mesh, single.bin_mapper.transform(x), tol=1e-4)
    if parity["trees_compared"] < single.num_trees:
        np.testing.assert_allclose(mesh.predict(x), single.predict(x), rtol=1e-3, atol=1e-3)


def test_two_rank_fused_transformer_on_the_card_replays_its_graphs(cuda, tmp_path):
    """A bf16 flash transformer fused under a data mesh of 2 gloo ranks
    sharing the card: each rank captures one CUDA graph a rung of its
    block (rung / 2 rows) and replays it on the second transform, launches
    K2 on "wgmma" once a layer a fused forward, and both ranks return the
    same bytes, within 1e-4 of the one-process fused transform at the
    ranks' block size."""
    import test_torch_fusion_mesh_jobs as jobs
    from mmlspark_tpu_torch.core import fuse, pipeline_model
    from mmlspark_tpu_torch.parallel import RankPool

    cfg = dict(num_layers=2, d_model=128, num_heads=2, d_ff=256, vocab_size=64, max_len=64,
               num_outputs=4, attention_impl="flash")
    bundle = ModelBundle.init("transformer", (64,), seed=4, dtype="bfloat16", **cfg)
    tokens = np.random.default_rng(5).integers(0, 64, size=(40, 64)).astype(np.float64)
    with RankPool(2, backend="gloo", workdir=str(tmp_path), timeout_s=300) as pool:
        out = sorted(pool.run(jobs.fused_transformer, bundle.to_bytes(), tokens, 16, 2),
                     key=lambda r: r["shard"])
    assert out[0]["cols"]["probability"].tobytes() == out[1]["cols"]["probability"].tobytes()
    for r in out:
        first, second = r["runs"]
        assert second["captures"] == first["captures"] > 0
        assert second["replays"] - first["replays"] == second["forwards"] == 3
        for run in (first, second):
            assert run["k2"] == {"wgmma": cfg["num_layers"] * run["forwards"]}, run
        assert r["stats"]["mesh_shape"] == "2x1"
    runner = DeepModelTransformer(input_col="x", bfloat16=False, device="cuda",
                                  fetch_dict={"probability": "probability"}).set_model(bundle)
    one = fuse(pipeline_model(runner), mini_batch_size=8, device="cuda")
    want = np.asarray(one.transform(Table({"x": tokens}))["probability"])
    np.testing.assert_allclose(out[0]["cols"]["probability"], want, atol=1e-4, rtol=0)


def test_dnn_fit_on_the_card_launches_k2_once_a_layer_a_step_and_tracks_the_cpu(cuda):
    """A bf16 flash transformer at head dim 64 trains on the card: K2 runs
    every layer's forward of every step on "wgmma" (twice under remat), the
    losses are finite, and remat changes no bit. The same f32 fit on the
    card and on the CPU (one initial bundle, TF32 off) ends within 1e-3 of
    each parameter leaf's largest magnitude."""
    from mmlspark_tpu_torch.nn import DNNLearner, flax_blob

    rng = np.random.default_rng(3)
    x = rng.integers(0, 64, size=(64, 32))
    y = (x[:, 0] >= 32).astype(np.float64)
    cfg = dict(num_layers=2, d_model=128, num_heads=2, d_ff=256, vocab_size=64, max_len=32,
               attention_impl="flash")
    bundle = ModelBundle.init("transformer", (32,), seed=2, num_outputs=2, dtype="bfloat16",
                              **cfg)
    fits = {}
    for remat in (False, True):
        est = DNNLearner(architecture="transformer", epochs=2, batch_size=16, remat=remat,
                         use_mesh=False, optimizer="adamw", learning_rate=1e-3)
        est.init_bundle = bundle
        att.flash_attention.launches, att.flash_attention.launches_by_path = 0, {}
        fits[remat] = est.fit(Table({"features": x, "label": y}))
        steps = 2 * 4
        assert att.flash_attention.launches_by_path == {"wgmma": (2 if remat else 1) * steps * 2}
        assert all(np.isfinite(est.epoch_losses))
    assert flax_blob.to_bytes(fits[True].bundle.variables) == \
        flax_blob.to_bytes(fits[False].bundle.variables)

    f32 = ModelBundle.init("transformer", (32,), seed=2, num_outputs=2, **cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        est = DNNLearner(architecture="transformer", epochs=2, batch_size=16, use_mesh=False,
                         bfloat16=False, device=dev)
        est.init_bundle = f32
        out[dev] = est.fit(Table({"features": x, "label": y})).bundle.variables["params"]

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]

    card = dict(leaves(out["cuda"]))
    for path, want in leaves(out["cpu"]):
        if path[-2:] == ("key", "bias"):     # zero gradient in exact arithmetic
            continue
        gap = float(np.abs(card[path] - want).max())
        assert gap <= 1e-3 * float(np.abs(want).max()) + 1e-6, (path, gap)


# the resize ratios of tests/test_torch_image_ops.py: 256 -> 224, 24 -> 16,
# an upsample to 37 x 23, 300 -> 224
RESIZE_RATIOS = [(256, 224, 224), (24, 16, 16), (16, 37, 23), (300, 224, 224)]


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3", "nearest"])
@pytest.mark.parametrize("size,oh,ow", RESIZE_RATIOS,
                         ids=[f"{r[0]}to{r[1]}x{r[2]}" for r in RESIZE_RATIOS])
def test_resize_on_the_card_matches_the_cpu(cuda, size, oh, ow, method):
    """The port of jax.image.resize on a CUDA tensor runs there (TF32 off:
    f32 contractions) and gives the CPU's values within 1e-3 on 0-255;
    "nearest" gathers the same pixels."""
    from mmlspark_tpu_torch.image.ops import resize_nhwc

    x = torch.from_numpy(np.random.default_rng(size).integers(
        0, 256, size=(4, size, size, 3), dtype=np.uint8))
    card = resize_nhwc(x.to(cuda), oh, ow, method)
    assert card.is_cuda and card.shape == (4, oh, ow, 3)
    cpu = resize_nhwc(x, oh, ow, method)
    if method == "nearest":
        assert torch.equal(card.cpu(), cpu)
    else:
        torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-3)


def test_image_chain_on_the_card_matches_the_cpu(cuda):
    """chip_smoke's slice_featurize chain on 16 images of 256 x 256: the
    continuous ops within 1e-3 on 0-255; the threshold's output equal
    wherever its input lies more than 1e-3 from the threshold."""
    from mmlspark_tpu_torch.image import ImageTransformer

    x = np.random.default_rng(16).integers(0, 256, size=(16, 256, 256, 3), dtype=np.uint8)

    def chain(device, threshold=True):
        t = (ImageTransformer(device=device).resize(224, 224).crop(16, 16, 192, 192).flip(1)
             .gray(keep_channels=True).blur(3, 3).gaussian_kernel(5, 1.0))
        if threshold:
            t = t.threshold(100.0)
        return np.asarray(t.transform(Table({"image": x}))["image_out"])

    before = {d: chain(d, threshold=False) for d in ("cuda", "cpu")}
    np.testing.assert_allclose(before["cuda"], before["cpu"], rtol=0, atol=1e-3)
    card, cpu = chain("cuda"), chain("cpu")
    assert card.shape == (16, 192, 192, 3)
    near = np.abs(before["cpu"] - 100.0) <= 1e-3
    assert np.array_equal(card[~near], cpu[~near])


def _k1_fits(table, make, cuda):
    """`make(device)` fitted on the CPU and on the card: (cpu, card) boosters
    and the card fit's K1 launches."""
    cpu = make("cpu").fit(table)
    before = hk.histogram.launches
    card = make("cuda").fit(table)
    return cpu, card, hk.histogram.launches - before


def test_csv_to_train_classifier_on_the_card_tracks_the_cpu(cuda, tmp_path):
    """read_csv of chip_smoke's Adult CSV (2,000 rows) -> CleanMissingData ->
    TrainClassifier(GBDTClassifier, 5 rounds of 15 leaves) on the card and
    the CPU: equal matrices, trees by compare_fits at 1e-4 through K1,
    held-out predictions decoded alike where the margins are not near 0."""
    import chip_smoke
    from mmlspark_tpu_torch.automl import TrainClassifier
    from mmlspark_tpu_torch.core import Pipeline, read_csv
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.ops import CleanMissingData

    path = tmp_path / "adult.csv"
    path.write_bytes(chip_smoke.adult_csv_bytes(2500))
    table = read_csv(str(path))
    train, held = table.slice(0, 2000), table.slice(2000, 2500)
    cols = list(chip_smoke.ADULT_NUMERIC)

    def make(device):
        return Pipeline([CleanMissingData(input_cols=cols, output_cols=cols),
                         TrainClassifier(model=GBDTClassifier(num_iterations=5, num_leaves=15,
                                                              device=device),
                                         label_col="income")])

    cpu, card, launches = _k1_fits(train, make, cuda)
    assert launches == 5 * 15
    x = chip_smoke._featurized(cpu, train)
    assert np.array_equal(x, chip_smoke._featurized(card, train))
    b_cpu, b_card = (f.stages[1].inner_model.booster for f in (cpu, card))
    assert b_card.device.startswith("cuda")
    chip_smoke.compare_fits(b_cpu, b_card, b_cpu.bin_mapper.transform(x), tol=1e-4)
    sure = np.abs(b_cpu.predict_raw(chip_smoke._featurized(cpu, held), device="host")) > 1e-2
    assert np.array_equal(np.asarray(card.transform(held)["prediction"])[sure],
                          np.asarray(cpu.transform(held)["prediction"])[sure])


def test_cacher_on_the_card_uploads_with_jax_dtypes(cuda):
    from mmlspark_tpu_torch.core import DeviceTable
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.ops import Cacher, CleanMissingData

    cols = {"f64": np.array([1.0, np.nan, 3.0, 0.5]), "i64": np.arange(4),
            "u8": np.arange(4, dtype=np.uint8), "x": np.arange(8.0).reshape(4, 2) / 3,
            "s": ["a", "b", "c", "d"]}
    out = Cacher().transform(Table(cols))
    want = {"f64": torch.float32, "i64": torch.int32, "u8": torch.uint8, "x": torch.float32}
    for name, dtype in want.items():
        assert out[name].is_cuda and out[name].dtype == dtype, name
    assert out["s"] == cols["s"]
    assert DeviceTable.from_host({"a": cols["i64"]})["a"].dtype == torch.int32
    filled = CleanMissingData(input_cols=["f64"], output_cols=["g"]).fit(out).transform(out)
    assert filled["g"].dtype == np.float32 and filled["g"][1] == np.float32((1.0 + 3.0 + 0.5) / 3)
    tbl = Table({"features": np.random.default_rng(0).normal(size=(256, 3)),
                 "label": np.arange(256) % 2 * 1.0})
    from_cache = GBDTClassifier(num_iterations=2, num_leaves=4).fit(Cacher().transform(tbl))
    from_f32 = GBDTClassifier(num_iterations=2, num_leaves=4).fit(
        Table({"features": tbl["features"].astype(np.float32), "label": tbl["label"]}))
    assert from_cache.booster.to_text() == from_f32.booster.to_text()


def test_text_fit_on_the_card_tracks_the_cpu(cuda):
    """256 of chip_smoke's seeded documents through TextFeaturizer (4,096
    features) -> GBDTClassifier (3 rounds of 7 leaves), on the card (K1 at
    F 4,096) and the CPU: trees by compare_fits at 1e-4."""
    import chip_smoke
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.text import TextFeaturizer

    docs, y = chip_smoke.text_corpus(256)
    table = Table({"text": docs, "label": y})
    feats = TextFeaturizer(num_features=4096).fit(table).transform(table)
    cpu, card, launches = _k1_fits(
        feats, lambda d: GBDTClassifier(num_iterations=3, num_leaves=7, device=d), cuda)
    assert launches == 3 * 7
    chip_smoke.compare_fits(cpu.booster, card.booster,
                            cpu.booster.bin_mapper.transform(feats["features"]), tol=1e-4)


# ---- pipeline fusion and serving on the card ---- #


def _fusion_chain(rng, n=3000, f=6):
    from mmlspark_tpu_torch.core import pipeline_model
    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressor
    from mmlspark_tpu_torch.ops.conversion import DataConversion
    from mmlspark_tpu_torch.ops.featurize import AssembleFeatures
    from mmlspark_tpu_torch.ops.missing import CleanMissingData

    cols = {f"c{i}": rng.normal(size=n).astype(np.float32) for i in range(f)}
    cols["c0"][::40] = np.nan
    table = Table(cols)
    clean = CleanMissingData(input_cols=["c0"], output_cols=["c0"],
                             cleaning_mode="Mean").fit(table)
    asm = AssembleFeatures(columns_to_featurize=list(cols)).fit(table)
    x = asm.transform(clean.transform(table))["features"].astype(np.float64)
    y = np.sin(np.nan_to_num(x[:, 0])) + (x[:, 1] > 0)
    reg = GBDTRegressor(num_iterations=8, num_leaves=15, device="cuda").fit(
        Table({"features": x, "label": y}))
    conv = DataConversion(cols=["prediction"], convert_to="float")
    return table, pipeline_model(clean, asm, reg, conv), reg, list(cols)


def test_fused_segment_on_the_card_equals_the_staged_path_byte_for_byte(cuda):
    from mmlspark_tpu_torch.core import fuse

    table, staged_model, _, _ = _fusion_chain(np.random.default_rng(41))
    fm = fuse(staged_model, mini_batch_size=1024, device="cuda")
    staged = staged_model.transform(table)
    fused = fm.transform(table)
    seg = fm._segments[0]
    assert fm.last_stats["segments"][0]["kind"] == "fused"
    assert seg.captures == 1 and seg.replays == 3       # the 952-row tail pads to 1024
    for c in staged.columns:
        assert staged[c].dtype == fused[c].dtype, c
        assert staged[c].tobytes() == fused[c].tobytes(), c
        assert staged.meta(c) == fused.meta(c), c
    again = fm.transform(table)
    assert seg.captures == 1 and seg.replays == 6
    assert again["prediction"].tobytes() == fused["prediction"].tobytes()


def test_resident_lag2_warm_keeps_each_batch_its_own_outputs(cuda):
    """Batch N+1's replay writes over the graph's outputs before a lag-2
    readback fetches batch N: each dispatch's outputs are its own copy."""
    from mmlspark_tpu_torch.core import fuse

    rng = np.random.default_rng(43)
    table, staged_model, _, cols = _fusion_chain(rng)
    ex = fuse(staged_model, device="cuda").resident_executor()
    rows = {c: np.asarray(table[c][:64]) for c in cols}
    n = ex.warm(rows, [64, 64, 64, 32, 64, 32], readback_lag=2)
    assert n == 6
    outs = []
    for start in (0, 64, 128, 192):             # four batches in flight, then fetched
        outs.append(ex.dispatch({c: np.asarray(table[c][start:start + 64]) for c in cols}))
    got = [ex.fetch(o, 64)["prediction"] for o in outs]
    want = staged_model.transform(Table({c: np.asarray(table[c][:256]) for c in cols}))
    assert np.concatenate(got).tobytes() == want["prediction"].tobytes()
    assert ex.segment.captures == 2 and ex.stats()["misses"] == 2


def test_serve_model_on_the_card_replies_as_the_cpu_server(cuda):
    import json
    import time
    import urllib.request

    from mmlspark_tpu_torch.gbdt.booster import Booster
    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressionModel
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData
    from mmlspark_tpu_torch.io_http.serving import serve_model

    rng = np.random.default_rng(47)
    _, _, reg, cols = _fusion_chain(rng)
    cpu = GBDTRegressionModel()
    cpu.booster = Booster.from_text(reg.booster.to_text(), device="cpu")
    feats = rng.normal(size=(24, len(cols))).astype(np.float32).astype(np.float64)
    warm = HTTPRequestData.from_json("/", dict(zip(cols, feats[0].tolist())))
    replies = {}
    for device, model in (("cuda", reg), ("cpu", cpu)):
        srv = serve_model(model, cols, max_batch_size=8, warmup_request=warm, device=device)
        try:
            deadline = time.monotonic() + 60
            while not srv.ready:
                assert time.monotonic() < deadline, "server never ready"
                time.sleep(0.02)
            assert srv.hot_path.disabled is None
            srv.hot_path.force_path = "resident"
            out = []
            for row in feats:
                req = urllib.request.Request(srv.url, data=json.dumps(
                    dict(zip(cols, row.tolist()))).encode())
                with urllib.request.urlopen(req, timeout=30) as r:
                    out.append(r.read())
            assert srv.hot_path.resident_batches > 0
            replies[device] = out
        finally:
            srv.stop()
    assert replies["cuda"] == replies["cpu"]


def _fleet_gbdt_factory(model_path, cols, device):
    """A fleet replica's handler (module-level: the spawned replica finds it
    by name): the regressor loaded from the parent's file, fused on
    `device`, a batch at a time."""
    from mmlspark_tpu_torch.core import fuse, pipeline_model
    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressionModel
    from mmlspark_tpu_torch.io_http.schema import make_reply, parse_request

    model = fuse(pipeline_model(GBDTRegressionModel.load_native_model(model_path, device=device)),
                 device=device)

    def handler(table):
        t = parse_request(table)
        feats = np.stack([np.asarray(t[c], np.float64) for c in cols], 1)
        return make_reply(model.transform(Table({"features": feats})), "prediction")

    return handler


def _compute_contexts():
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return [line for line in out.splitlines() if line.strip()]


def test_fleet_on_the_card_replies_through_a_gateway_as_the_cpu_server(cuda, tmp_path):
    import functools
    import json
    import time
    import urllib.request

    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressor
    from mmlspark_tpu_torch.io_http.gateway import ServingGateway
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData
    from mmlspark_tpu_torch.io_http.serving import ServingFleet, ServingServer

    rng = np.random.default_rng(53)
    x = rng.normal(size=(2000, 6)).astype(np.float32).astype(np.float64)
    y = x @ rng.normal(size=6) + rng.normal(scale=0.1, size=2000)
    path = str(tmp_path / "model.json")
    GBDTRegressor(num_iterations=20, num_leaves=15, device="cpu").fit(
        Table({"features": x, "label": y})).save_native_model(path)
    cols = [f"f{j}" for j in range(6)]
    rows = [dict(zip(cols, map(float, r))) for r in x[:24]]
    warm = HTTPRequestData.from_json("/", rows[0])

    def post_all(url):
        out = []
        for row in rows:
            req = urllib.request.Request(url, data=json.dumps(row).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                out.append(r.read())
        return out

    cpu = ServingServer(_fleet_gbdt_factory(path, cols, "cpu"), max_batch_size=8,
                        bucket_batches=True, warmup_request=warm).start()
    try:
        want = post_all(cpu.url)
    finally:
        cpu.stop()
    before = len(_compute_contexts())
    fleet = ServingFleet(functools.partial(_fleet_gbdt_factory, path, cols, "cuda"),
                         n_hosts=2, max_batch_size=8, bucket_batches=True,
                         warmup_request=warm).start()
    gw = None
    try:
        assert len(_compute_contexts()) == before + 2
        gw = ServingGateway(strategy="round_robin").attach_fleet(fleet).start()
        got = post_all(gw.url)
        assert all(r["answered"] > 0 for r in fleet.info()["replicas"])
    finally:
        if gw is not None:
            gw.stop()
        procs = list(fleet._procs)
        fleet.stop()
    assert got == want
    assert all(p.exitcode is not None for p in procs)
    deadline = time.monotonic() + 10
    while len(_compute_contexts()) != before and time.monotonic() < deadline:
        time.sleep(0.1)
    assert len(_compute_contexts()) == before, "a replica still holds the card"


def _small_flash_bundle():
    kw = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=100,
              num_outputs=3, max_len=64, attention_impl="flash")
    return ModelBundle.init("transformer", (40,), seed=1, **kw)


def test_armed_fused_transformer_records_compute_and_cost_runs_nothing(cuda, monkeypatch):
    """An armed profiler on a fused flash-attention segment on the card: the
    `fused` ledger carries a compute phase; `cost` on the segment's CUDA
    graph replays nothing (K2's counter and the replay count stay put); and
    while another thread captures a graph, the only device-wide synchronizes
    are the captures' own warm-ups, never the profiler's compute wait."""
    import threading
    import traceback

    from mmlspark_tpu_torch.core import fuse, pipeline_model
    from mmlspark_tpu_torch.observability.metrics import MetricsRegistry
    from mmlspark_tpu_torch.observability.profiler import Profiler, set_default_profiler

    bundle = _small_flash_bundle()
    x = np.random.default_rng(9).integers(0, 100, size=(40, 40)).astype(np.float64)

    def fused():
        stage = DeepModelTransformer(input_col="x", device="cuda",
                                     fetch_dict={"l": "logits"}).set_model(bundle)
        return fuse(pipeline_model(stage), mini_batch_size=16, device="cuda")

    fm, other = fused(), fused()
    syncs = []
    real_sync = torch.cuda.synchronize

    def spy(*args, **kwargs):
        syncs.append([f.name for f in traceback.extract_stack()])
        return real_sync(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", spy)
    prof = Profiler(registry=MetricsRegistry(), enabled=True)
    prev = set_default_profiler(prof)
    try:
        capture = threading.Thread(target=lambda: other.transform(Table({"x": x[:24]})))
        capture.start()
        out = fm.transform(Table({"x": x}))
        capture.join(timeout=120)
        seg = fm._ensure_segments()[0]
        launches, replays = att.flash_attention.launches, seg.replays
        graph = next(iter(seg._graphs.values()))
        params, args = seg._build(), tuple(graph.static_in)
        led = prof.ledger("fused", "probe")
        assert led.cost(("probe",), graph, params, args) is None
        led.done()
        torch.cuda.current_stream().synchronize()
        assert att.flash_attention.launches == launches and seg.replays == replays
    finally:
        set_default_profiler(prev)
    assert all(any(name == "_capture" for name in stack) for stack in syncs), \
        "a device-wide synchronize outside a graph capture's warm-up"
    rows = {r["segment"]: r for r in prof.attribution()}
    assert rows["seg0"]["kind"] == "fused" and rows["seg0"]["phase_us"]["compute"] > 0
    assert seg.captures >= 1 and seg.replays == 3            # 40 rows in 16-row chunks
    staged = DeepModelTransformer(input_col="x", device="cuda", mini_batch_size=16,
                                  fetch_dict={"l": "logits"}).set_model(bundle)
    np.testing.assert_allclose(np.asarray(out["l"]),
                               np.asarray(staged.transform(Table({"x": x}))["l"]),
                               atol=1e-4, rtol=1e-4)


def test_streaming_query_fuses_its_segments_onto_the_card(cuda):
    from mmlspark_tpu_torch.core import FusedPipelineModel, pipeline_model
    from mmlspark_tpu_torch.streaming import MemorySink, MemorySource, StreamingQuery

    bundle = _small_flash_bundle()
    stage = DeepModelTransformer(input_col="x", device="cuda",
                                 fetch_dict={"l": "logits"}).set_model(bundle)
    src, sink = MemorySource(), MemorySink()
    q = StreamingQuery(src, pipeline_model(stage), sink)
    assert isinstance(q.transform, FusedPipelineModel) and q.transform.get("device") == "cuda"
    x = np.random.default_rng(3).integers(0, 100, size=(24, 40)).astype(np.float64)
    before = att.flash_attention.launches
    for lo, hi in ((0, 8), (8, 24)):
        src.add_rows(Table({"x": x[lo:hi]}))
        assert q.process_all_available() == 1
    q.stop()
    seg = q.transform._ensure_segments()[0]
    assert seg.device.type == "cuda" and seg.captures >= 1
    assert att.flash_attention.launches - before == 2 * seg.forwards
    want = stage.transform(Table({"x": x}))["l"]
    np.testing.assert_allclose(np.asarray(sink.table()["l"]), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_elastic_dnn_digest_on_the_card_is_the_same_at_one_and_two_workers(cuda, tmp_path):
    # in-process workers on the card (the real-process kill and respawn is
    # chip_smoke.py's slice_elastic): every shard's padded batch is the same
    # cuBLAS problem in any worker, so the fit's bytes do not depend on P
    from test_torch_elastic_common import cls_data, dnn_fit, kill_add_hook

    x, y = cls_data(n=256, f=12)
    kw = dict(device="cuda", model_config={"features": [32, 32]}, batch_size=32)
    one, bundle = dnn_fit(str(tmp_path / "p1"), x, y, 1, **kw)
    two, _ = dnn_fit(str(tmp_path / "p2"), x, y, 2, hook=kill_add_hook(3, 6), **kw)
    assert one.step == two.step == 16
    assert one.params_digest() == two.params_digest()
    assert np.isfinite(one.params_flat()).all()
    assert bundle.variables["params"]["head"]["kernel"].shape == (32, 2)
