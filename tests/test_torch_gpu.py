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


def test_cuda_kernel_matches_plain_version_and_repeats_its_bits(cuda):
    rng = np.random.default_rng(4)
    bins = rng.integers(0, 256, size=(32768, 14)).astype(np.int32)
    stats = torch.from_numpy(rng.normal(size=(32768, 3)).astype(np.float32)).to(cuda)
    for dtype in (np.int32, np.uint8):
        tb = torch.from_numpy(bins.astype(dtype)).to(cuda)
        before = hk.histogram.launches
        a = hk.histogram(tb, stats, 256)
        b = hk.histogram(tb, stats, 256)
        assert hk.histogram.launches == before + 2
        # rtol = atol = 1e-5 as between the JAX variants: the plain version
        # adds with atomics in no fixed order
        torch.testing.assert_close(a, hk.histogram_torch(tb, stats, 256),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(a, b)


def test_wrapper_raises_on_a_cuda_tensor_it_cannot_take(cuda):
    tb = torch.zeros((64, 4), dtype=torch.int32, device=cuda)
    ts = torch.zeros((64, 3), dtype=torch.float32, device=cuda)
    before = hk.histogram.launches
    with pytest.raises(ValueError, match="num_bins"):
        hk.histogram(tb, ts, 300)
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


# K2 against its plain version, with chip_smoke.py's gates: f32 the
# reference's (tests/test_attention.py:56); bf16 two ulps of the output
# (rtol 2**-7) plus 2e-3 for outputs near 0, since p is rounded to bf16 at
# running maxima that differ between the kernel's and the plain version's
# key blocks
_F32_TOL, _BF16_TOL = (2e-5, 1e-5), (2e-3, 2.0 ** -7)


def _k2_path(dtype, d):
    """The kernel a (dtype, head dim) must take."""
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if d in (64, 128) else "mma"


# every head dim K2 is built for, so each of its instantiations runs; Tk
# 137 is ragged against every key tile, so a fragment element taken from
# the wrong lane shows as a wrong row. The mma path (bf16, D 8/16/32) takes
# 2-warp blocks at B 2 (16 blocks) and 8-warp blocks at B 16, Tq 300 (192
# blocks of 128 rows, the last one ragged, on the H100's 132 SMs)
@pytest.mark.parametrize("dtype,d,causal,tol,b,tq", [
    *[(torch.float32, d, causal, _F32_TOL, 2, 200) for d in (64, 8, 16, 32, 128)
      for causal in (False, True)],
    *[(torch.bfloat16, d, causal, _BF16_TOL, 2, 200) for d in (8, 16, 32, 64, 128)
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
    q = torch.zeros((1, 8, 2, 12), device=cuda)
    before = att.flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
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
