"""The arithmetic of K2's f32 path ("tf32x3"), emulated on the CPU.

The CUDA kernel in mmlspark_tpu_torch/csrc/flash_attn.cu runs both f32
products of the flash forward on the tensor cores as three TF32 products:
x = x_hi + x_lo with x_hi = x rounded to TF32 (10 mantissa bits, to
nearest, ties away from zero: `cvt.rna.tf32.f32`) and x_lo = the same
rounding of x - x_hi; a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, each an
exact product of TF32 values summed in f32, with the softmax in base 2
(scale * log2(e) folded into the scale). The CUDA kernel has no CPU mode,
so this file runs that arithmetic in torch, through the online-softmax
loop over the kernel's key tiles (64 keys up to D = 32, 32 above), and
holds it against the JAX package's Pallas kernel in interpret mode at the
reference's own f32 gate (atol 2e-5, rtol 1e-5; tests/test_attention.py:
48,56). One TF32 pass misses that gate, which is why the kernel takes
three. This is a model of the arithmetic, not the kernel's code: the
exponentials here are exact where the kernel's are `ex2.approx`, and the
products sum in einsum's order. tests/test_torch_gpu.py holds the kernel
itself to the same gate on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.nn import attention as jatt  # noqa: E402

ATOL, RTOL = 2e-5, 1e-5
_NEG_INF = -1e30


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 on its bit pattern: to nearest, ties away from
    zero (add half of the 13 dropped bits to the magnitude, then clear
    them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product(eq, a, b, passes):
    """einsum in 3xTF32 (small terms first) or in one TF32 pass."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def key_tile(d):
    """Keys a ring tile of the kernel's f32 path (`Tf32Tiling::kKeys`)."""
    return 32 if d >= 64 else 64


def flash_tf32x3(q, k, v, causal, passes=3):
    """The kernel's f32 path on (B, T, H, D) f32 tensors: (out, lse)."""
    b, tq, h, d = q.shape
    block_k = key_tile(d)
    tk = k.shape[1]
    scale_log2 = torch.tensor(d ** -0.5 * math.log2(math.e), dtype=torch.float32)
    qf, kf, vf = (x.permute(0, 2, 1, 3) for x in (q, k, v))     # (B, H, T, D)
    m = torch.full((b, h, tq), _NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, tq, d))
    qpos = torch.arange(tq)
    for k0 in range(0, tk, block_k):
        kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = _product("bhqd,bhkd->bhqk", qf, kb, passes)
        kpos = k0 + torch.arange(kb.shape[2])
        ok = (kpos < tk)[None, :].expand(tq, -1)
        if causal:
            ok = ok & (qpos[:, None] >= kpos[None, :])
        # masked keys stay out of the max; the running max is in base 2
        mx = torch.where(ok, s, float("-inf")).amax(-1)
        m_new = torch.maximum(m, mx * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s * scale_log2 - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _product("bhqk,bhkd->bhqd", p, vb, passes)
        m = m_new
    denom = torch.clamp(l, min=1e-30)
    out = acc * torch.where(l > 0, 1.0 / denom, 0.0)[..., None]
    lse = torch.where(l > 0, m * math.log(2.0) + torch.log(denom), float("inf"))
    return out.permute(0, 2, 1, 3), lse


def _qkv(b, tq, tk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for t in (tq, tk, tk)]


def _reference(qkv, causal, block):
    out, lse = jatt._flash_fwd_lse(*(jnp.asarray(a) for a in qkv), causal, block, block, True)
    return np.asarray(out), np.asarray(lse)


# (B, Tq, Tk, H, D): every Tk spans more than one key tile and ends in a
# ragged one
SHAPES = [(1, 40, 70, 2, 8), (2, 33, 100, 2, 16), (1, 64, 70, 2, 64), (1, 24, 45, 1, 128)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,tq,tk,h,d", SHAPES)
def test_3xtf32_flash_meets_the_reference_f32_gate(b, tq, tk, h, d, causal):
    qkv = _qkv(b, tq, tk, h, d, seed=d + causal)
    j_out, j_lse = _reference(qkv, causal, 32)
    out, lse = flash_tf32x3(*(torch.from_numpy(a) for a in qkv), causal)
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL, rtol=RTOL)
    assert np.array_equal(np.isinf(lse.numpy()), np.isinf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(lse.numpy()[fin], j_lse[fin], atol=ATOL, rtol=RTOL)


def test_3xtf32_flash_on_the_masked_construction_and_without_keys():
    # tests/test_attention.py:120-132's construction, chip_smoke's masked_f32
    qkv = _qkv(1, 4, 8, 1, 8, seed=5)
    j_out, j_lse = _reference(qkv, True, 4)
    out, lse = flash_tf32x3(*(torch.from_numpy(a) for a in qkv), True)
    np.testing.assert_allclose(out.numpy(), j_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=ATOL, rtol=RTOL)
    # no keys: every row has l == 0, so output 0 and lse +inf
    q = torch.from_numpy(qkv[0])
    empty = torch.zeros((1, 0, 1, 8))
    out, lse = flash_tf32x3(q, empty, empty, True)
    assert torch.equal(out, torch.zeros_like(q))
    assert torch.isinf(lse).all() and (lse > 0).all()


def test_tf32_rounding_is_to_nearest_ties_away_on_ten_mantissa_bits():
    one_ulp = 2.0 ** -10                      # TF32's spacing in [1, 2)
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 - 2.0 ** -23,
                      1.0 + 1.5 * one_ulp, 3.0e-3, -0.0])
    got = _tf32(x)
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + 2 * one_ulp])
    assert torch.equal(got[:4], want)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    # hi + lo keeps x to 2**-22 of its magnitude: 22 of f32's 24 bits
    x = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    hi, lo = _split(x)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    assert (err > 0).any()


def test_one_tf32_pass_misses_the_gate_at_d64():
    qkv = _qkv(1, 64, 70, 2, 64, seed=64)
    j_out, j_lse = _reference(qkv, False, 32)
    t = [torch.from_numpy(a) for a in qkv]
    out1, lse1 = flash_tf32x3(*t, False, passes=1)
    out3, lse3 = flash_tf32x3(*t, False, passes=3)
    err1 = np.abs(lse1.numpy() - j_lse).max()
    err3 = np.abs(lse3.numpy() - j_lse).max()
    assert not np.allclose(lse1.numpy(), j_lse, atol=ATOL, rtol=RTOL), err1
    assert not np.allclose(out1.numpy(), j_out, atol=ATOL, rtol=RTOL)
    # three passes land orders of magnitude closer
    assert err3 * 20 < err1, (err3, err1)
