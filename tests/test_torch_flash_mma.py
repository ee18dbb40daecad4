"""The arithmetic of K2's bf16 path at small head dims ("mma"), emulated on
the CPU.

The CUDA kernel in mmlspark_tpu_torch/csrc/flash_attn.cu (flash_fwd_mma_kernel)
runs bf16 attention with head dim 8, 16 or 32 on the tensor cores: scores
are sums in f32 of exact products of bf16 values (mma.sync, bf16 in, f32
accumulate), walked over key tiles of 128 with the online softmax in base
2 (scale * log2(e) folded into the scale); p is rounded to bf16 at the
kernel's running max before the PV product, while l sums the unrounded
f32 p; lse = m ln 2 + ln l. The CUDA kernel has no CPU mode, so this file
runs that arithmetic in torch and holds it against the JAX package's
Pallas kernel in interpret mode at chip_smoke.py's bf16 gate: out within
atol 2e-3, rtol 2**-7 (two bf16 ulps, as p is rounded at running maxima
that differ between the two key walks), lse within the f32 gate 2e-5 /
1e-5. This is a model of the arithmetic, not the kernel's code: the
exponentials here are exact where the kernel's are `ex2.approx`, the score
is scaled and shifted in two roundings where the kernel takes one fma, and
the products sum in einsum's order. tests/test_torch_gpu.py holds the
kernel itself to the same gate on the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.nn import attention as jatt  # noqa: E402

ATOL, RTOL = 2e-3, 2.0 ** -7          # chip_smoke.FLASH_TOL[bfloat16]
LSE_ATOL, LSE_RTOL = 2e-5, 1e-5
_NEG_INF = -1e30
KEY_TILE = 128                        # MmaTiling::kKeys


def flash_mma(q, k, v, causal):
    """The kernel's bf16 path on (B, T, H, D) bf16 tensors: (out bf16, lse)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale_log2 = torch.tensor(d ** -0.5 * math.log2(math.e), dtype=torch.float32)
    # bf16 values widened to f32: their products are exact there
    qf, kf, vf = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))     # (B, H, T, D)
    m = torch.full((b, h, tq), _NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, tq, d))
    qpos = torch.arange(tq)
    for k0 in range(0, tk, KEY_TILE):
        kb, vb = kf[:, :, k0:k0 + KEY_TILE], vf[:, :, k0:k0 + KEY_TILE]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
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
        # the PV product sees p rounded to bf16 (the TPU kernel's cast of p
        # to v's dtype), summed in f32
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    denom = torch.clamp(l, min=1e-30)
    out = acc * torch.where(l > 0, 1.0 / denom, 0.0)[..., None]
    lse = torch.where(l > 0, m * math.log(2.0) + torch.log(denom), float("inf"))
    return out.to(torch.bfloat16).permute(0, 2, 1, 3), lse


def _qkv(b, tq, tk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for t in (tq, tk, tk)]


def _reference(qkv, causal, block):
    """The Pallas kernel in interpret mode on the bf16 inputs."""
    out, lse = jatt._flash_fwd_lse(*(jnp.asarray(a, dtype=jnp.bfloat16) for a in qkv), causal,
                                   block, block, True)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _check(qkv, causal, block):
    j_out, j_lse = _reference(qkv, causal, block)
    out, lse = flash_mma(*(torch.from_numpy(a).to(torch.bfloat16) for a in qkv), causal)
    np.testing.assert_allclose(out.float().numpy(), j_out, atol=ATOL, rtol=RTOL)
    assert np.array_equal(np.isinf(lse.numpy()), np.isinf(j_lse))
    fin = np.isfinite(j_lse)
    np.testing.assert_allclose(lse.numpy()[fin], j_lse[fin], atol=LSE_ATOL, rtol=LSE_RTOL)


# Tk 137 is ragged against the kernel's 128-key tile; the reference walks
# 64-key blocks, so the two round p at different running maxima
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 16, 32])
def test_mma_path_meets_the_bf16_gate_against_the_pallas_kernel(d, causal):
    _check(_qkv(2, 137, 137, 2, d, seed=d + causal), causal, 64)


@pytest.mark.parametrize("d", [8, 16, 32])
def test_mma_path_across_three_key_tiles_with_more_keys_than_queries(d):
    _check(_qkv(1, 40, 300, 2, d, seed=3), False, 64)


def test_mma_path_on_the_masked_construction_and_without_keys():
    # tests/test_attention.py:120-132's construction, in bf16
    _check(_qkv(1, 4, 8, 1, 8, seed=5), True, 4)
    # causal with Tq > Tk: the rows past Tk see every key
    _check(_qkv(1, 20, 12, 1, 8, seed=6), True, 4)
    # no keys: every row has l == 0, so output 0 and lse +inf
    q = torch.from_numpy(_qkv(1, 4, 8, 1, 8, seed=5)[0]).to(torch.bfloat16)
    empty = torch.zeros((1, 0, 1, 8), dtype=torch.bfloat16)
    out, lse = flash_mma(q, empty, empty, True)
    assert torch.equal(out.float(), torch.zeros_like(q.float()))
    assert torch.isinf(lse).all() and (lse > 0).all()

