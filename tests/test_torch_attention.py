"""The port's attention tiers against the JAX package's.

Same inputs (numpy, seeded) through mmlspark_tpu.nn.attention and
mmlspark_tpu_torch.nn.attention. The plain version of K2
(`flash_attention_torch`) is held against the Pallas kernel run in
interpret mode (`_flash_fwd_lse(..., interpret=True)`), out and lse, at the
reference's own gate between tiers (tests/test_attention.py:56).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.nn import attention as jatt  # noqa: E402
from mmlspark_tpu_torch.nn import attention as tatt  # noqa: E402

ATOL, RTOL = 2e-5, 1e-5

SHAPES = [
    # (B, Tq, Tk, H, D, causal, chunk): tests/test_attention.py:22-30
    (2, 64, 64, 4, 32, False, 16),
    (1, 50, 50, 2, 16, True, 16),
    (2, 128, 128, 4, 64, True, 128),
    (1, 7, 7, 1, 8, False, 16),
    (1, 24, 40, 2, 16, False, 16),
    (1, 40, 24, 2, 16, True, 16),
]


def _qkv(b, tq, tk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for t in (tq, tk, tk)]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("b,tq,tk,h,d,causal,chunk", SHAPES)
def test_plain_k2_matches_pallas_interpret_out_and_lse(b, tq, tk, h, d, causal, chunk):
    qkv = _qkv(b, tq, tk, h, d)
    j_out, j_lse = jatt._flash_fwd_lse(*_j(qkv), causal, chunk, chunk, True)
    t_out, t_lse = tatt.flash_attention_torch(*_t(qkv), causal, chunk, chunk)
    assert t_out.shape == (b, tq, h, d) and t_lse.shape == (b, h, tq)
    assert t_lse.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,tq,tk,h,d,causal,chunk", SHAPES)
def test_flash_wrapper_on_cpu_matches_jax_flash(b, tq, tk, h, d, causal, chunk):
    qkv = _qkv(b, tq, tk, h, d, seed=1)
    ref = jatt.flash_attention(*_j(qkv), causal=causal, block_q=chunk, block_k=chunk,
                               interpret=True)
    before = tatt.flash_attention.launches
    got = tatt.flash_attention(*_t(qkv), causal=causal, block_q=chunk, block_k=chunk)
    assert tatt.flash_attention.launches == before     # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,tq,tk,h,d,causal,chunk", SHAPES)
def test_chunked_and_dense_match_jax(b, tq, tk, h, d, causal, chunk):
    qkv = _qkv(b, tq, tk, h, d, seed=2)
    j_dense = jatt.dense_attention(*_j(qkv), causal=causal)
    j_chunk = jatt.chunked_attention(*_j(qkv), causal=causal, q_chunk=chunk, k_chunk=chunk)
    t_dense = tatt.dense_attention(*_t(qkv), causal=causal)
    t_chunk = tatt.chunked_attention(*_t(qkv), causal=causal, q_chunk=chunk, k_chunk=chunk)
    np.testing.assert_allclose(t_dense.numpy(), np.asarray(j_dense), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t_chunk.numpy(), np.asarray(j_chunk), atol=ATOL, rtol=RTOL)


def test_bf16_inputs_match_jax_bf16():
    # the same blocks on both sides, so the running max at which p is
    # rounded to bf16 is the same: the outputs may part only where the
    # f32 accumulations, summed in another order, straddle a bf16
    # rounding boundary (one bf16 ulp, 2**-8 relative at most), plus
    # outputs near 0 (atol); lse sums the unrounded p and keeps the f32 gate
    qkv = _qkv(2, 32, 32, 2, 16, seed=4)
    j_out, j_lse = jatt._flash_fwd_lse(*_j(qkv, jnp.bfloat16), False, 16, 16, True)
    t_out, t_lse = tatt.flash_attention_torch(*_t(qkv, torch.bfloat16), False, 16, 16)
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=2e-3, rtol=2.0 ** -8)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ATOL, rtol=RTOL)
    t_chunk = tatt.chunked_attention(*_t(qkv, torch.bfloat16), q_chunk=16, k_chunk=16)
    j_chunk = jatt.chunked_attention(*_j(qkv, jnp.bfloat16), q_chunk=16, k_chunk=16)
    assert t_chunk.dtype == torch.bfloat16
    np.testing.assert_allclose(t_chunk.float().numpy(), np.asarray(j_chunk, np.float32),
                               atol=2e-3, rtol=2.0 ** -8)


def test_masked_construction_and_rows_without_keys():
    # tests/test_attention.py:120-132's construction
    qkv = _qkv(1, 4, 8, 1, 8, seed=5)
    ref = jatt.dense_attention(*_j(qkv), causal=True)
    for got in (tatt.flash_attention_torch(*_t(qkv), True, 4, 4)[0],
                tatt.chunked_attention(*_t(qkv), causal=True, q_chunk=4, k_chunk=4),
                tatt.dense_attention(*_t(qkv), causal=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # with no keys every row is fully masked: l == 0 gives 0 and lse +inf
    q = torch.from_numpy(qkv[0])
    empty = torch.zeros((1, 0, 1, 8))
    out, lse = tatt.flash_attention_torch(q, empty, empty, True)
    assert torch.equal(out, torch.zeros_like(q))
    assert torch.isinf(lse).all() and (lse > 0).all()
    # a causal row whose keys all lie in the future is zero in dense
    dense = tatt.dense_attention(q, torch.from_numpy(qkv[1]), torch.from_numpy(qkv[2]),
                                 causal=True, q_offset=-3)
    assert torch.equal(dense[:, :3], torch.zeros_like(dense[:, :3]))


def test_wrapper_refusals():
    q, k, v = _t(_qkv(1, 8, 8, 2, 16))
    with pytest.raises(ValueError, match="head dim 0 is not a head dim"):
        tatt.flash_attention(*_t(_qkv(1, 8, 8, 2, 0)))
    with pytest.raises(ValueError, match="one dtype"):
        tatt.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="one dtype"):
        tatt.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        tatt.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3), k, v)
    with pytest.raises(ValueError, match="4-D"):
        tatt.flash_attention(q[0], k[0], v[0])
    # inputs that require grad run the differentiable K2 (FlashAttention),
    # and its refusals hold there too
    assert tatt.flash_attention(q.requires_grad_(), k, v).requires_grad
    with pytest.raises(ValueError, match="one dtype"):
        tatt.flash_attention(q, k.to(torch.bfloat16), v)
    with torch.no_grad():           # forward-only use of the same tensor is fine
        assert not tatt.flash_attention(q, k, v).requires_grad
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.SelfAttention(8, 2, impl="nope")


def test_self_attention_flash_on_cpu_is_the_plain_k2_not_chunked(monkeypatch):
    mod = tatt.SelfAttention(16, 2, impl="flash")
    calls = []
    real = tatt.flash_attention_torch
    monkeypatch.setattr(tatt, "flash_attention_torch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tatt, "chunked_attention",
                        lambda *a, **k: pytest.fail("flash must not turn into chunked"))
    with torch.no_grad():
        out = mod(torch.zeros((1, 5, 16)))
    assert out.shape == (1, 5, 16) and calls == [1]
