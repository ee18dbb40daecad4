"""K2 made differentiable: the port's `flash_attention` gradients against the
JAX package's.

The JAX package differentiates its flash attention through a custom VJP:
the Pallas forward (run here in interpret mode) and `_flash_bwd_xla`, the
flash recomputation over key chunks. The port's `FlashAttention` runs K2's
plain version on a CPU tensor and `flash_attention_bwd_torch`, the port of
that backward. Gate: atol 5e-5, rtol 1e-4, the reference's own gate for
flash gradients (tests/test_attention.py:86-88).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.nn import attention as jatt  # noqa: E402
from mmlspark_tpu_torch.nn import attention as tatt  # noqa: E402

ATOL, RTOL = 5e-5, 1e-4

CASES = [
    # (B, Tq, Tk, H, D, causal, block, seed): tests/test_attention.py:73-104
    (1, 48, 48, 2, 16, False, 16, 6),
    (1, 48, 48, 2, 16, True, 16, 6),
    (2, 13, 19, 2, 8, True, 8, 7),        # ragged Tq/Tk, causally masked rows
    # tests/test_attention.py:22-30's shapes
    (1, 50, 50, 2, 16, True, 16, 0),
    (1, 24, 40, 2, 16, False, 16, 0),
    (1, 40, 24, 2, 16, True, 16, 0),
]


def _qkv(b, tq, tk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for t in (tq, tk, tk)]


def _jax_grads(arrays, causal, block):
    def loss(q, k, v):
        return (jatt.flash_attention(q, k, v, causal=causal, block_q=block, block_k=block,
                                     interpret=True) ** 2).sum()

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))]


def _port_grads(arrays, causal, block, dtype=torch.float32):
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays)
    out = tatt.flash_attention(q, k, v, causal=causal, block_q=block, block_k=block)
    (out.float() ** 2).sum().backward()
    return out, [t.grad for t in (q, k, v)]


@pytest.mark.parametrize("b,tq,tk,h,d,causal,block,seed", CASES)
def test_flash_gradients_match_jax(b, tq, tk, h, d, causal, block, seed):
    arrays = _qkv(b, tq, tk, h, d, seed)
    want = _jax_grads(arrays, causal, block)
    _, got = _port_grads(arrays, causal, block)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_ported_backward_matches_flash_bwd_xla_on_the_same_residuals(causal):
    """flash_attention_bwd_torch against _flash_bwd_xla given the Pallas
    forward's own out and lse and one upstream gradient."""
    q, k, v = _qkv(2, 21, 37, 2, 8, seed=3)
    do = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out, lse = jatt._flash_fwd_lse(jq, jk, jv, causal, 8, 8, True)
    want = jatt._flash_bwd_xla(jq, jk, jv, out, lse, jdo, causal, 8)
    got = tatt.flash_attention_bwd_torch(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, do)), causal, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_flash_gradients_match_dense_attention():
    """The port's flash gradients against its own dense tier's autograd."""
    arrays = _qkv(2, 33, 33, 2, 16, seed=9)
    _, got = _port_grads(arrays, True, 16)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    (tatt.dense_attention(q, k, v, causal=True) ** 2).sum().backward()
    for g, w in zip(got, (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=RTOL)


def test_bf16_gradients_keep_their_dtype_and_agree():
    """bf16 inputs: gradients come back in bf16 (the JAX backward casts to
    each input's dtype) and agree with the f32 gradients at the reference's
    bf16 gate between tiers, 3e-2 (tests/test_attention.py:117)."""
    arrays = _qkv(2, 32, 32, 2, 16, seed=4)
    out, got = _port_grads(arrays, False, 16, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = _jax_grads([a.astype(jnp.bfloat16).astype(np.float32) for a in arrays], False, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), w, atol=3e-2, rtol=3e-2)


def test_no_keys_give_zero_output_and_zero_gradients():
    """Tk = 0: lse is +inf on every row, so the output and dq are zeros and
    dk, dv are empty."""
    q = torch.randn(1, 5, 2, 8, requires_grad=True)
    k = torch.zeros(1, 0, 2, 8, requires_grad=True)
    v = torch.zeros(1, 0, 2, 8, requires_grad=True)
    out = tatt.flash_attention(q, k, v)
    assert torch.equal(out, torch.zeros_like(out))
    (out ** 2).sum().backward()
    assert torch.equal(q.grad, torch.zeros_like(q))
    assert k.grad.shape == (1, 0, 2, 8) and v.grad.shape == (1, 0, 2, 8)


def test_inputs_without_grad_skip_the_autograd_function():
    """Serving (no grad) calls the forward alone: nothing is saved."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 1, 8, 0))
    with torch.no_grad():
        out = tatt.flash_attention(q.requires_grad_(True), k, v)
    assert out.grad_fn is None
    out = tatt.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
