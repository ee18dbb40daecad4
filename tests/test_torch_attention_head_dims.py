"""K2 at head dims between the ones its CUDA kernel is built for.

The reference's `_flash_fwd_lse` takes any D, its block spanning the whole
head dim; so does the port's wrapper (on a card, a D up to 128 zero-padded
to the next built D at the true D's scale; above 128 see
test_torch_attention_wide.py). On the CPU the wrapper runs the
plain version at the true D: here it is held against the Pallas kernel in
interpret mode, out and lse, at test_torch_attention.py's gates, and a
TransformerEncoder of d_model 96 and 4 heads (D = 24) against the
reference's, weights carried by nn/carry.py. Head dims above 128:
test_torch_attention_wide.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.nn import attention as jatt  # noqa: E402
from mmlspark_tpu.nn.models import ModelBundle as JaxBundle  # noqa: E402
from mmlspark_tpu_torch.nn import attention as tatt  # noqa: E402
from mmlspark_tpu_torch.nn import models as tm  # noqa: E402

# test_torch_attention.py's gates: f32 the reference's between tiers
# (tests/test_attention.py:56); bf16 out one bf16 ulp (2**-8 relative) plus
# 2e-3 near 0, both sides taking the same key blocks, lse the f32 gate
ATOL, RTOL = 2e-5, 1e-5
BF16_ATOL, BF16_RTOL = 2e-3, 2.0 ** -8
BLOCK = 16


def _qkv(b, tq, tk, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for t in (tq, tk, tk)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [24, 40, 96])
def test_k2_matches_pallas_interpret_between_built_head_dims(d, dtype, causal):
    qkv = _qkv(2, 40, 40, 2, d, seed=d)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    j_out, j_lse = jatt._flash_fwd_lse(*(jnp.asarray(a, jdt) for a in qkv), causal,
                                       BLOCK, BLOCK, True)
    t = [torch.from_numpy(a).to(tdt) for a in qkv]
    before = tatt.flash_attention.launches
    t_out, t_lse = tatt._flash_fwd_lse(*t, causal, BLOCK, BLOCK)
    t_flash = tatt.flash_attention(*t, causal, BLOCK, BLOCK)
    assert tatt.flash_attention.launches == before          # the CPU runs no kernel
    assert t_out.shape == (2, 40, 2, d) and t_out.dtype == tdt
    assert torch.equal(t_flash, t_out)
    atol, rtol = (ATOL, RTOL) if dtype == "float32" else (BF16_ATOL, BF16_RTOL)
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("d", [0])
def test_head_dims_outside_1_to_128_raise_naming_the_roadmap_item(d):
    # every D >= 1 serves; only an empty head dim is refused
    q = torch.zeros((1, 8, 2, d))
    with pytest.raises(ValueError, match=f"head dim {d} is not a head dim"):
        tatt.flash_attention(q, q, q)


def test_d96_encoder_with_flash_attention_matches_jax():
    # the example of the fault: d_model 96 over 4 heads, D = 24. Gate as
    # test_torch_nn_models.py's: the reference's between attention impls
    # at module level (tests/test_attention.py:159)
    kw = dict(num_layers=2, d_model=96, num_heads=4, d_ff=128, vocab_size=50, num_outputs=3)
    x = np.arange(36).reshape(3, 12) % 50
    jb = JaxBundle.init("transformer", (12,), seed=0, attention_impl="flash", **kw)
    ref = np.asarray(jax.jit(jb.module.apply)(jb.variables, jnp.asarray(x)))
    port = tm.ModelBundle(architecture=jb.architecture, config=dict(jb.config),
                          variables=jax.tree.map(np.asarray, jb.variables),
                          input_shape=jb.input_shape)
    with torch.no_grad():
        got = port.module(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)
