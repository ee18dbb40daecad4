"""K2 at head dims above 128, on the CPU.

The reference's `_flash_fwd_lse` takes any D; on a card the port runs a D
above 128 on its "wgmma" kernel at 192 or 256 (bf16 up to 256) or on its
"wide" kernel (f32, and bf16 above 256), reading the true D (a pad copy
only where rows are not 16 bytes, as at 129) at the true D's scale. On the
CPU the wrapper runs the plain version at the true D: here it is held
against the Pallas kernel in interpret mode, out and lse, at
test_torch_attention.py's gates, at D the card pads (129), reads through
zeros past D (160, 200) and takes as they are (192, 256, and 320, beyond
the wgmma kernel in both dtypes); and a TransformerEncoder
of d_model 768 over 4 heads (D = 192: the importers' default of 4 heads,
mmlspark_tpu/nn/import_weights.py:436, at BERT-base width) against the
reference's, weights carried by nn/carry.py.
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

# test_torch_attention.py's gates (see test_torch_attention_head_dims.py)
ATOL, RTOL = 2e-5, 1e-5
BF16_ATOL, BF16_RTOL = 2e-3, 2.0 ** -8
BLOCK = 16


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [129, 160, 192, 200, 256, 320])
def test_k2_matches_pallas_interpret_above_128(d, dtype, causal):
    rng = np.random.default_rng(d)
    qkv = [rng.normal(size=(2, t, 2, d)).astype(np.float32) for t in (40, 40, 40)]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    j_out, j_lse = jatt._flash_fwd_lse(*(jnp.asarray(a, jdt) for a in qkv), causal,
                                       BLOCK, BLOCK, True)
    t = [torch.from_numpy(a).to(tdt) for a in qkv]
    before = tatt.flash_attention.launches
    t_out, t_lse = tatt._flash_fwd_lse(*t, causal, BLOCK, BLOCK)
    assert tatt.flash_attention.launches == before          # the CPU runs no kernel
    assert t_out.shape == (2, 40, 2, d) and t_out.dtype == tdt
    assert torch.equal(tatt.flash_attention(*t, causal, BLOCK, BLOCK), t_out)
    atol, rtol = (ATOL, RTOL) if dtype == "float32" else (BF16_ATOL, BF16_RTOL)
    np.testing.assert_allclose(t_out.float().numpy(), np.asarray(j_out, np.float32),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), atol=ATOL, rtol=RTOL)


def test_d768_encoder_with_flash_attention_matches_jax():
    # 4 heads of 192. Gate as test_torch_nn_models.py's: the reference's
    # between attention impls at module level (tests/test_attention.py:159)
    kw = dict(num_layers=2, d_model=768, num_heads=4, d_ff=256, vocab_size=50, num_outputs=3)
    x = np.arange(36).reshape(3, 12) % 50
    jb = JaxBundle.init("transformer", (12,), seed=0, attention_impl="flash", **kw)
    ref = np.asarray(jax.jit(jb.module.apply)(jb.variables, jnp.asarray(x)))
    port = tm.ModelBundle(architecture=jb.architecture, config=dict(jb.config),
                          variables=jax.tree.map(np.asarray, jb.variables),
                          input_shape=jb.input_shape)
    with torch.no_grad():
        got = port.module(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)
