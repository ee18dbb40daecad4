"""The port's architectures against the JAX package's.

Each JAX model is initialised by flax; its variables are carried into the
port's module by nn/carry.py, and the same numpy inputs go through both.
Gate: atol 5e-5, rtol 1e-4, the reference's own gate between attention
impls at the module level (tests/test_attention.py:159). The JAX
transformer with attention_impl="flash" runs its chunked tier on the CPU;
the port's runs the plain version of K2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.nn.models import ModelBundle as JaxBundle  # noqa: E402
from mmlspark_tpu_torch.nn import models as tm  # noqa: E402
from mmlspark_tpu_torch.nn.carry import load_variables, module_variables  # noqa: E402
from mmlspark_tpu_torch.nn.layers import Embed  # noqa: E402

ATOL, RTOL = 5e-5, 1e-4
KW = dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=50, num_outputs=3)
STEM_KW = dict(KW, vocab_size=0)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jb):
    return tm.ModelBundle(architecture=jb.architecture, config=dict(jb.config),
                          variables=_numpy_tree(jb.variables),
                          input_shape=jb.input_shape)


def _both(jb, x):
    ref = np.asarray(jax.jit(jb.module.apply)(jb.variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(jb).module(torch.from_numpy(np.asarray(x))).float().numpy()
    return ref, got


@pytest.mark.parametrize("impl", ["dense", "chunked", "flash"])
@pytest.mark.parametrize("tokens", [True, False], ids=["tokens", "stem"])
def test_transformer_matches_jax(impl, tokens):
    if tokens:
        x = np.arange(30).reshape(3, 10) % 50
        jb = JaxBundle.init("transformer", (10,), seed=0, attention_impl=impl, **KW)
    else:
        x = np.random.default_rng(1).normal(size=(3, 10, 5)).astype(np.float32)
        jb = JaxBundle.init("transformer", (10, 5), seed=0, attention_impl=impl, **STEM_KW)
    ref, got = _both(jb, x)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_bf16_transformer_matches_jax(impl):
    # bf16 activations: XLA's CPU and torch round elementwise bf16 ops at
    # different points (XLA may keep a fused chain in f32), so two layers
    # of bf16 rounding (2**-8 relative each) part the logits by up to
    # about a percent: the reference's own bf16 gate between tiers,
    # atol = rtol = 3e-2 (tests/test_attention.py:117)
    x = np.arange(40).reshape(4, 10) % 50
    jb = JaxBundle.init("transformer", (10,), seed=3, attention_impl=impl,
                   dtype="bfloat16", **KW)
    ref, got = _both(jb, x)
    assert got.dtype == np.float32          # the head is float32 (models.py:244)
    np.testing.assert_allclose(got, ref, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("arch,shape,config", [
    ("mlp", (5,), {}),
    ("mlp", (4, 3), {"features": (16, 8, 4), "num_outputs": 3}),
])
def test_mlp_matches_jax(arch, shape, config):
    jb = JaxBundle.init(arch, shape, seed=1, **config)
    x = np.random.default_rng(2).normal(size=(3, *shape)).astype(np.float32)
    ref, got = _both(jb, x)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


# the convolutional architectures: tests/test_torch_nn_cnn.py
@pytest.mark.parametrize("arch,shape,config", [
    ("mlp", (5,), {}),
    ("transformer", (10,), KW),
    ("transformer", (10, 5), dict(STEM_KW, attention_impl="flash")),
])
def test_param_tree_and_layer_names_match_jax_init(arch, shape, config):
    jb = JaxBundle.init(arch, shape, seed=0, **config)
    port = tm.ModelBundle.init(arch, shape, seed=0, **config)
    want = jax.tree.map(lambda a: tuple(a.shape), jb.variables)
    got = jax.tree.map(lambda a: tuple(a.shape), port.variables)
    assert got == want
    assert port.layer_names() == jb.layer_names()


def test_init_is_seeded():
    a = tm.ModelBundle.init("transformer", (10,), seed=4, **KW)
    b = tm.ModelBundle.init("transformer", (10,), seed=4, **KW)
    c = tm.ModelBundle.init("transformer", (10,), seed=5, **KW)
    same = jax.tree.map(np.array_equal, a.variables, b.variables)
    assert all(jax.tree.leaves(same))
    assert not np.array_equal(a.variables["params"]["embed"]["embedding"],
                              c.variables["params"]["embed"]["embedding"])


def test_module_errors_match_jax():
    m = tm.make_model("transformer", (20,), max_len=8, **KW)
    with pytest.raises(ValueError, match="max_len"), torch.no_grad():
        m(torch.zeros((1, 20), dtype=torch.int64))
    with pytest.raises(ValueError, match="dropout"):
        tm.make_model("transformer", (4,), attention_impl="chunked",
                      dropout_rate=0.1, **KW)
    with pytest.raises(ValueError, match="unknown architecture"):
        tm.make_model("nope", (4,))


def test_carry_validates_leaf_for_leaf():
    jb = JaxBundle.init("mlp", (5,), seed=0)
    variables = _numpy_tree(jb.variables)
    module = tm.make_model("mlp", (5,))
    load_variables(module, variables)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, module_variables(module),
                                            variables)))
    bad = _numpy_tree(jb.variables)
    bad["params"]["head"]["kernel"] = np.zeros((64, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch.*head/kernel"):
        load_variables(tm.make_model("mlp", (5,)), bad)
    missing = _numpy_tree(jb.variables)
    del missing["params"]["dense_1"]
    missing["params"]["extra"] = {"kernel": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="missing.*dense_1.*unexpected.*extra"):
        load_variables(tm.make_model("mlp", (5,)), missing)


def test_embed_takes_like_jnp_take_fill():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    emb = Embed(4, 3)
    emb.weight.data = torch.from_numpy(table)
    ids = np.array([[-1, 3, 4, -5, 0]])
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    with torch.no_grad():
        got = emb(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
