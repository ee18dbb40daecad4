"""Train mode in the port (nn/layers.py `TrainMode`, nn/models.py
`train_forward`) against flax's `train=True`.

- BatchNorm: flax 0.12.3's `BatchNorm(use_running_average=False)` output,
  new running statistics and input gradient, f32 and bf16.
- Attention dropout: the keys flax's `make_rng("dropout")` derives and the
  masks `dot_product_attention_weights` draws, bit for bit, and the dense
  transformer's train-mode logits with dropout against
  `apply(train=True, rngs={"dropout": key})`.
- ResNet's train-mode logits and new `batch_stats` against
  `apply(train=True, mutable=["batch_stats"])`.
- remat: gradients and statistics equal to those without it, bit for bit.

Gate: atol 5e-5, rtol 1e-4 in f32 (tests/test_attention.py:159); bf16
outputs at the bf16 gate 3e-2 (tests/test_attention.py:117).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.nn.models import ModelBundle as JaxBundle  # noqa: E402
from mmlspark_tpu_torch.core import prng  # noqa: E402
from mmlspark_tpu_torch.nn import models as tm  # noqa: E402
from mmlspark_tpu_torch.nn.layers import BatchNorm, TrainMode  # noqa: E402

ATOL, RTOL = 5e-5, 1e-4


def _init(arch, shape, seed, **config):
    """JaxBundle.init with one jitted flax init (eager init compiles op by op)."""
    jb = JaxBundle(architecture=arch, config=config, variables={}, input_shape=tuple(shape))
    jb.variables = jax.jit(jb.module.init)(jax.random.PRNGKey(seed),
                                           jnp.zeros((1, *shape), jnp.float32))
    return jb


def _key(seed: int):
    """A "dropout" step key as both packages hold it."""
    k = prng.fold_in(prng.prng_key(seed), 3)
    return k, jnp.asarray(np.array(k, dtype=np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 5, 5, 6)) * 2 + 1).astype(np.float32)
    scale = (rng.random(6) + 0.5).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    mean0 = rng.normal(scale=0.1, size=6).astype(np.float32)
    var0 = (rng.random(6) + 0.5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    bn = fnn.BatchNorm(use_running_average=False, dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    xin = jnp.asarray(x).astype(jdt)
    want, upd = bn.apply(variables, xin, mutable=["batch_stats"])
    want_dx = jax.grad(lambda a: (bn.apply(variables, a, mutable=["batch_stats"])[0]
                                  .astype(jnp.float32) ** 2).sum())(jnp.asarray(x))

    tdt = getattr(torch, dtype)
    layer = BatchNorm(6, tdt)
    layer.load_flax_leaves({("params", "scale"): scale, ("params", "bias"): bias,
                            ("batch_stats", "mean"): mean0, ("batch_stats", "var"): var0})
    xt = torch.from_numpy(x).requires_grad_(True)
    with TrainMode(layer, None) as mode:
        got = layer(xt.to(tdt))
    (got.float() ** 2).sum().backward()
    assert got.dtype == tdt
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)
    mean, var = mode.stats[layer]
    np.testing.assert_allclose(mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               atol=ATOL, rtol=RTOL)
    if dtype == "float32":
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=ATOL, rtol=RTOL)
    # train mode leaves the buffers alone; the trainer installs the stats
    assert np.array_equal(layer.running_mean.numpy(), mean0)


class _DropoutKey(fnn.Module):
    @fnn.compact
    def __call__(self, shape, rate):
        return jax.random.bernoulli(self.make_rng("dropout"), 1.0 - rate, shape)


class _Root(fnn.Module):
    @fnn.compact
    def __call__(self, shape, rate):
        return [_DropoutKey(name=f"attn_{i}")(shape, rate) for i in range(3)]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_masks_equal_flax_bit_for_bit(rate):
    """The mask of module attn_i of a root module: flax's make_rng("dropout")
    then bernoulli(1 - rate), against TrainMode.make_rng then uniform."""
    key, jkey = _key(11)
    shape = (1, 1, 17, 23)
    want = _Root().apply({}, shape, rate, rngs={"dropout": jkey})
    model = tm.make_model("transformer", (17,), num_layers=3, d_model=8, num_heads=2, d_ff=8,
                          vocab_size=10, dropout_rate=rate)
    mode = TrainMode(model, key)
    for i, w in enumerate(want):
        u = prng.uniform(mode.make_rng(getattr(model, f"attn_{i}")), shape, "cpu")
        got = u < torch.tensor(1.0 - rate, dtype=torch.float32)
        assert np.array_equal(got.numpy(), np.asarray(w)), f"attn_{i}"
        assert 0 < got.float().mean() < 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_transformer_train_mode_with_dropout_matches_flax(dtype):
    kw = dict(num_layers=2, d_model=16, num_heads=2, d_ff=32, vocab_size=30, num_outputs=3,
              dropout_rate=0.3, dtype=dtype)
    jb = _init("transformer", (12,), 2, **kw)
    x = np.random.default_rng(3).integers(0, 30, size=(4, 12))
    key, jkey = _key(5)
    want = jax.jit(lambda v, a, k: jb.module.apply(v, a, train=True, rngs={"dropout": k}))(
        jb.variables, jnp.asarray(x), jkey)
    port = tm.ModelBundle(architecture="transformer", config=dict(kw),
                          variables=jax.tree.map(np.asarray, jb.variables),
                          input_shape=(12,)).module
    got, stats = tm.train_forward(port, torch.from_numpy(x), key)
    assert stats == {}
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    # eval mode (no TrainMode) draws no dropout: the flax eval forward
    with torch.no_grad():
        ev = port(torch.from_numpy(x))
    np.testing.assert_allclose(ev.numpy(), np.asarray(jax.jit(jb.module.apply)(
        jb.variables, jnp.asarray(x))), **tol)
    assert not np.allclose(ev.numpy(), got.detach().numpy(), atol=1e-3)


def test_resnet_train_mode_matches_flax():
    jb = _init("resnet", (8, 8, 3), 1, stage_sizes=(1, 1), num_filters=4, num_outputs=3)
    x = np.random.default_rng(4).normal(size=(6, 8, 8, 3)).astype(np.float32)
    want, upd = jax.jit(lambda v, a: jb.module.apply(v, a, train=True, mutable=["batch_stats"]))(
        jb.variables, jnp.asarray(x))
    port = tm.ModelBundle(architecture="resnet", config=dict(stage_sizes=(1, 1), num_filters=4,
                                                              num_outputs=3),
                          variables=jax.tree.map(np.asarray, jb.variables),
                          input_shape=(8, 8, 3)).module
    got, stats = tm.train_forward(port, torch.from_numpy(x), None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    names = {m: n for n, m in port.named_modules()}
    assert len(stats) == sum(isinstance(m, BatchNorm) for m in port.modules())
    for bn, (mean, var) in stats.items():
        node = upd["batch_stats"]
        for part in names[bn].split("."):
            node = node[part]
        np.testing.assert_allclose(mean.numpy(), np.asarray(node["mean"]), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(var.numpy(), np.asarray(node["var"]), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch,shape,config,x", [
    ("resnet", (8, 8, 3), dict(stage_sizes=(1, 1), num_filters=4, num_outputs=3),
     np.random.default_rng(5).normal(size=(4, 8, 8, 3)).astype(np.float32)),
    ("transformer", (10,), dict(num_layers=2, d_model=16, num_heads=2, d_ff=32, vocab_size=30,
                                dropout_rate=0.2),
     np.random.default_rng(6).integers(0, 30, size=(4, 10))),
    ("transformer", (10, 3), dict(num_layers=2, d_model=16, num_heads=2, d_ff=32,
                                  attention_impl="flash"),
     np.random.default_rng(7).normal(size=(4, 10, 3)).astype(np.float32)),
], ids=["resnet_bn", "dense_dropout", "flash"])
def test_remat_gradients_equal_those_without(arch, shape, config, x):
    model = tm.ModelBundle.init(arch, shape, seed=3, **config).module
    key = prng.fold_in(prng.prng_key(1), 0)

    def grads(remat):
        model.zero_grad()
        out, stats = tm.train_forward(model, torch.from_numpy(x), key, remat=remat)
        (out ** 2).sum().backward()
        return ([p.grad.clone() for p in model.parameters()],
                {n: tuple(s) for n, s in ((m, stats[m]) for m in stats)})

    g0, s0 = grads(False)
    g1, s1 = grads(True)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert s0.keys() == s1.keys()
    assert all(torch.equal(a, b) for m in s0 for a, b in zip(s0[m], s1[m]))
