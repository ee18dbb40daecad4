"""The port's convolutional architectures against the JAX package's.

SimpleCNN, resnet20_cifar and resnet50 (NHWC at the API, OIHW inside):
the flax variables are carried into the port's module by nn/carry.py,
which checks the tree leaf for leaf, and the same numpy images go through
both at atol 5e-5, rtol 1e-4 (tests/test_attention.py:159). TF32 is off
in the port, so its f32 convolutions are full f32 as XLA's CPU ones are.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.nn.models import ModelBundle as JaxBundle  # noqa: E402
from mmlspark_tpu_torch.nn import models as tm  # noqa: E402

ATOL, RTOL = 5e-5, 1e-4


def _init(arch, shape, seed, jit, **config):
    if not jit:
        return JaxBundle.init(arch, shape, seed=seed, **config)
    # a resnet50's eager flax init compiles op by op; one jitted init is
    # quicker
    jb = JaxBundle(architecture=arch, config=config, variables={},
                   input_shape=tuple(shape))
    jb.variables = jax.jit(jb.module.init)(jax.random.PRNGKey(seed),
                                           jnp.zeros((1, *shape), jnp.float32))
    return jb


def _trained_looking(variables, rng):
    """BN scales and variances in [0.5, ...), means ~N(0, 0.1): the init's
    ones and zeros would leave the normalisation untested."""
    def draw(path, a):
        name = str(path[-1])
        if "var" in name or "scale" in name:
            return (np.abs(rng.normal(size=a.shape)) + 0.5).astype(a.dtype)
        if "mean" in name:
            return rng.normal(scale=0.1, size=a.shape).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.mark.parametrize("arch,shape,config,jit", [
    ("simple_cnn", (8, 8, 1), {}, False),
    ("resnet20_cifar", (8, 8, 3), {}, False),
    ("resnet50", (16, 16, 3), {"num_outputs": 7}, True),
])
def test_cnn_matches_jax(arch, shape, config, jit):
    jb = _init(arch, shape, 1, jit, **config)
    rng = np.random.default_rng(2)
    variables = _trained_looking(jax.tree.map(np.asarray, jb.variables), rng)
    x = rng.normal(size=(3, *shape)).astype(np.float32)
    ref = np.asarray(jax.jit(jb.module.apply)(variables, jnp.asarray(x)))
    port = tm.ModelBundle(architecture=arch, config=dict(config), variables=variables,
                          input_shape=tuple(shape))
    with torch.no_grad():
        got = port.module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


# resnet50's tree is held against flax's by the carry's leaf-for-leaf
# check above
@pytest.mark.parametrize("arch,shape", [("simple_cnn", (8, 8, 1)),
                                        ("resnet20_cifar", (8, 8, 3))])
def test_param_tree_and_layer_names_match_jax_init(arch, shape):
    jb = JaxBundle.init(arch, shape, seed=0)
    port = tm.ModelBundle.init(arch, shape, seed=0)
    want = jax.tree.map(lambda a: tuple(a.shape), jb.variables)
    assert jax.tree.map(lambda a: tuple(a.shape), port.variables) == want
    assert port.layer_names() == jb.layer_names()
