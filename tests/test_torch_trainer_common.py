"""Shared parts of the port's DNNLearner tests (tests/test_torch_trainer*.py):
tables, the JAX package's init carried into the port, one fit in each
package, and the comparison of two fits.

The port's DNNLearner against the JAX package's.

The reference's TestDNNLearner cases (tests/test_nn.py:168-330, :396-410):
each keeps its own assertion (accuracy, frozen leaves, ...) and is also
held against the JAX DNNLearner fitted from one carried-over `init_bundle`
(the JAX package's flax init, its variables carried into the port), with
the same table, seed, batches and step keys.

Gate between the packages: rtol 2e-4, atol 2e-5, the reference's own gate
between a data-parallel and a one-device DNN fit (tests/test_parallel.py:345),
on the logits of the table element for element, and on every parameter
leaf relative to the leaf's largest magnitude (|got - want| <= 2e-4 *
max|want| + 2e-5): Adam divides by the root of the second moment, so an
element whose gradient is near zero moves by a rounding-sized gradient's
sign, and over 30 steps such an element can part by ~1e-3 of itself while
the leaf and the outputs agree to ~1e-6.
Where the model's dtype is bf16 the gate is the reference's bf16 gate
between tiers, 3e-2 (tests/test_attention.py:117). One leaf is left out: the
attention key projection's bias, whose gradient is zero in exact
arithmetic (a softmax row is unchanged by a shift common to its scores).
Both packages hand Adam rounding noise of ~1e-9 there, which it turns into
steps of the learning rate's size in either direction; the leaf changes no
output, which the logits check.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.nn.models import ModelBundle as JaxBundle  # noqa: E402
from mmlspark_tpu.nn.trainer import DNNLearner as JaxLearner  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.nn import DNNLearner, ModelBundle, flax_blob  # noqa: E402
from mmlspark_tpu_torch.resilience.elastic import PreemptionGuard  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
BF16_TOL = 3e-2


class TripGuard(PreemptionGuard):
    """Drains after the Nth step-boundary poll (tests/test_elastic.py:38)."""

    def __init__(self, after: int, **kw):
        kw.setdefault("install", False)
        super().__init__(**kw)
        self.polls = 0
        self.after = after

    def should_checkpoint(self) -> bool:
        self.polls += 1
        if self.polls >= self.after:
            self.request_drain("test-trip")
        return super().should_checkpoint()


def vector_table(n=256, f=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)
    return x, y


def image_table(n=64, hw=8, classes=4, seed=1):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=n)
    x = rng.normal(scale=0.5, size=(n, hw, hw, 3)).astype(np.float32)
    x[..., 0] += y[:, None, None] * 0.5      # a learnable class signal
    return x, y.astype(np.float64)


def jax_init(arch, shape, seed=0, **config):
    jb = JaxBundle(architecture=arch, config=config, variables={}, input_shape=tuple(shape))
    jb.variables = jax.jit(jb.module.init)(jax.random.PRNGKey(seed),
                                           jnp.zeros((1, *shape), jnp.float32))
    return jb


def carry(jb) -> ModelBundle:
    config = {k: "bfloat16" if v is jnp.bfloat16 else v for k, v in jb.config.items()}
    return ModelBundle(architecture=jb.architecture, config=config,
                       variables=jax.tree.map(np.asarray, jb.variables),
                       input_shape=tuple(jb.input_shape))


def fit_both(jb, x, y, **params):
    params.setdefault("use_mesh", False)
    ref = JaxLearner(architecture=jb.architecture, **params)
    ref.init_bundle = jb
    jm = ref.fit(JaxTable({"features": x, "label": y}))
    est = DNNLearner(architecture=jb.architecture, device="cpu", **params)
    est.init_bundle = carry(jb)
    return jm, est.fit(Table({"features": x, "label": y}))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def assert_same_fit(jm, pm, x, tol=None):
    rtol, atol = (RTOL, ATOL) if tol is None else (tol, tol)
    want = dict(_leaves(jax.tree.map(np.asarray, jm.bundle.variables)))
    got = dict(_leaves(pm.bundle.variables))
    assert got.keys() == want.keys()
    for path, w in want.items():
        if path[-2:] == ("key", "bias"):
            continue
        g = got[path]
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, path
        w = w.astype(np.float32)
        gap = float(np.abs(g - w).max()) if w.size else 0.0
        assert gap <= rtol * float(np.abs(w).max(initial=0.0)) + atol, ("/".join(path), gap)
    lj = np.asarray(jm.transform(JaxTable({"features": x}))["raw_prediction"])
    lp = np.asarray(pm.transform(Table({"features": x}))["raw_prediction"])
    np.testing.assert_allclose(lp, lj, rtol=rtol, atol=atol)


def port_bytes(model) -> bytes:
    return flax_blob.to_bytes(model.bundle.variables)


