"""The port's data-parallel DNNLearner on spawned gloo ranks: the case of
tests/test_parallel.py:322-345 (a data-parallel DNN fit equals the
one-device fit on the same batches) at 2 and 4 shards, and a BatchNorm
model, whose moments cover the global batch.

Every rank must end with the same parameters, byte for byte. The mesh fit
is held against the port's one-device fit and against the JAX package's
fit on a mesh of the same shard count (its 8 CPU devices,
tests/conftest.py), from one carried-over init bundle, at
tests/test_torch_trainer_common.py's gate (rtol 2e-4, atol 2e-5, the
reference's own gate at tests/test_parallel.py:345).

One pool of 4 ranks (a `file://` rendezvous in tmp_path) serves the file;
the ranks run tests/test_torch_mesh_jobs.py, which imports no jax.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.nn.trainer import DNNLearner as JaxLearner  # noqa: E402
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from mmlspark_tpu.parallel.mesh import set_default_mesh as jax_set_default_mesh  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.nn import DNNLearner, ModelBundle, flax_blob  # noqa: E402
from mmlspark_tpu_torch.parallel import RankPool  # noqa: E402

import test_torch_mesh_jobs as jobs  # noqa: E402
from test_torch_trainer_common import assert_same_fit, carry, image_table, jax_init  # noqa: E402

WORLD = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, backend="gloo", workdir=str(tmp_path_factory.mktemp("ranks")),
                 timeout_s=120)
    yield p
    p.close()


class _Fit:
    """A fit's trained variables in the shape assert_same_fit reads."""

    def __init__(self, variables, bundle: ModelBundle):
        import dataclasses

        self.bundle = dataclasses.replace(bundle, variables=variables, _module=None)

    def transform(self, table):
        from mmlspark_tpu_torch.nn import DNNModel

        return DNNModel(device="cpu").set_bundle(self.bundle).transform(table)


def _mesh_fit(pool, jb, x, y, params, shards):
    b = carry(jb)
    bundle = dict(architecture=b.architecture, config=b.config, variables=b.variables,
                  input_shape=b.input_shape)
    got = [v for v in pool.run(jobs.fit_dnn, x, y, params, bundle, list(range(shards)))
           if v is not None]
    assert len(got) == shards
    blobs = {flax_blob.to_bytes(v) for v in got}
    assert len(blobs) == 1, "the ranks hold different parameters"
    return _Fit(got[0], b)


def _single_fit(jb, x, y, params):
    est = DNNLearner(architecture=jb.architecture, use_mesh=False, device="cpu", **params)
    est.init_bundle = carry(jb)
    return est.fit(Table({"features": x, "label": y}))


def _jax_mesh_fit(jb, x, y, params, shards):
    jax_set_default_mesh(jax_make_mesh(n_data=shards))
    try:
        est = JaxLearner(architecture=jb.architecture, use_mesh=True, **params)
        est.init_bundle = jb
        return est.fit(JaxTable({"features": x, "label": y}))
    finally:
        jax_set_default_mesh(None)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dnn_step_matches_single_device(pool, n_devices):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(128, 8)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float64)
    jb = jax_init("mlp", (8,), seed=3, features=(16,), num_outputs=2)
    params = dict(epochs=2, batch_size=64, learning_rate=0.01, bfloat16=False, seed=3)
    dist = _mesh_fit(pool, jb, x, y, params, n_devices)
    ref = _single_fit(jb, x, y, params)
    leaves = zip(jax.tree.leaves(ref.bundle.variables["params"]),
                 jax.tree.leaves(dist.bundle.variables["params"]))
    for a, b in leaves:
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=2e-4, atol=2e-5)
    assert_same_fit(_jax_mesh_fit(jb, x, y, params, n_devices), dist, x)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_batchnorm_moments_cover_the_global_batch(pool, n_devices):
    """A BN model on the mesh: its statistics are the global batch's, so
    the fit matches the one-device fit and the JAX package's mesh fit."""
    x, y = image_table(n=64, hw=6)
    jb = jax_init("resnet", (6, 6, 3), seed=1, stage_sizes=(1,), num_filters=4, num_outputs=4)
    params = dict(epochs=2, batch_size=32, learning_rate=0.01, bfloat16=False, seed=4,
                  optimizer="momentum")
    dist = _mesh_fit(pool, jb, x, y, params, n_devices)
    assert_same_fit(_single_fit(jb, x, y, params), dist, x)
    assert_same_fit(_jax_mesh_fit(jb, x, y, params, n_devices), dist, x)


def test_streamed_mesh_fit_with_a_snapshot_resumes_to_the_same_bytes(pool, tmp_path):
    """Streamed epochs on 2 shards with snapshots written by shard 0's rank:
    a fit resumed from its epoch-1 snapshot equals the uninterrupted one."""
    x, y = image_table(n=64, hw=6, seed=3)
    jb = jax_init("resnet", (6, 6, 3), seed=2, stage_sizes=(1,), num_filters=4, num_outputs=4)
    ck = str(tmp_path / "ck")
    params = dict(epochs=1, batch_size=32, bfloat16=False, seed=5, fused_epochs=False,
                  checkpoint_dir=ck)
    _mesh_fit(pool, jb, x, y, params, 2)
    resumed = _mesh_fit(pool, jb, x, y, dict(params, epochs=2), 2)
    whole = _mesh_fit(pool, jb, x, y, dict(params, epochs=2, checkpoint_dir=None), 2)
    assert flax_blob.to_bytes(resumed.bundle.variables) == \
        flax_blob.to_bytes(whole.bundle.variables)
