"""The port's distributed GBDT under the boosting options, on spawned gloo
ranks: the mesh cases of tests/test_gbdt.py (:420 L1 renewal, :456 dart,
:505 categorical, :696 feature fraction, :903 early stopping; :524 is in
test_torch_gbdt_mesh_draws.py), each at the reference's own tolerance
against the port's one-device fit, and each against the JAX package's
fit on a mesh of the same shard count (4) on its CPU devices.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.parallel import RankPool  # noqa: E402

import chip_smoke  # noqa: E402
from test_torch_mesh_common import (  # noqa: E402
    assert_same_fit, jax_mesh_fit, port_fit, port_mesh_fit)


# 4 shards, where the reference's cases run on 8 (mesh8): a split step is
# one gloo all-reduce, ~2 ms at 4 ranks on the CPU and ~6 ms at 8, and a
# pool of 4 holds half the memory
SHARDS = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(SHARDS, backend="gloo", workdir=str(tmp_path_factory.mktemp("ranks")),
                 timeout_s=120)
    yield p
    p.close()


def test_l1_renewal_mesh_matches_single_device(pool):
    """The renewal histograms and brackets are merged like the split
    histograms, so the renewed model is the one-device model."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(1024, 5))
    y = 10.0 * x[:, 0] + rng.normal(scale=2.0, size=1024)
    opts = dict(objective="l1", num_iterations=15, num_leaves=15)
    b1 = port_fit(x, y, opts)
    b2 = port_mesh_fit(pool, x, y, opts, SHARDS)
    np.testing.assert_allclose(b2.predict_raw(x), b1.predict_raw(x), rtol=2e-4, atol=2e-4)
    assert_same_fit(jax_mesh_fit(x, y, opts, SHARDS), b2, x)


def test_fused_dart_mesh_matches_single_device(pool):
    x, y = chip_smoke.make_classification(n=1024)
    opts = dict(objective="binary", boosting_type="dart", num_iterations=10, num_leaves=15,
                drop_rate=0.15)
    b1 = port_fit(x, y, opts)
    b2 = port_mesh_fit(pool, x, y, opts, SHARDS)
    np.testing.assert_allclose(b1.predict_raw(x), b2.predict_raw(x), rtol=1e-3, atol=1e-3)
    assert_same_fit(jax_mesh_fit(x, y, opts, SHARDS), b2, x)


def test_categorical_mesh_matches_single_device(pool):
    rng = np.random.default_rng(5)
    n = 2048
    cats = rng.integers(0, 6, n).astype(np.float64)
    y = np.isin(cats, [0, 2, 5]).astype(np.float64)
    x = np.column_stack([cats, rng.normal(size=n)])
    opts = dict(objective="binary", num_iterations=6, num_leaves=6, categorical_indexes=(0,),
                min_data_in_leaf=5)
    b1 = port_fit(x, y, opts)
    b2 = port_mesh_fit(pool, x, y, opts, SHARDS)
    np.testing.assert_allclose(b1.predict_raw(x), b2.predict_raw(x), rtol=1e-3, atol=1e-3)
    assert_same_fit(jax_mesh_fit(x, y, opts, SHARDS), b2, x, order_ties=True)


def test_feature_fraction_on_mesh(pool):
    """The feature masks come from the shared key: every rank grows from
    the same ones (per-shard masks broke the replicated tree state)."""
    x, y = chip_smoke.make_classification(n=640)
    opts = dict(objective="binary", num_iterations=3, num_leaves=7, feature_fraction=0.5,
                seed=3)
    b = port_mesh_fit(pool, x, y, opts, SHARDS)
    assert b.num_trees == 3
    assert_same_fit(jax_mesh_fit(x, y, opts, SHARDS), b, x)


def test_fused_es_stops_and_truncates_on_mesh(pool):
    x, y = chip_smoke.make_classification(n=1600)
    opts = dict(objective="binary", num_iterations=120, num_leaves=15,
                early_stopping_round=5)
    valid = (x[1280:], y[1280:])
    b1 = port_fit(x[:1280], y[:1280], opts, valid=valid)
    bm = port_mesh_fit(pool, x[:1280], y[:1280], opts, SHARDS, valid=valid)
    assert b1.num_trees < 120 and b1.num_trees == b1.best_iteration + 1
    assert bm.num_trees < 120 and bm.num_trees == bm.best_iteration + 1
    ref = jax_mesh_fit(x[:1280], y[:1280], opts, SHARDS, valid=valid)
    assert bm.best_iteration == ref.best_iteration
    assert_same_fit(ref, bm, x[:1280])
