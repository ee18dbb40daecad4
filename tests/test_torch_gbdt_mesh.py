"""The port's distributed GBDT on spawned gloo ranks: the cases of
tests/test_parallel.py:139-315 (TestDistributedDeterminism's GBDT cases),
each at the reference's own tolerance, and each mesh fit also against the
JAX package's fit on a mesh of the same shard count.

Two invariants. The reference's own: every rank ends with the same model,
and the mesh model equals the one-device model (by to_text where the
reference asserts it). And the port's: its mesh fit grows the JAX
package's mesh fit (chip_smoke.compare_fits: equal splits, or near-ties
whose two splits route every row alike; a float all-reduce adds the shards
in gloo's order, XLA's in its own).

One pool of 8 ranks (a `file://` rendezvous in tmp_path) serves the file;
a mesh of fewer shards is a sub-group of it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.automl.metrics import auc as jax_auc  # noqa: E402
from mmlspark_tpu_torch.automl.metrics import auc  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassifier, GBDTRegressor  # noqa: E402
from mmlspark_tpu_torch.parallel import RankPool  # noqa: E402

from test_torch_mesh_common import (  # noqa: E402
    WORLD, assert_same_fit, jax_mesh_estimator, jax_mesh_fit, port_mesh_estimator,
    port_mesh_fit)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, backend="gloo", workdir=str(tmp_path_factory.mktemp("ranks")),
                 timeout_s=120)
    yield p
    p.close()


def _gbdt_data(n=256, f=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = (x[:, 0] - 0.5 * x[:, 1] + 0.25 * x[:, 2] > 0).astype(np.float64)
    return x, y


def _single(kind, x, y, params):
    est = {"classifier": GBDTClassifier, "regressor": GBDTRegressor}[kind]
    return est(device="cpu", **params).fit(Table({"features": x, "label": y})).booster


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_gbdt_model_matches_single_device(pool, n_devices):
    x, y = _gbdt_data()
    params = dict(num_iterations=10, num_leaves=15)
    ref = _single("classifier", x, y, params)
    dist = port_mesh_estimator(pool, "classifier", x, y, params, n_devices)
    assert dist.to_text() == ref.to_text()
    np.testing.assert_array_equal(dist.predict(x), ref.predict(x))
    assert_same_fit(jax_mesh_estimator("classifier", x, y, params, n_devices), dist, x)


def test_gbdt_regressor_matches_single_device(pool):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(256, 5))
    y = 2.0 * x[:, 0] - x[:, 1] + 0.1 * rng.normal(size=256)
    params = dict(num_iterations=8, num_leaves=15)
    ref = _single("regressor", x, y, params)
    dist = port_mesh_estimator(pool, "regressor", x, y, params, 8)
    assert dist.to_text() == ref.to_text()
    assert_same_fit(jax_mesh_estimator("regressor", x, y, params, 8), dist, x)


def test_gbdt_sparse_signal_within_documented_tolerance(pool):
    """Sparse weak-signal features: near-tie splits where the merge order
    can flip a branch; the contract is predictions at 1e-3, not bytes."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 10)) * (rng.random(size=(512, 10)) < 0.3)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)
    params = dict(num_iterations=10, num_leaves=15)
    ref = _single("classifier", x, y, params)
    dist = port_mesh_estimator(pool, "classifier", x, y, params, 8)
    p_ref, p_dist = ref.predict(x).astype(np.float64), dist.predict(x).astype(np.float64)
    np.testing.assert_allclose(p_dist, p_ref, rtol=1e-3, atol=1e-3)
    assert ((p_dist > 0.5) == (p_ref > 0.5)).mean() > 0.99
    assert_same_fit(jax_mesh_estimator("classifier", x, y, params, 8), dist, x, tol=1e-4)


def test_voting_parallel_with_large_topk_equals_data_parallel(pool):
    """2k >= F selects every feature: byte-identical to data_parallel."""
    x, y = _gbdt_data()
    params = dict(num_iterations=8, num_leaves=15)
    data_par = port_mesh_estimator(pool, "classifier", x, y, params, 8)
    voting = port_mesh_estimator(pool, "classifier", x, y, dict(
        params, tree_learner="voting_parallel", top_k=x.shape[1]), 8)
    assert voting.to_text() == data_par.to_text()


def test_voting_parallel_restricts_and_still_learns(pool):
    """Small top_k: each tree splits on the 2k voted features only, and the
    two informative ones dominate the vote."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(512, 24))
    y = (x[:, 3] - 0.8 * x[:, 11] > 0).astype(np.float64)
    params = dict(num_iterations=10, num_leaves=15, tree_learner="voting_parallel", top_k=2)
    model = port_mesh_estimator(pool, "classifier", x, y, params, 8)
    imp = model.feature_importances("split")
    assert imp[3] > 0 and imp[11] > 0
    acc = ((model.predict(x) >= 0.5) == y).mean()
    assert acc > 0.9, acc
    assert_same_fit(jax_mesh_estimator("classifier", x, y, params, 8), model, x)


def test_voting_parallel_restricted_holdout_auc_tracks_data_parallel(pool):
    """At top_k ~ F/4 the vote approximates the full merge: holdout AUC
    within 0.02 of data-parallel."""
    rng = np.random.default_rng(9)
    n_tr, n_te, f_dim = 4096, 1024, 16
    x = rng.normal(size=(n_tr + n_te, f_dim))
    logits = x[:, 0] - 0.8 * x[:, 5] + 0.6 * x[:, 9] - 0.4 * x[:, 13]
    y = (logits + rng.normal(scale=0.5, size=n_tr + n_te) > 0).astype(np.float64)
    xt, yt = x[:n_tr], y[:n_tr]
    cfg = dict(num_iterations=20, num_leaves=15, min_data_in_leaf=10)
    data_par = port_mesh_estimator(pool, "classifier", xt, yt, cfg, 8)
    vcfg = dict(cfg, tree_learner="voting_parallel", top_k=f_dim // 4)
    voting = port_mesh_estimator(pool, "classifier", xt, yt, vcfg, 8)
    auc_dp = auc(y[n_tr:], data_par.predict(x[n_tr:]))
    auc_v = auc(y[n_tr:], voting.predict(x[n_tr:]))
    assert auc_dp > 0.9, auc_dp
    assert auc_v >= auc_dp - 0.02, (auc_v, auc_dp)
    ref = jax_mesh_estimator("classifier", xt, yt, vcfg, 8)
    assert_same_fit(ref, voting, xt, tol=1e-4)
    assert abs(auc_v - jax_auc(y[n_tr:], np.asarray(ref.predict(x[n_tr:])))) < 2e-3


def test_voting_ties_break_to_the_lower_feature_like_lax_top_k(pool):
    """Duplicate columns tie in every shard's local ranking; lax.top_k
    keeps the lower index, and so must the port's stable sort, or the
    voted sets differ from the reference's."""
    rng = np.random.default_rng(21)
    base = rng.normal(size=(768, 4))
    x = np.column_stack([base, base[:, [1, 0]], rng.normal(size=(768, 3))])
    y = (base[:, 0] + 0.7 * base[:, 1] + 0.3 * rng.normal(size=768) > 0).astype(np.float64)
    opts = dict(objective="binary", num_iterations=6, num_leaves=7,
                tree_learner="voting_parallel", top_k=1)
    port = port_mesh_fit(pool, x, y, opts, 4)
    ref = jax_mesh_fit(x, y, opts, 4)
    assert_same_fit(ref, port, x)
    # the duplicates (columns 4, 5) never win over their originals
    assert not np.isin(port.feature, [4, 5]).any()
