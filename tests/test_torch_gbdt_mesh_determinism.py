"""The port's `deterministic` histogram merge on spawned gloo ranks: the
GBDT cases of tests/test_collectives_determinism.py:137-190, on a mesh of
8 shards whose shard -> rank table is permuted, and each fit against the
JAX package's on a mesh of 8 of its CPU devices.

The fixed-point merge gives the same bits under any reduction order, so a
deterministic fit is byte-identical whichever rank holds which shard, the
voting learner's merge of its voted features included, and its quality
is the plain merge's. (The reference's own cases build a one-axis mesh
named "d", which its Booster does not shard; here the fits really run
over 8 ranks.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.parallel import RankPool  # noqa: E402

from test_torch_mesh_common import (  # noqa: E402
    WORLD, assert_same_fit, jax_mesh_fit, port_mesh_fit)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, backend="gloo", workdir=str(tmp_path_factory.mktemp("ranks")),
                 timeout_s=120)
    yield p
    p.close()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    n, f = 512, 6
    x = rng.normal(size=(n, f))
    # weak signal + label noise: plenty of near-tied candidate splits
    y = (x[:, 0] * 0.3 + x[:, 1] * 0.29 + rng.normal(scale=1.0, size=n) > 0).astype(np.float64)
    return x, y


OPTS = dict(objective="binary", num_iterations=8, num_leaves=15, min_data_in_leaf=5)


def test_byte_identical_across_rank_permutations(pool, data):
    x, y = data
    opts = dict(OPTS, deterministic=True)
    t1 = port_mesh_fit(pool, x, y, opts, 8)
    t2 = port_mesh_fit(pool, x, y, opts, 8, ranks=[5, 2, 7, 0, 3, 6, 1, 4])
    assert t1.to_text() == t2.to_text()
    assert_same_fit(jax_mesh_fit(x, y, opts, 8, perm=[5, 2, 7, 0, 3, 6, 1, 4]), t1, x)


def test_voting_parallel_deterministic_across_permutations(pool, data):
    """The voted features' merge rides the same fixed-point routing."""
    x, y = data
    opts = dict(OPTS, deterministic=True, tree_learner="voting_parallel", top_k=3)
    fits = [port_mesh_fit(pool, x, y, opts, 8, ranks=perm)
            for perm in (None, [6, 3, 0, 5, 2, 7, 4, 1])]
    assert fits[0].to_text() == fits[1].to_text()
    assert_same_fit(jax_mesh_fit(x, y, opts, 8), fits[0], x)


def test_deterministic_matches_plain_quality(pool, data):
    """The quantized merge does not change the model's quality measurably."""
    x, y = data
    accs = []
    for det in (False, True):
        b = port_mesh_fit(pool, x, y, dict(OPTS, deterministic=det), 8)
        accs.append(float(((b.predict(x) > 0.5) == (y > 0.5)).mean()))
    assert abs(accs[0] - accs[1]) < 0.02
