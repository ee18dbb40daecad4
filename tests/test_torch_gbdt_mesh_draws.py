"""The port's distributed GBDT on spawned gloo ranks, continued from
test_torch_gbdt_mesh_boosting.py: tests/test_gbdt.py:524 (mesh training
against the one-device fit), the per-shard draws (bagged gbdt, goss, rf:
each shard folds its index into the row key, fused.py:320-322, so the
port's shards draw the reference's rows), a multiclass fit, each against
the JAX package's fit on a mesh of the same shard count, and a
checkpointed mesh fit, whose snapshots only shard 0's rank writes. All
on 4 shards, the JAX package's fits too.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.parallel import RankPool  # noqa: E402

import chip_smoke  # noqa: E402
import test_torch_mesh_jobs as jobs  # noqa: E402
from test_torch_mesh_common import (  # noqa: E402
    assert_same_fit, jax_mesh_fit, port_fit, port_mesh_fit, texts_of)


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


def test_mesh_training_matches_single_device(pool):
    x, y = chip_smoke.make_classification(n=1024)
    opts = dict(objective="binary", num_iterations=8, num_leaves=15)
    b_single = port_fit(x, y, opts)
    b_mesh = port_mesh_fit(pool, x, y, opts, SHARDS)
    assert ((b_mesh.predict(x) >= 0.5) == y).mean() > 0.9
    np.testing.assert_allclose(b_single.predict_raw(x), b_mesh.predict_raw(x),
                               rtol=1e-3, atol=1e-3)
    assert_same_fit(jax_mesh_fit(x, y, opts, SHARDS), b_mesh, x)


@pytest.mark.parametrize("boosting", [
    dict(boosting_type="gbdt", bagging_fraction=0.8, bagging_freq=2, feature_fraction=0.8),
    dict(boosting_type="goss", feature_fraction=0.7),
    dict(boosting_type="rf", bagging_fraction=0.85, bagging_freq=1),
], ids=["bagged", "goss", "rf"])
def test_per_shard_draws_match_the_jax_package(pool, boosting):
    """Bags and GOSS samples fold the shard index into the row key
    (fused.py:320-322): the port's shards draw the reference's rows."""
    x, y = chip_smoke.make_dataset(1500, 14)
    opts = dict(objective="binary", num_iterations=10, num_leaves=15, **boosting)
    b = port_mesh_fit(pool, x, y, opts, SHARDS)
    assert_same_fit(jax_mesh_fit(x, y, opts, SHARDS), b, x)
    # a shard's draws are not the one-device draws
    assert b.to_text() != port_fit(x, y, opts).to_text()


def test_multiclass_mesh_matches_the_jax_package(pool):
    x, y = chip_smoke.make_classification(n=900, classes=3, seed=5)
    opts = dict(objective="multiclass", num_class=3, num_iterations=5, num_leaves=7)
    b = port_mesh_fit(pool, x, y, opts, SHARDS)
    np.testing.assert_allclose(b.predict_raw(x), port_fit(x, y, opts).predict_raw(x),
                               rtol=1e-3, atol=1e-3)
    assert_same_fit(jax_mesh_fit(x, y, opts, SHARDS), b, x)


def test_checkpointed_mesh_fit_resumes_byte_identical(pool, tmp_path):
    """checkpoint_every_n on a mesh: only shard 0's rank writes snapshots
    (one manifest entry a chunk, no rank racing another), every rank
    resumes from them, and the chunked and resumed fits equal the
    uninterrupted mesh fit byte for byte."""
    x, y = chip_smoke.make_dataset(1200, 8)
    opts = dict(objective="binary", num_iterations=9, num_leaves=7, bagging_fraction=0.8,
                bagging_freq=3, seed=3)
    whole = port_mesh_fit(pool, x, y, opts, SHARDS).to_text()
    ck = dict(opts, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every_n=3)
    chunked = pool.run(jobs.train, x, y, ck, list(range(SHARDS)))
    assert texts_of(chunked) == whole
    with open(os.path.join(ck["checkpoint_dir"], "manifest.json")) as fh:
        manifest = json.load(fh)
    assert [e["meta"]["rounds_done"] for e in manifest["entries"]] == [3, 6, 9]
    # a second fit finds the last snapshot on every rank: no rounds to run
    resumed = pool.run(jobs.train, x, y, ck, list(range(SHARDS)))
    assert texts_of(resumed) == whole
    assert {r[1] for r in resumed if r is not None} == {0}    # no histogram launched
    assert {r[2]["calls"] for r in resumed if r is not None} == {2}   # the restore check
