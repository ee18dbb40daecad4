"""One tree from the port's `make_grow_fn` (mmlspark_tpu_torch/gbdt/engine.py)
against the JAX package's, on the same bins, gradients, hessians and mask.

Split structure and row routing must be equal; leaf values and gains agree
within rtol 1e-5 (the histogram and node-total sums run in another order).
The JAX side runs the way tests/test_gbdt.py runs it on the CPU: kernel
mode "xla" and "pallas_interpret", restored in `finally`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.gbdt import engine as jax_engine  # noqa: E402
from mmlspark_tpu_torch.gbdt import engine  # noqa: E402

F, B = 6, 32


def _inputs(n, seed, mask_frac=0.9):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, F)).astype(np.int32)
    # gradients of a binary objective at a partly-fit model
    signal = (bins[:, 0] - B / 2) / B + 0.5 * (bins[:, 1] > B // 3)
    p = 1.0 / (1.0 + np.exp(-0.3 * rng.normal(size=n)))
    y = (signal + 0.3 * rng.normal(size=n) > 0.25).astype(np.float32)
    grad = (p - y).astype(np.float32)
    hess = (p * (1.0 - p)).astype(np.float32)
    mask = (rng.random(n) < mask_frac).astype(np.float32)
    return bins, grad, hess, mask


def _grow_both(bins, grad, hess, mask, cfg, mode):
    nbins = np.full(F, B, np.int32)
    cat = np.zeros(F, bool)
    fmask = np.ones(F, np.float32)
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode(mode)
        jt, jv, jnode = jax_engine.make_grow_fn(F, B, cfg, nbins, cat)(
            bins, grad, hess, mask, fmask)
    finally:
        jax_kernels.set_kernel_mode(prior)
    tcfg = engine.GrowConfig(**cfg._asdict())
    grow = engine.make_grow_fn(F, B, tcfg, nbins, cat, device="cpu")
    tt, tv, tnode = grow(*(torch.from_numpy(a) for a in (bins, grad, hess, mask, fmask)))
    return jt, np.asarray(jv), np.asarray(jnode), tt, tv.numpy(), tnode.numpy()


def _assert_same_tree(jt, jv, jnode, tt, tv, tnode):
    for name in ("feature", "threshold_bin", "left", "right", "is_leaf"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tnode, jnode)
    np.testing.assert_allclose(tt.value.numpy(), np.asarray(jt.value), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tt.gain.numpy(), np.asarray(jt.gain), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mode", ["xla", "pallas_interpret"])
def test_one_tree_matches_jax(mode):
    cfg = jax_engine.GrowConfig(num_leaves=15, min_data_in_leaf=10.0,
                                learning_rate=0.1)
    out = _grow_both(*_inputs(1500, seed=0), cfg, mode)
    assert int(np.asarray(out[0].is_leaf).sum()) == 15     # grew every leaf
    _assert_same_tree(*out)


def test_tree_that_runs_out_of_gain_matches_jax():
    # 200 rows with min_data_in_leaf=25 allow at most 8 leaves of 15: the
    # last split steps are inactive and every update must stay gated off
    cfg = jax_engine.GrowConfig(num_leaves=15, min_data_in_leaf=25.0,
                                lambda_l2=1.0, learning_rate=0.3)
    out = _grow_both(*_inputs(200, seed=1, mask_frac=1.0), cfg, "xla")
    leaves = int(np.asarray(out[0].is_leaf).sum())
    assert 1 < leaves < 15
    _assert_same_tree(*out)
    # the unused node slots are untouched
    assert (out[3].feature.numpy()[2 * leaves - 1:] == -1).all()


def test_tied_gain_takes_the_first_feature():
    bins, grad, hess, mask = _inputs(800, seed=2, mask_frac=1.0)
    bins[:, 3] = bins[:, 0]          # feature 3 ties feature 0 at every bin
    cfg = jax_engine.GrowConfig(num_leaves=4, min_data_in_leaf=5.0)
    out = _grow_both(bins, grad, hess, mask, cfg, "xla")
    _assert_same_tree(*out)
    assert out[3].feature[0].item() == 0                    # first index wins


def test_tree_apply_matches_jax():
    bins, grad, hess, mask = _inputs(600, seed=3)
    cfg = jax_engine.GrowConfig(num_leaves=7, min_data_in_leaf=10.0)
    jt, *_, tt, tv, _ = _grow_both(bins, grad, hess, mask, cfg, "xla")
    probe = np.random.default_rng(4).integers(0, B, size=(300, F)).astype(np.int32)
    want = np.asarray(jax_engine.tree_apply(jt, jnp.asarray(probe), cfg.num_leaves))
    got = engine.tree_apply(tt, torch.from_numpy(probe), cfg.num_leaves).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # on the training rows, the walk lands where the grower routed them
    np.testing.assert_array_equal(
        engine.tree_apply(tt, torch.from_numpy(bins), cfg.num_leaves).numpy(), tv)


def test_categorical_and_mesh_options_raise():
    # categorical features grow (tests/test_torch_gbdt_categorical.py) and
    # the mesh learners run on several ranks (tests/test_torch_gbdt_mesh*.py);
    # without a mesh of several shards, voting has no effect and a one-shard
    # mesh is no mesh, as in the reference: the same tree bit for bit. A
    # model or sequence axis still raises.
    from mmlspark_tpu_torch.parallel.mesh import make_mesh

    bins, grad, hess, mask = _inputs(500, seed=8)
    nbins = np.full(F, B, np.int32)
    cfg = engine.GrowConfig(num_leaves=7, min_data_in_leaf=10.0)
    args = [torch.from_numpy(a) for a in (bins, grad, hess, mask, np.ones(F, np.float32))]
    plain = engine.make_grow_fn(F, B, cfg, nbins, np.zeros(F, bool), device="cpu")(*args)
    for kw in (dict(mesh=make_mesh()), dict(mesh=make_mesh(n_data=1), cfg=cfg._replace(
            voting_top_k=2, deterministic=True)), dict(cfg=cfg._replace(voting_top_k=2))):
        got = engine.make_grow_fn(F, B, kw.get("cfg", cfg), nbins, np.zeros(F, bool),
                                  device="cpu", mesh=kw.get("mesh"))(*args)
        for a, b in zip(got[0], plain[0]):
            assert torch.equal(a, b)
        assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh(n_data=1, n_model=2)