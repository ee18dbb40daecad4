"""Shared parts of the port's GBDT mesh tests (tests/test_torch_gbdt_mesh*.py):
a fit on the ranks of a `RankPool`, the same fit in the JAX package on its
8 CPU devices (tests/conftest.py), and the comparison of two fits.

This module runs only in the test process; the ranks run
tests/test_torch_mesh_jobs.py, which imports no jax.
"""

import os
import sys

import numpy as np

from mmlspark_tpu.core import kernels as jax_kernels
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.parallel.mesh import set_default_mesh as jax_set_default_mesh
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions

import test_torch_mesh_jobs as jobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

WORLD = 8


def with_xla(fn):
    """Run fn under the JAX package's kernel mode "xla", restored after."""
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


def texts_of(results) -> str:
    """The one model text every rank of a job returned."""
    texts = [r if isinstance(r, str) else r[0] for r in results if r is not None]
    assert texts and all(t == texts[0] for t in texts), "the ranks hold different models"
    return texts[0]


def port_mesh_fit(pool, x, y, opts: dict, shards: int, ranks=None, valid=None) -> Booster:
    """Booster.train on a mesh of `shards` ranks of the pool (first ranks,
    or the table `ranks`): every rank's model, checked equal, on the CPU."""
    ranks = list(range(shards)) if ranks is None else list(ranks)
    return Booster.from_text(texts_of(pool.run(jobs.train, x, y, opts, ranks, valid)),
                             device="cpu")


def port_mesh_estimator(pool, kind, x, y, params: dict, shards: int) -> Booster:
    return Booster.from_text(texts_of(pool.run(
        jobs.fit_estimator, kind, x, y, params, list(range(shards)))), device="cpu")


def port_fit(x, y, opts: dict, valid=None) -> Booster:
    return Booster.train(x, y, TrainOptions(device="cpu", **opts), valid=valid)


def jax_mesh_fit(x, y, opts: dict, shards: int, valid=None, perm=None):
    """The JAX package's fit on a mesh of its first `shards` CPU devices."""
    import jax
    from jax.sharding import Mesh

    if perm is None:
        mesh = jax_make_mesh(n_data=shards)
    else:
        devs = jax.devices()[:shards]
        mesh = Mesh(np.asarray([devs[i] for i in perm]).reshape(shards, 1), ("data", "model"))
    return with_xla(lambda: JaxBooster.train(x, y, JaxOptions(**opts), valid=valid, mesh=mesh))


def jax_mesh_estimator(kind, x, y, params: dict, shards: int):
    from mmlspark_tpu.core.schema import Table
    from mmlspark_tpu.gbdt import GBDTClassifier, GBDTRegressor

    est = {"classifier": GBDTClassifier, "regressor": GBDTRegressor}[kind]

    def fit():
        jax_set_default_mesh(jax_make_mesh(n_data=shards))
        try:
            return est(use_mesh=True, **params).fit(Table({"features": x, "label": y})).booster
        finally:
            jax_set_default_mesh(None)

    return with_xla(fit)


def assert_same_fit(ref, port, x, tol: float = 1e-5, gain_floor: float = 1e-4,
                    order_ties: bool = False):
    """`port` against `ref` by chip_smoke.compare_fits: equal splits, or
    splits that part at near-ties (gains within `tol` relative, or within
    `gain_floor` of the tree's largest gain) routing every row alike; leaf
    values within rtol `tol`; every tree compared.

    One parting ends the comparison early: a split whose gain is zero in
    exact arithmetic (a node of one class on separable data), whose f32
    value (0 or ~1e-5) one summation order takes and the other does not
    take, or takes elsewhere. Both gains must then lie within `gain_floor`
    of the tree's largest, and the two fits are held to the JAX package's
    own contract between summation orders (estimators.py use_mesh:
    predictions within 1e-3). `order_ties`: compare_fits' rule for
    categorical nodes (categories whose ratios tie in exact arithmetic)."""
    assert port.num_trees == ref.num_trees
    parity = chip_smoke.compare_fits(ref, port, ref.bin_mapper.transform(x), tol=tol,
                                     gain_floor=gain_floor, order_ties=order_ties)
    if parity["trees_compared"] == ref.num_trees:
        np.testing.assert_allclose(port.predict_raw(x), np.asarray(ref.predict_raw(x)),
                                   rtol=10 * tol, atol=10 * tol)
        return parity
    last = parity["near_ties"][-1]
    top = float(np.max(np.abs(ref.gain[last["tree"]])))
    assert max(abs(last["cpu_gain"]), abs(last["cuda_gain"])) <= gain_floor * top, \
        parity["near_ties"]
    np.testing.assert_allclose(port.predict(x), np.asarray(ref.predict(x)), rtol=1e-3, atol=1e-3)
    return parity
