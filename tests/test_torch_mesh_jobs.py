"""Jobs that the ranks of a `RankPool` run for the port's mesh tests.

A rank is a spawned process, so this module imports only numpy, torch and
mmlspark_tpu_torch: no rank ever imports jax or the JAX package. Every rank
of the pool runs every job, in the same order; a rank outside a job's mesh
returns None. Meshes are cached by their shard -> rank table, because
`make_mesh` creates a process group, which every rank must do together.
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.parallel import collectives as C
from mmlspark_tpu_torch.parallel.mesh import make_mesh

_MESHES: dict = {}


def mesh_of(ranks, device=None):
    key = (tuple(ranks), None if device is None else str(device))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(ranks=key[0], device=device)
    return _MESHES[key]


def _shard(shard_values, mesh) -> torch.Tensor:
    """Shard s's block: row s of shard_values, keeping its leading axis of
    one (what shard_map's P(axis) hands a device)."""
    s = mesh.shard_index
    return torch.as_tensor(np.ascontiguousarray(np.asarray(shard_values)[s:s + 1]))


def reduce(name: str, shard_values, ranks):
    """Shard s contributes shard_values[s]; returns (shard index, this
    rank's result of collectives.<name> as a numpy array)."""
    mesh = mesh_of(ranks)
    if not mesh.is_member:
        return None
    return mesh.shard_index, getattr(C, name)(_shard(shard_values, mesh), mesh).numpy()


def gather(shard_values, ranks, tiled: bool = True):
    """(all_gather, reduce_scatter, pmin, pmean, axis_index, axis_size) of
    shard s's row of shard_values."""
    mesh = mesh_of(ranks)
    if not mesh.is_member:
        return None
    x = torch.as_tensor(np.asarray(shard_values)[mesh.shard_index])
    return (C.all_gather(x, mesh, tiled=tiled).numpy(),
            C.reduce_scatter(x, mesh).numpy(), C.pmin(x, mesh).numpy(),
            C.pmean(x, mesh).numpy(), C.axis_index(mesh), C.axis_size(mesh))


def train(x, y, opts: dict, ranks, valid=None, weights=None, device="cpu"):
    """Booster.train on this rank's mesh: (to_text(), K1-style launches of
    the histogram wrapper on the card, collective stats)."""
    from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    mesh = mesh_of(ranks)
    if not mesh.is_member:
        return None
    histogram.launches = 0
    C.reset_stats()
    b = Booster.train(x, y, TrainOptions(device=device, **opts), valid=valid,
                      weights=weights, mesh=mesh)
    return b.to_text(), histogram.launches, C.stats()


def fit_estimator(kind: str, x, y, params: dict, ranks, device="cpu"):
    """GBDTClassifier / GBDTRegressor(use_mesh=True) under `use_mesh`."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.gbdt import GBDTClassifier, GBDTRegressor
    from mmlspark_tpu_torch.parallel.mesh import use_mesh

    mesh = mesh_of(ranks)
    if not mesh.is_member:
        return None
    est = {"classifier": GBDTClassifier, "regressor": GBDTRegressor}[kind]
    with use_mesh(mesh):
        model = est(use_mesh=True, device=device, **params).fit(
            Table({"features": x, "label": y}))
    return model.booster.to_text()


def fit_dnn(x, y, params: dict, bundle: dict, ranks, device="cpu"):
    """DNNLearner(use_mesh=True) under `use_mesh`, from the carried-over
    bundle (architecture, config, variables, input_shape): this rank's
    trained variables (flax layout, numpy)."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import DNNLearner, ModelBundle
    from mmlspark_tpu_torch.parallel.mesh import use_mesh

    mesh = mesh_of(ranks)
    if not mesh.is_member:
        return None
    est = DNNLearner(use_mesh=True, device=device, architecture=bundle["architecture"],
                     **params)
    est.init_bundle = ModelBundle(**bundle)
    with use_mesh(mesh):
        return est.fit(Table({"features": x, "label": y})).bundle.variables
