"""Jobs that the ranks of a `RankPool` run for tests/test_torch_tune.py's
`trial_submeshes` cases. A rank is a spawned process: this module imports
only numpy, torch and mmlspark_tpu_torch, never jax or the JAX package.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.automl import DiscreteHyperParam, GridSpace, TuneHyperparameters
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.core.schema import Table
from mmlspark_tpu_torch.gbdt import GBDTClassifier
from mmlspark_tpu_torch.parallel.mesh import get_mesh

SEEN_MESHES: list = []


class ProbeModel(Model):
    def _transform(self, table):
        return table.with_column("prediction", np.asarray(table["label"], np.float64))


class MeshProbe(Estimator):
    """Records the mesh each fit ran under: (its ranks, this param's seed)."""

    seed = Param(0, "dummy", ptype=int)

    def _fit(self, table):
        SEEN_MESHES.append((get_mesh().ranks, self.get("seed")))
        return ProbeModel()


def probe_submeshes(n_sub: int) -> list:
    """tests/test_automl.py's trials-bind-disjoint-submeshes case on this
    rank: the meshes its fits ran under, trials first, the refit last."""
    SEEN_MESHES.clear()
    t = Table({"x": np.arange(64.0), "label": (np.arange(64.0) % 2)})
    TuneHyperparameters(
        models=MeshProbe(),
        param_space=GridSpace({"seed": DiscreteHyperParam([1, 2, 3, 4])}),
        num_folds=2, parallelism=4, evaluation_metric="accuracy",
        trial_submeshes=n_sub, refit=False,
    ).fit(t)
    return list(SEEN_MESHES)


def tune_on_submeshes(x, y, n_sub: int, checkpoint_dir=None) -> dict:
    """tests/test_automl.py's submesh tuning end to end on this rank."""
    t = Table({"features": x, "label": y})
    model = TuneHyperparameters(
        models=GBDTClassifier(use_mesh=True, device="cpu"),
        param_space=GridSpace({"num_leaves": DiscreteHyperParam([3, 7]),
                               "num_iterations": DiscreteHyperParam([4])}),
        num_folds=2, parallelism=2, evaluation_metric="accuracy",
        trial_submeshes=n_sub, checkpoint_dir=checkpoint_dir,
    ).fit(t)
    out = model.transform(t)
    return {"best_metric": model.best_metric, "best_params": model.best_params,
            "metrics": [r["metric"] for r in model.all_results],
            "prediction": np.asarray(out["prediction"], np.float64),
            "text": model.best_model.booster.to_text()}
