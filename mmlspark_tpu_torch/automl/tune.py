"""Hyperparameter search: grid / random CV with parallel trials.

Reference: src/tune-hyperparameters/ — `TuneHyperparameters`
(TuneHyperparameters.scala:33-194: kFold :114, fixed thread pool :79-92,
futures per (fold × paramMap) :136-173, metric via ComputeModelStatistics
:140-168), `HyperparamBuilder`/`DiscreteHyperParam`/`RangeHyperParam`
(HyperparamBuilder.scala:11-107), `GridSpace`/`RandomSpace`
(ParamSpace.scala:25-40), `DefaultHyperparams` (DefaultHyperparams.scala).

Counterpart of mmlspark_tpu/automl/tune.py. Trials are task-parallel on
host threads exactly like the reference; each trial's fits run on its
estimator's own device (GBDT's `device`, "cuda" by default), where the
card serializes their kernels while the threads overlap host-side work.
The folds, the random draws and the trial ledger are the JAX package's.

`trial_submeshes` differs in shape, not in result: the reference runs every
trial in one process, each under a submesh of its devices, while the
port's mesh is one process a rank (parallel/mesh.py). So every rank calls
`fit` (as a mesh fit is called), `split_mesh` cuts the mesh into
`trial_submeshes` meshes of consecutive ranks, trial i runs on submesh
i mod n — only the ranks of that submesh fit it, one trial after another,
with the submesh as their mesh — and the ranks then gather every trial's
score (`all_gather_object` on the whole group), so each of them picks the
same best trial and the refit runs on the full mesh. With a checkpoint
directory each submesh keeps its own trial ledger (`_trials-sub<i>`),
written by its first rank.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Sequence

import numpy as np

from ..core.params import HasLabelCol, Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import Table
from ..core.serialize import register_stage
from .metrics import ComputeModelStatistics, MetricConstants

__all__ = [
    "DiscreteHyperParam",
    "RangeHyperParam",
    "HyperparamBuilder",
    "GridSpace",
    "RandomSpace",
    "TuneHyperparameters",
    "TuneHyperparametersModel",
    "DefaultHyperparams",
]


class DiscreteHyperParam:
    """Reference: HyperparamBuilder.scala:20-28."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def grid_values(self):
        return list(self.values)

    def sample(self, rng: np.random.Generator):
        return self.values[int(rng.integers(len(self.values)))]


class RangeHyperParam:
    """Reference: HyperparamBuilder.scala:30-66 (int/long/float/double)."""

    def __init__(self, low, high, is_int: bool = False, n_grid: int = 5):
        self.low, self.high, self.is_int, self.n_grid = low, high, is_int, n_grid

    def grid_values(self):
        vals = np.linspace(self.low, self.high, self.n_grid)
        if self.is_int:
            return sorted({int(round(v)) for v in vals})
        return [float(v) for v in vals]

    def sample(self, rng: np.random.Generator):
        if self.is_int:
            return int(rng.integers(self.low, self.high + 1))
        return float(rng.uniform(self.low, self.high))


class HyperparamBuilder:
    """Collect (param name -> dist) pairs (HyperparamBuilder.scala:11-18)."""

    def __init__(self):
        self._params: dict[str, Any] = {}

    def add_hyperparam(self, name: str, dist) -> "HyperparamBuilder":
        self._params[name] = dist
        return self

    def build(self) -> dict[str, Any]:
        return dict(self._params)


class GridSpace:
    """Cartesian product of grid values (ParamSpace.scala:25-31)."""

    def __init__(self, space: dict[str, Any]):
        self.space = space

    def param_maps(self) -> Iterable[dict[str, Any]]:
        names = list(self.space)
        grids = [self.space[n].grid_values() for n in names]
        for combo in itertools.product(*grids):
            yield dict(zip(names, combo))


class RandomSpace:
    """Random draws from each dist (ParamSpace.scala:33-40)."""

    def __init__(self, space: dict[str, Any], num_runs: int, seed: int = 0):
        self.space, self.num_runs, self.seed = space, num_runs, seed

    def param_maps(self) -> Iterable[dict[str, Any]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_runs):
            yield {n: d.sample(rng) for n, d in self.space.items()}


def space_to_json(space: Any) -> dict:
    """JSON codec for param spaces so TuneHyperparameters can save/load
    (role of the reference's ComplexParam serialization for EstimatorParam)."""
    if isinstance(space, GridSpace):
        return {"kind": "grid", "space": {k: _dist_to_json(d) for k, d in space.space.items()}}
    if isinstance(space, RandomSpace):
        return {"kind": "random", "num_runs": space.num_runs, "seed": space.seed,
                "space": {k: _dist_to_json(d) for k, d in space.space.items()}}
    if isinstance(space, dict):
        return {"kind": "dict", "space": {k: _dist_to_json(d) for k, d in space.items()}}
    raise TypeError(f"cannot serialize param space of type {type(space).__name__}")


def space_from_json(doc: dict) -> Any:
    dists = {k: _dist_from_json(d) for k, d in doc["space"].items()}
    if doc["kind"] == "grid":
        return GridSpace(dists)
    if doc["kind"] == "random":
        return RandomSpace(dists, num_runs=doc["num_runs"], seed=doc["seed"])
    return dists


def _dist_to_json(dist: Any) -> dict:
    if isinstance(dist, DiscreteHyperParam):
        return {"kind": "discrete", "values": list(dist.values)}
    if isinstance(dist, RangeHyperParam):
        return {"kind": "range", "low": dist.low, "high": dist.high,
                "is_int": dist.is_int, "n_grid": dist.n_grid}
    raise TypeError(f"cannot serialize hyperparam dist {type(dist).__name__}")


def _dist_from_json(doc: dict) -> Any:
    if doc["kind"] == "discrete":
        return DiscreteHyperParam(doc["values"])
    return RangeHyperParam(doc["low"], doc["high"], is_int=doc["is_int"],
                           n_grid=doc["n_grid"])


def _kfold_indices(n: int, k: int, seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """MLUtils.kFold equivalent."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    folds = np.array_split(order, k)
    out = []
    for i in range(k):
        valid = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        out.append((train, valid))
    return out


def _gather_scores(mine: dict, n_trials: int) -> list:
    """Every trial's score on every rank: each rank brings the scores of
    its submesh's trials (all_gather_object over the whole group)."""
    import torch.distributed as dist

    merged = dict(mine)
    if dist.is_initialized():
        parts: list = [None] * dist.get_world_size()
        dist.all_gather_object(parts, mine)
        for part in parts:
            merged.update(part)
    missing = [ti for ti in range(n_trials) if ti not in merged]
    if missing:
        raise RuntimeError(f"no submesh reported trials {missing}")
    return [float(merged[ti]) for ti in range(n_trials)]


_MAXIMIZE = {
    MetricConstants.AUC, MetricConstants.ACCURACY, MetricConstants.PRECISION,
    MetricConstants.RECALL, MetricConstants.R2,
}


def _tune_record(kind: str, **data: Any) -> None:
    try:
        from ..observability.recorder import get_recorder

        get_recorder().record(kind, **data)
    except Exception:  # noqa: BLE001 — telemetry never blocks the sweep
        pass


def _give_trial_checkpoints(est, directory: str) -> None:
    """Point a trial's estimator at its own checkpoint directory so a
    killed trial resumes MID-fit, not from scratch. Only estimators that
    expose the checkpoint Params participate; an explicitly-set
    checkpoint_dir on the template estimator is left alone. Estimators
    whose checkpointing is off by default (GBDT's checkpoint_every_n=0)
    get a per-round cadence — CV fold fits are small, and the template
    estimator's own setting wins when present."""
    if "checkpoint_dir" not in est._params or est.get("checkpoint_dir"):
        return
    kw: dict[str, Any] = {"checkpoint_dir": directory}
    if ("checkpoint_every_n" in est._params
            and not int(est.get("checkpoint_every_n") or 0)):
        kw["checkpoint_every_n"] = 1
    est.set(**kw)


@register_stage
class TuneHyperparameters(HasLabelCol, Estimator):
    """K-fold CV search over estimators × param maps, trials on a thread
    pool (TuneHyperparameters.scala:33-194)."""

    models = Param(None, "estimator or list of estimators", required=True)
    evaluation_metric = Param("accuracy", "metric name to optimize", ptype=str)
    num_folds = Param(3, "cross-validation folds", ptype=int)
    parallelism = Param(4, "concurrent trials", ptype=int)
    seed = Param(0, "fold shuffling seed", ptype=int)
    param_space = Param(None, "GridSpace | RandomSpace | dict of dists", required=True)
    num_runs = Param(10, "random-search runs (dict param_space only)", ptype=int)
    refit = Param(True, "refit best params on the full table", ptype=bool)
    # the grid placed over partitions of the mesh — the default mesh is
    # split into N disjoint data submeshes and each trial fits on one
    # (reference thread-pool trials, TuneHyperparameters.scala:79-92,
    # share the whole cluster instead). 0 = all trials on the default mesh.
    trial_submeshes = Param(0, "disjoint data submeshes for parallel trials", ptype=int)
    # preemption-tolerant sweeps (resilience/elastic.py): completed trials
    # land in a checksummed ledger under checkpoint_dir and are skipped on
    # resume; in-flight trials get per-(trial, fold) checkpoint dirs so a
    # killed fit resumes mid-trial. A resumed sweep reproduces the
    # uninterrupted sweep's best model byte-for-byte.
    checkpoint_dir = Param(
        None, "sweep checkpoint directory (trial ledger + per-trial dirs)",
        ptype=str)
    trial_restarts = Param(
        0, "transient-failure retries per trial (RestartPolicy budget)",
        ptype=int)
    # distributed preemptible sweeps (automl/sweep.py): workers > 0 runs
    # the trials on a fleet of preemptible worker PROCESSES with
    # rung-synchronized hyperband early stopping instead of the
    # in-process thread pool; requires checkpoint_dir (spec, ledger, and
    # sub-checkpoints live there). The sweep digest is byte-identical at
    # any worker count.
    workers = Param(
        0, "preemptible sweep worker processes (0 = in-process threads)",
        ptype=int)
    pruner = Param(
        None, "sweep.HyperbandPruner for rung-synchronized early "
        "stopping (workers > 0; None = pruner defaults)")

    # programmatic override for the Param-built default restart policy
    restart_policy = None

    def _space(self):
        sp = self.get("param_space")
        if isinstance(sp, (GridSpace, RandomSpace)):
            return sp
        return RandomSpace(dict(sp), self.get("num_runs"), self.get("seed"))

    def _save_state(self) -> dict[str, Any]:
        models = self.get("models")
        return {
            "models": list(models) if isinstance(models, (list, tuple)) else [models],
            "models_was_list": isinstance(models, (list, tuple)),
            "param_space_doc": space_to_json(self.get("param_space")),
        }

    def _load_state(self, state: dict[str, Any]) -> None:
        models = state["models"] if state["models_was_list"] else state["models"][0]
        self.set(models=models, param_space=space_from_json(state["param_space_doc"]))

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("models", None)
        d.pop("param_space", None)
        return d

    def _fit(self, table: Table) -> "TuneHyperparametersModel":
        models = self.get("models")
        if isinstance(models, Estimator):
            models = [models]
        metric = self.get("evaluation_metric")
        maximize = metric in _MAXIMIZE
        folds = _kfold_indices(len(table), self.get("num_folds"), self.get("seed"))
        param_maps = list(self._space().param_maps())
        trials = [
            (mi, pm) for mi in range(len(models)) for pm in param_maps
        ]

        if metric == "all":
            raise ValueError(
                "evaluation_metric='all' cannot rank trials; pick one metric "
                f"(e.g. {sorted(_MAXIMIZE)})"
            )
        if int(self.get("workers") or 0) > 0:
            return self._fit_distributed(table, models, trials, metric)
        stats = ComputeModelStatistics(
            label_col=self.get("label_col"),
            scored_labels_col="prediction",
            evaluation_metric=metric,
        )

        # trial_submeshes: this rank's submesh, and the trials it runs
        n_sub = int(self.get("trial_submeshes") or 0)
        my_sub, my_sub_i = None, 0
        if n_sub:
            from ..parallel.mesh import get_mesh, split_mesh

            subs = split_mesh(get_mesh(), n_sub)
            my_sub_i = next(i for i, s in enumerate(subs) if s.is_member)
            my_sub = subs[my_sub_i]

        # sweep checkpointing: a checksummed trial ledger (reusing the
        # TrainingCheckpointer store) + per-(trial, fold) checkpoint dirs
        ckpt_dir = self.get("checkpoint_dir")
        ledger: dict[str, float] = {}
        ledger_ckpt = None
        ledger_lock = threading.Lock()
        if ckpt_dir:
            from ..resilience.elastic import TrainingCheckpointer

            ledger_ckpt = TrainingCheckpointer(
                os.path.join(ckpt_dir, "_trials" if my_sub is None
                             else f"_trials-sub{my_sub_i}"), keep=2)
            loaded = ledger_ckpt.load_latest()
            if loaded is not None:
                try:
                    doc = json.loads(loaded[0].decode("utf-8"))
                    if doc.get("kind") == "tune-trials":
                        ledger = dict(doc.get("trials", {}))
                except ValueError:
                    ledger = {}

        def trial_key(ti, mi, pm):
            # the param map is part of the key: a changed search space must
            # re-run, not inherit a stale score
            return f"{ti}:" + json.dumps([mi, pm], sort_keys=True,
                                         default=str)

        policy = self.restart_policy
        if policy is None and int(self.get("trial_restarts") or 0) > 0:
            from ..resilience.supervisor import RestartPolicy

            policy = RestartPolicy(
                max_restarts=int(self.get("trial_restarts")))

        def run_folds(ti, mi, pm):
            scores = []
            for fi, (train_idx, valid_idx) in enumerate(folds):
                train, valid = table.gather(train_idx), table.gather(valid_idx)
                est = models[mi].copy(pm)
                if ckpt_dir:
                    _give_trial_checkpoints(est, os.path.join(
                        ckpt_dir, f"trial-{ti:04d}", f"fold-{fi}"))
                fitted = est.fit(train)
                scored = fitted.transform(valid)
                row = stats.transform(scored)
                if metric not in row:
                    raise KeyError(
                        f"metric {metric!r} not produced; have {row.columns}"
                    )
                scores.append(float(np.asarray(row[metric])[0]))
            return float(np.mean(scores))

        def run_trial_once(ti, mi, pm):
            if my_sub is None:
                return run_folds(ti, mi, pm)
            from ..parallel.mesh import use_mesh

            with use_mesh(my_sub):
                return run_folds(ti, mi, pm)

        def run_trial(args):
            from ..resilience.elastic import Preempted

            ti, (mi, pm) = args
            key = trial_key(ti, mi, pm)
            if key in ledger:
                _tune_record("tune.trial_skipped", trial=ti)
                return float(ledger[key])
            sess = policy.backoff.session() if policy is not None else None
            while True:
                try:
                    out = run_trial_once(ti, mi, pm)
                    break
                except Preempted:
                    raise   # the process is draining — completed trials are
                            # already durable in the ledger; do not retry
                except Exception as e:  # noqa: BLE001 — classified below
                    if (policy is None or policy.is_fatal(e)
                            or sess is None or not sess.should_retry()):
                        raise
                    _tune_record("tune.trial_retry", trial=ti,
                                 error=f"{type(e).__name__}: {e}")
                    sess.backoff()
            if ledger_ckpt is not None and (my_sub is None
                                            or my_sub.shard_index == 0):
                with ledger_lock:
                    ledger[key] = out
                    ledger_ckpt.save(
                        json.dumps({"kind": "tune-trials",
                                    "trials": ledger}).encode("utf-8"),
                        tag=f"trials-{len(ledger):04d}",
                        meta={"done": len(ledger), "total": len(trials)})
            return out

        if my_sub is None:
            with ThreadPoolExecutor(max_workers=self.get("parallelism")) as pool:
                results = list(pool.map(run_trial, enumerate(trials)))
        else:
            # the ranks of a submesh fit its trials together, in turn: two
            # fits at once would interleave their collectives on one group
            mine = {ti: run_trial((ti, trials[ti]))
                    for ti in range(my_sub_i, len(trials), n_sub)}
            results = _gather_scores(mine, len(trials))

        return self._pick_and_refit(table, models, trials, results, folds,
                                    maximize)

    def _fit_distributed(self, table: Table, models, trials,
                         metric: str) -> "TuneHyperparametersModel":
        """workers > 0: delegate to the preemptible sweep fleet. The
        winner comes back refit on the full table (sweep semantics:
        refit always happens — it IS the deployable artifact)."""
        from .sweep import SweepScheduler

        if not self.get("checkpoint_dir"):
            raise ValueError(
                "workers > 0 needs checkpoint_dir: the sweep spec, trial "
                "ledger, and per-(trial, rung, fold) sub-checkpoints are "
                "how preempted workers resume")
        sched = SweepScheduler(
            models, trials=trials,
            evaluation_metric=metric,
            label_col=self.get("label_col"),
            num_folds=int(self.get("num_folds")),
            seed=int(self.get("seed")),
            checkpoint_dir=self.get("checkpoint_dir"),
            workers=int(self.get("workers")),
            pruner=self.get("pruner"),
        )
        res = sched.run(table)
        out = TuneHyperparametersModel()
        out.best_model = res.best_model.best_model
        out.best_metric = res.best_metric
        out.best_params = dict(res.best_params)
        final = len(sched.pruner.rung_budgets()) - 1
        out.all_results = [
            {"model": mi, "params": pm,
             "metric": res.results.get(f"{ti}:{final}", float("nan"))}
            for ti, (mi, pm) in enumerate(sched.trials)
        ]
        out.sweep_result = res
        return out

    def _pick_and_refit(self, table, models, trials, results, folds,
                        maximize) -> "TuneHyperparametersModel":
        ckpt_dir = self.get("checkpoint_dir")

        best_i = int(np.argmax(results) if maximize else np.argmin(results))
        best_mi, best_pm = trials[best_i]
        refit_est = models[best_mi].copy(best_pm)
        if ckpt_dir:
            # the final fit resumes after a kill too
            _give_trial_checkpoints(
                refit_est, os.path.join(ckpt_dir, "refit"))
        if self.get("refit"):
            best_model = refit_est.fit(table)
        else:
            best_model = refit_est.fit(table.gather(folds[0][0]))
        out = TuneHyperparametersModel()
        out.best_model = best_model
        out.best_metric = results[best_i]
        out.best_params = dict(best_pm)
        out.all_results = [
            {"model": mi, "params": pm, "metric": r}
            for (mi, pm), r in zip(trials, results)
        ]
        return out


@register_stage
class TuneHyperparametersModel(Model):
    """Reference: TuneHyperparameters.scala:196+."""

    best_model: Transformer | None = None
    best_metric: float = float("nan")
    best_params: dict[str, Any] = {}
    all_results: list = []
    # set only by the distributed path (workers > 0): the full
    # automl.sweep.SweepResult, including the determinism digest,
    # pruning record, and worker lineage
    sweep_result: Any = None

    def _transform(self, table: Table) -> Table:
        return self.best_model.transform(table)

    def _save_state(self) -> dict[str, Any]:
        from ..core.serialize import stage_to_blob

        return {
            "best_model": stage_to_blob(self.best_model),
            "best_metric": self.best_metric,
            "best_params": {
                k: v for k, v in self.best_params.items()
                if isinstance(v, (int, float, str, bool, type(None)))
            },
        }

    def _load_state(self, state: dict[str, Any]) -> None:
        from ..core.serialize import stage_from_blob

        self.best_model = stage_from_blob(state["best_model"])
        self.best_metric = state.get("best_metric", float("nan"))
        self.best_params = state.get("best_params", {})


class DefaultHyperparams:
    """Per-learner default search spaces (DefaultHyperparams.scala)."""

    @staticmethod
    def gbdt_classifier() -> dict[str, Any]:
        return {
            "num_leaves": DiscreteHyperParam([15, 31, 63]),
            "learning_rate": RangeHyperParam(0.02, 0.3),
            "num_iterations": DiscreteHyperParam([50, 100, 200]),
            "min_data_in_leaf": DiscreteHyperParam([5, 20, 50]),
        }

    @staticmethod
    def dnn() -> dict[str, Any]:
        return {
            "learning_rate": RangeHyperParam(1e-4, 1e-2),
            "batch_size": DiscreteHyperParam([64, 128, 256]),
            "epochs": DiscreteHyperParam([5, 10, 20]),
        }
