"""The port's hyperparameter search and model selection
(automl/tune.py, automl/find_best.py) held against the JAX package, on
the CPU.

The spaces draw the same param maps, `_kfold_indices` the same folds, and
`TuneHyperparameters` over `GBDTClassifier` scores the same trials and
picks the same best params as the JAX package's (a trial's score equal,
or within one validation row where the two fits part at a near-tied
split, the mirrored fault of ROADMAP.md Queue 3). Then the checksummed
trial ledger (a resumed search skips every finished trial and picks the
same model), `trial_restarts` through `RestartPolicy`, `trial_submeshes`
at 4 gloo ranks and 2 submeshes (tests/test_automl.py:204-275's cases;
each rank fits only its submesh's trials), and `FindBestModel` with its
NaN handling (tests/test_automl_sweep.py:154-183).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.automl import FindBestModel as JaxFindBest  # noqa: E402
from mmlspark_tpu.automl import TuneHyperparameters as JaxTune  # noqa: E402
from mmlspark_tpu.automl import tune as jax_tune  # noqa: E402
from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.gbdt import GBDTClassifier as JaxClassifier  # noqa: E402
from mmlspark_tpu_torch.automl import (DefaultHyperparams, DiscreteHyperParam,  # noqa: E402
                                       FindBestModel, GridSpace, HyperparamBuilder,
                                       RandomSpace, RangeHyperParam, TuneHyperparameters,
                                       TuneHyperparametersModel)
from mmlspark_tpu_torch.automl import tune  # noqa: E402
from mmlspark_tpu_torch.core.pipeline import PipelineStage  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassifier  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import test_torch_tune_jobs as jobs  # noqa: E402


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


def tune_data(n=300, seed=0):
    """tests/test_automl.py's mixed table, featurized by hand as there."""
    rng = np.random.default_rng(seed)
    num, num2 = rng.normal(size=n), rng.normal(size=n)
    cat = rng.choice(["a", "b", "c"], size=n)
    logits = num + (cat == "a") * 1.5 - (cat == "c") * 1.0
    y = (logits + rng.normal(scale=0.5, size=n) > 0).astype(np.float64)
    return {"features": np.stack([num, num2], 1), "label_idx": y}


def _spaces(pkg):
    return [pkg.GridSpace({"num_leaves": pkg.DiscreteHyperParam([7, 15]),
                           "num_iterations": pkg.DiscreteHyperParam([5])}),
            pkg.RandomSpace({"learning_rate": pkg.RangeHyperParam(0.05, 0.3),
                             "num_leaves": pkg.RangeHyperParam(4, 16, is_int=True),
                             "num_iterations": pkg.DiscreteHyperParam([4, 6])},
                            num_runs=4, seed=3)]


class TestSpaces:
    def test_param_maps_folds_and_json_match_the_jax_package(self):
        for p_space, j_space in zip(_spaces(tune), _spaces(jax_tune)):
            assert list(p_space.param_maps()) == list(j_space.param_maps())
            assert tune.space_to_json(p_space) == jax_tune.space_to_json(j_space)
            back = tune.space_from_json(jax_tune.space_to_json(j_space))
            assert list(back.param_maps()) == list(j_space.param_maps())
        for n, k, seed in [(300, 2, 0), (101, 3, 7), (64, 5, 1)]:
            for (pt, pv), (jt, jv) in zip(tune._kfold_indices(n, k, seed),
                                          jax_tune._kfold_indices(n, k, seed)):
                np.testing.assert_array_equal(pt, jt)
                np.testing.assert_array_equal(pv, jv)
        assert (tune.space_to_json(DefaultHyperparams.gbdt_classifier())
                == jax_tune.space_to_json(jax_tune.DefaultHyperparams.gbdt_classifier()))
        assert (tune.space_to_json(DefaultHyperparams.dnn())
                == jax_tune.space_to_json(jax_tune.DefaultHyperparams.dnn()))
        built = HyperparamBuilder().add_hyperparam("a", RangeHyperParam(0.0, 1.0)).build()
        maps = list(RandomSpace(dict(built, b=DiscreteHyperParam([1, 2])), 5, seed=3)
                    .param_maps())
        assert len(maps) == 5 and all(0 <= m["a"] <= 1 and m["b"] in (1, 2) for m in maps)


def _tuners(space_i: int, **kw):
    p = TuneHyperparameters(models=GBDTClassifier(label_col="label_idx", device="cpu"),
                            param_space=_spaces(tune)[space_i], label_col="label_idx",
                            num_folds=2, parallelism=2, evaluation_metric="accuracy", **kw)
    j = JaxTune(models=JaxClassifier(label_col="label_idx"),
                param_space=_spaces(jax_tune)[space_i], label_col="label_idx",
                num_folds=2, parallelism=2, evaluation_metric="accuracy", **kw)
    return p, j


class TestTuneHyperparameters:
    @pytest.mark.parametrize("space_i", [0, 1])
    def test_trials_scores_and_pick_match_the_jax_package(self, space_i):
        cols = tune_data()
        p, j = _tuners(space_i)
        pm = p.fit(Table(dict(cols)))
        jm = _jax(lambda: j.fit(JaxTable(dict(cols))))
        assert [r["params"] for r in pm.all_results] == [r["params"] for r in jm.all_results]
        one_row = 1.0 / (len(cols["label_idx"]) // 2)
        for pr, jr in zip(pm.all_results, jm.all_results):
            assert pr["metric"] == jr["metric"] or abs(pr["metric"] - jr["metric"]) <= one_row
        assert pm.best_params == jm.best_params
        assert 0.5 < pm.best_metric <= 1.0
        out = pm.transform(Table(dict(cols)))
        assert "prediction" in out.columns

    def test_ledger_resume_skips_every_trial_and_picks_the_same_model(self, tmp_path,
                                                                       monkeypatch):
        cols = tune_data(n=200, seed=2)
        ck = str(tmp_path / "sweep")
        p, _ = _tuners(0, checkpoint_dir=ck)
        first = p.fit(Table(dict(cols)))
        records = []
        monkeypatch.setattr(tune, "_tune_record",
                            lambda kind, **data: records.append((kind, data)))
        p2, _ = _tuners(0, checkpoint_dir=ck)
        again = p2.fit(Table(dict(cols)))
        assert sorted(d["trial"] for k, d in records if k == "tune.trial_skipped") == [0, 1]
        assert again.best_params == first.best_params
        assert again.best_metric == first.best_metric
        assert again.best_model.booster.to_text() == first.best_model.booster.to_text()

    def test_transient_failure_retried_by_policy(self):
        cols = tune_data(n=160, seed=2)
        fails = {"left": 1}

        class Flaky(GBDTClassifier):
            def _fit(self, table):
                if fails["left"] > 0:
                    fails["left"] -= 1
                    raise ConnectionError("transient worker loss")
                return super()._fit(table)

        res = TuneHyperparameters(
            models=Flaky(label_col="label_idx", num_iterations=4, seed=3, device="cpu"),
            label_col="label_idx", evaluation_metric="accuracy", num_folds=2,
            parallelism=1, seed=0, trial_restarts=2,
            param_space=GridSpace({"num_leaves": DiscreteHyperParam([4, 8])}),
        ).fit(Table(dict(cols)))
        assert fails["left"] == 0 and len(res.all_results) == 2

    def test_without_restarts_a_failure_surfaces(self):
        class Broken(GBDTClassifier):
            def _fit(self, table):
                raise ConnectionError("transient worker loss")

        with pytest.raises(ConnectionError):
            TuneHyperparameters(
                models=Broken(label_col="label_idx", device="cpu"), label_col="label_idx",
                evaluation_metric="accuracy", num_folds=2, parallelism=1,
                param_space=GridSpace({"num_leaves": DiscreteHyperParam([4])}),
            ).fit(Table(tune_data(n=80)))

    def test_all_metric_refused_and_model_roundtrip(self, tmp_path):
        with pytest.raises(ValueError, match="cannot rank"):
            TuneHyperparameters(models=GBDTClassifier(device="cpu"), evaluation_metric="all",
                                param_space=_spaces(tune)[0]).fit(Table(tune_data(n=60)))
        cols = tune_data(n=120)
        p, _ = _tuners(0)
        model = p.fit(Table(dict(cols)))
        model.save(str(tmp_path / "tuned"))
        back = PipelineStage.load(str(tmp_path / "tuned"))
        assert isinstance(back, TuneHyperparametersModel)
        assert back.best_params == model.best_params
        back.best_model.to("cpu")
        np.testing.assert_array_equal(
            np.asarray(back.transform(Table(dict(cols)))["prediction"]),
            np.asarray(model.transform(Table(dict(cols)))["prediction"]))


class TestSubmeshTrials:
    """Every rank calls fit; trial i runs on submesh i mod 2, fitted only by
    that submesh's two ranks; the ranks gather the scores and refit on the
    whole mesh of 4."""

    @pytest.fixture(scope="class")
    def pool(self):
        from mmlspark_tpu_torch.parallel.launch import RankPool

        with RankPool(4, "gloo", timeout_s=120.0) as p:
            yield p

    def test_trials_bind_disjoint_submeshes(self, pool):
        seen = pool.run(jobs.probe_submeshes, 2, deadline_s=120.0)
        for rank, meshes in enumerate(seen):
            trials, refit = meshes[:-1], meshes[-1]
            sub = (0, 1) if rank < 2 else (2, 3)
            mine = [1, 3] if rank < 2 else [2, 4]
            assert [m[0] for m in trials] == [sub] * 4       # 2 trials x 2 folds
            assert sorted({m[1] for m in trials}) == mine
            assert refit[0] == (0, 1, 2, 3)

    def test_submesh_tuning_end_to_end(self, pool, tmp_path):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(256, 5))
        y = (x[:, 0] > 0).astype(np.float64)
        outs = pool.run(jobs.tune_on_submeshes, x, y, 2, str(tmp_path / "ck"),
                        deadline_s=240.0)
        first = outs[0]
        for o in outs[1:]:
            assert o["best_params"] == first["best_params"]
            assert o["metrics"] == first["metrics"]
            assert o["text"] == first["text"]
            np.testing.assert_array_equal(o["prediction"], first["prediction"])
        assert first["best_metric"] > 0.8
        assert (first["prediction"] == y).mean() > 0.9
        # each submesh's first rank wrote its own trial ledger
        assert sorted(os.listdir(tmp_path / "ck")).count("_trials-sub0") == 1
        assert os.path.isdir(tmp_path / "ck" / "_trials-sub1")


class _ConstModel(PipelineStage):
    def __init__(self, value):
        self._v = float(value)
        self.calls = 0

    def transform(self, table):
        self.calls += 1
        return table.with_column("prediction", np.full(len(table), self._v, np.float64))


class TestFindBestModel:
    def test_picks_better_model_like_the_jax_package(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(400, 5))
        y = (x[:, 0] > 0).astype(np.float64)
        kw_good = dict(num_iterations=20, num_leaves=15)
        kw_bad = dict(num_iterations=1, num_leaves=2, learning_rate=0.001)
        t = Table({"features": x, "label": y})
        good = GBDTClassifier(device="cpu", **kw_good).fit(t)
        bad = GBDTClassifier(device="cpu", **kw_bad).fit(t)
        best = FindBestModel(models=[bad, good], evaluation_metric="accuracy").fit(t)
        assert best.best_model is good
        fpr, tpr, _ = best.get_roc_curve()
        assert fpr[0] == 0.0 and tpr[-1] == 1.0
        jt = JaxTable({"features": x, "label": y})
        jmodels = _jax(lambda: [JaxClassifier(**kw_bad).fit(jt), JaxClassifier(**kw_good).fit(jt)])
        jbest = _jax(lambda: JaxFindBest(models=jmodels, evaluation_metric="AUC").fit(jt))
        pbest = FindBestModel(models=[bad, good], evaluation_metric="AUC").fit(t)
        assert [bad, good].index(pbest.best_model) == jmodels.index(jbest.best_model)
        for pm, jm in zip(pbest.all_model_metrics, jbest.all_model_metrics):
            assert abs(float(pm["AUC"]) - float(jm["AUC"])) <= 1e-6
            assert float(pm["accuracy"]) == float(jm["accuracy"])

    def test_nan_model_skipped_with_warning(self):
        good, bad = _ConstModel(1.23), _ConstModel(float("nan"))
        t = Table({"x": np.zeros(8), "label": np.full(8, 1.23)})
        with pytest.warns(UserWarning, match="NaN"):
            best = FindBestModel(models=[bad, good],
                                 evaluation_metric="mean_squared_error").fit(t)
        assert best.best_model is good

    def test_all_nan_raises(self):
        t = Table({"x": np.zeros(8), "label": np.full(8, 1.23)})
        with pytest.raises(ValueError, match="NaN"):
            FindBestModel(models=[_ConstModel(float("nan")), _ConstModel(float("nan"))],
                          evaluation_metric="mean_squared_error").fit(t)

    def test_unknown_metric_rejected_before_scoring(self):
        m = _ConstModel(1.0)
        with pytest.raises(ValueError, match="not rankable"):
            FindBestModel(models=[m], evaluation_metric="acuracy").fit(
                Table({"x": np.zeros(8), "label": np.full(8, 1.23)}))
        assert m.calls == 0
