"""The port's ranking metrics and stages (recommendation/ranking.py) and
`ComputeModelStatistics`'s ranking branch (automl/metrics.py) held
against the JAX package's at 1e-12, on tests/test_recommendation.py's
cases and seeded id lists. The recommenders are fitted on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.automl import ComputeModelStatistics as JaxStats  # noqa: E402
from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.recommendation import SAR as JaxSAR  # noqa: E402
from mmlspark_tpu.recommendation import RankingAdapter as JaxAdapter  # noqa: E402
from mmlspark_tpu.recommendation import RankingEvaluator as JaxEvaluator  # noqa: E402
from mmlspark_tpu.recommendation import RankingTrainValidationSplit as JaxTVS  # noqa: E402
from mmlspark_tpu.recommendation import ranking_metrics as jax_ranking_metrics  # noqa: E402
from mmlspark_tpu_torch.automl import ComputeModelStatistics  # noqa: E402
from mmlspark_tpu_torch.core.pipeline import PipelineStage  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.recommendation import (SAR, RankingAdapter, RankingEvaluator,  # noqa: E402
                                               RankingTrainValidationSplit, ranking_metrics)

TOL = 1e-12


def interactions(n_users=20, n_items=15, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        liked = [i for i in range(n_items) if i % 3 == u % 3]
        for i in rng.choice(liked, size=4, replace=True):
            rows.append((u, int(i), 1.0))
        rows.append((u, int(rng.integers(n_items)), 1.0))
    arr = np.asarray(rows, np.float64)
    return {"user": arr[:, 0], "item": arr[:, 1], "rating": arr[:, 2]}


def id_lists(n_users=40, n_items=30, seed=4):
    rng = np.random.default_rng(seed)
    preds = [list(rng.choice(n_items, size=int(rng.integers(1, 12)), replace=False))
             for _ in range(n_users)]
    labels = [list(rng.choice(n_items, size=int(rng.integers(0, 9)), replace=False))
              for _ in range(n_users)]
    labels[0] = []                  # a user without ground truth is skipped
    preds[1] = preds[1][:2] + [-1, -1]   # exhausted slots
    return preds, labels


def assert_same_metrics(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for name in a:
        assert abs(float(a[name]) - float(b[name])) <= TOL, (name, a[name], b[name])


class TestRankingMetrics:
    @pytest.mark.parametrize("k", [1, 3, 10])
    @pytest.mark.parametrize("n_items", [None, 30])
    def test_metrics_match_the_jax_package(self, k, n_items):
        preds, labels = id_lists()
        assert_same_metrics(ranking_metrics(preds, labels, k, n_items),
                            jax_ranking_metrics(preds, labels, k, n_items))

    def test_reference_cases(self):
        m = ranking_metrics([[1, 2, 3]], [[1, 2, 3]], k=3, n_items=10)
        assert m["ndcgAt"] == pytest.approx(1.0) and m["map"] == pytest.approx(1.0)
        assert m["precisionAtk"] == pytest.approx(1.0) and m["mrr"] == pytest.approx(1.0)
        m2 = ranking_metrics([[4, 5, 6]], [[1, 2, 3]], k=3)
        assert m2["ndcgAt"] == 0.0 and m2["mrr"] == 0.0
        first = ranking_metrics([[1, 9, 8]], [[1]], k=3)
        last = ranking_metrics([[9, 8, 1]], [[1]], k=3)
        assert first["ndcgAt"] > last["ndcgAt"] and first["mrr"] > last["mrr"]
        with pytest.raises(ValueError, match="no users"):
            ranking_metrics([[1]], [[]], k=1)


class TestComputeModelStatisticsRanking:
    @pytest.mark.parametrize("metric", ["ranking", "all"])
    def test_ranking_branch_matches_the_jax_package(self, metric):
        preds, labels = id_lists()
        rows = {"prediction": preds, "label": labels}
        p = ComputeModelStatistics(evaluation_metric=metric, k=5).transform(Table(dict(rows)))
        j = JaxStats(evaluation_metric=metric, k=5).transform(JaxTable(dict(rows)))
        assert p.columns == j.columns
        assert_same_metrics({c: np.asarray(p[c])[0] for c in p.columns},
                            {c: np.asarray(j[c])[0] for c in j.columns})

    def test_named_ranking_metric(self):
        preds, labels = id_lists()
        out = ComputeModelStatistics(evaluation_metric="ndcgAt", k=3).transform(
            Table({"prediction": preds, "label": labels}))
        assert abs(np.asarray(out["ndcgAt"])[0]
                   - jax_ranking_metrics(preds, labels, 3)["ndcgAt"]) <= TOL


class TestRankingStages:
    def test_adapter_and_evaluator_match_the_jax_package(self):
        cols = interactions()
        pm = RankingAdapter(recommender=SAR(support_threshold=1, device="cpu"), k=5).fit(
            Table(dict(cols)))
        jm = JaxAdapter(recommender=JaxSAR(support_threshold=1), k=5).fit(JaxTable(dict(cols)))
        ps, js = pm.transform(Table(dict(cols))), jm.transform(JaxTable(dict(cols)))
        assert [list(r) for r in ps["prediction"]] == [list(r) for r in js["prediction"]]
        assert [list(r) for r in ps["label"]] == [list(r) for r in js["label"]]
        for name in ("ndcgAt", "map", "precisionAtk", "recallAtK", "mrr", "fcp"):
            pv = RankingEvaluator(k=5, metric_name=name).evaluate(ps)
            jv = JaxEvaluator(k=5, metric_name=name).evaluate(js)
            assert abs(pv - jv) <= TOL and 0.0 <= pv <= 1.0
        row = RankingEvaluator(k=5, n_items=15).transform(ps)
        assert "diversityAtK" in row.columns and "ndcgAt" in row.columns
        stats = ComputeModelStatistics(k=5).transform(ps)     # auto-detected id lists
        assert abs(np.asarray(stats["ndcgAt"])[0]
                   - JaxEvaluator(k=5).evaluate(js)) <= TOL

    def test_train_validation_split_matches_the_jax_package(self):
        cols = interactions(n_users=30)
        maps = [{"similarity_function": "jaccard"}, {"similarity_function": "lift"}]
        ptvs = RankingTrainValidationSplit(recommender=SAR(support_threshold=1, device="cpu"),
                                           param_maps=maps, k=5)
        jtvs = JaxTVS(recommender=JaxSAR(support_threshold=1), param_maps=maps, k=5)
        ptr, pte = ptvs.split(Table(dict(cols)))
        jtr, jte = jtvs.split(JaxTable(dict(cols)))
        np.testing.assert_array_equal(np.asarray(ptr["item"]), np.asarray(jtr["item"]))
        np.testing.assert_array_equal(np.asarray(pte["user"]), np.asarray(jte["user"]))
        assert set(np.asarray(pte["user"], int)) <= set(np.asarray(ptr["user"], int))
        pm, jm = ptvs.fit(Table(dict(cols))), jtvs.fit(JaxTable(dict(cols)))
        assert len(pm.validation_metrics) == 2
        assert np.all(np.abs(np.asarray(pm.validation_metrics)
                             - np.asarray(jm.validation_metrics)) <= TOL)
        assert pm.best_params == jm.best_params
        assert "prediction" in pm.transform(Table(dict(cols))).columns

    def test_save_load_keeps_the_recommender(self, tmp_path):
        adapter = RankingAdapter(recommender=SAR(support_threshold=1, device="cpu"), k=4)
        adapter.save(str(tmp_path / "adapter"))
        back = PipelineStage.load(str(tmp_path / "adapter"))
        assert back.get("k") == 4
        assert back.get("recommender").get("support_threshold") == 1
