"""Ranking evaluation + per-user split tuning.

Reference: src/recommendation/src/main/scala/ — `RankingEvaluator` /
`AdvancedRankingMetrics` (RankingEvaluator.scala:14-151: ndcgAt, map,
precisionAtk, recallAtK, diversityAtK, maxDiversity, mrr, fcp),
`RankingAdapter(Model)` (RankingAdapter.scala:66-151: wrap a recommender so
evaluators see (prediction, label) id lists), `RankingTrainValidationSplit`
(RankingTrainValidationSplit.scala:22-337: per-user stratified split :88+,
grid evaluation).

A copy of mmlspark_tpu/recommendation/ranking.py (host only): the metrics
are Python over id lists, as in the reference; the recommender a
`RankingAdapter` wraps runs on its own device.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from ..core.params import Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = [
    "ranking_metrics",
    "RankingEvaluator",
    "RankingAdapter",
    "RankingTrainValidationSplit",
]


def ranking_metrics(predictions: Iterable[Iterable[int]],
                    labels: Iterable[Iterable[int]],
                    k: int, n_items: int | None = None) -> dict[str, float]:
    """All metrics of AdvancedRankingMetrics (RankingEvaluator.scala:30-151)
    over per-user (predicted ids, relevant ids)."""
    preds = [list(p)[:k] for p in predictions]
    lab_lists = [list(l) for l in labels]
    users = [(p, ll, set(ll)) for p, ll in zip(preds, lab_lists) if ll]
    if not users:
        raise ValueError("no users with ground-truth items")

    precisions, recalls, ndcgs, aps, mrrs, fcps = [], [], [], [], [], []
    all_rec: set[int] = set()
    all_lab: set[int] = set()
    for p, ll, l in users:
        hits_mask = [1.0 if i in l else 0.0 for i in p]
        hits = sum(hits_mask)
        precisions.append(hits / k)
        # reference recallAtK divides by |predictions| (RankingEvaluator.scala)
        recalls.append(hits / max(len(p), 1))
        # ndcg@k
        dcg = sum(h / np.log2(r + 2) for r, h in enumerate(hits_mask))
        idcg = sum(1.0 / np.log2(r + 2) for r in range(min(len(l), k)))
        ndcgs.append(dcg / idcg if idcg > 0 else 0.0)
        # average precision, normalized by |labels| (Spark RankingMetrics)
        cum, ap = 0.0, 0.0
        for r, h in enumerate(hits_mask):
            if h:
                cum += 1.0
                ap += cum / (r + 1)
        aps.append(ap / len(l))
        # mrr
        rr = 0.0
        for r, h in enumerate(hits_mask):
            if h:
                rr = 1.0 / (r + 1)
                break
        mrrs.append(rr)
        # fcp: fraction of concordant pairs — for predicted items that both
        # appear in the label list, their predicted order must match the
        # label-list (relevance) order
        rank_of = {item: r for r, item in enumerate(ll)}
        both = [i for i in p if i in rank_of]
        pairs = concordant = 0
        for a in range(len(both)):
            for b_ in range(a + 1, len(both)):
                pairs += 1
                if rank_of[both[a]] < rank_of[both[b_]]:
                    concordant += 1
        fcps.append(concordant / pairs if pairs else 0.0)
        all_rec.update(i for i in p if i >= 0)
        all_lab.update(l)

    out = {
        "precisionAtk": float(np.mean(precisions)),
        "recallAtK": float(np.mean(recalls)),
        "ndcgAt": float(np.mean(ndcgs)),
        "map": float(np.mean(aps)),
        "mrr": float(np.mean(mrrs)),
        "fcp": float(np.mean(fcps)),
    }
    if n_items:
        out["diversityAtK"] = len(all_rec) / n_items
        out["maxDiversity"] = len(all_rec | all_lab) / n_items
    return out


@register_stage
class RankingEvaluator(Transformer):
    """Table{prediction: id lists, label: id lists} -> one-row metric table
    (RankingEvaluator.scala:14-151)."""

    k = Param(10, "cutoff", ptype=int)
    metric_name = Param("ndcgAt", "metric to report", ptype=str)
    prediction_col = Param("prediction", "recommended id list column", ptype=str)
    label_col = Param("label", "relevant id list column", ptype=str)
    n_items = Param(None, "item count (enables diversity metrics)", ptype=int)

    def evaluate(self, table: Table) -> float:
        m = ranking_metrics(
            table[self.get("prediction_col")], table[self.get("label_col")],
            self.get("k"), self.get("n_items"),
        )
        return m[self.get("metric_name")]

    def _transform(self, table: Table) -> Table:
        m = ranking_metrics(
            table[self.get("prediction_col")], table[self.get("label_col")],
            self.get("k"), self.get("n_items"),
        )
        return Table({name: np.asarray([v]) for name, v in m.items()})


@register_stage
class RankingAdapter(Estimator):
    """Wrap a recommender estimator so its output evaluates like a ranking
    problem (RankingAdapter.scala:66-151)."""

    recommender = Param(None, "estimator producing a SARModel-like model", required=True)
    k = Param(10, "recommendations per user", ptype=int)
    user_col = Param("user", "user id column", ptype=str)
    item_col = Param("item", "item id column", ptype=str)

    def _save_state(self):
        return {"recommender": self.get("recommender")}

    def _load_state(self, state):
        self.set(recommender=state["recommender"])

    def params_to_dict(self):
        d = dict(self._values)
        d.pop("recommender", None)
        return d

    def _fit(self, table: Table) -> "RankingAdapterModel":
        fitted = self.get("recommender").fit(table)
        m = RankingAdapterModel(
            k=self.get("k"), user_col=self.get("user_col"),
            item_col=self.get("item_col"),
        )
        m.recommender_model = fitted
        return m


@register_stage
class RankingAdapterModel(Model):
    k = Param(10, "recommendations per user", ptype=int)
    user_col = Param("user", "user id column", ptype=str)
    item_col = Param("item", "item id column", ptype=str)

    recommender_model: Any = None

    def _save_state(self):
        return {"recommender_model": self.recommender_model}

    def _load_state(self, state):
        self.recommender_model = state["recommender_model"]

    def _transform(self, table: Table) -> Table:
        """Test interactions -> per-user (prediction, label) id lists."""
        recs = self.recommender_model.recommend_for_all_users(self.get("k"))
        rec_map = {int(u): list(map(int, row)) for u, row in
                   zip(recs[self.get("user_col")], recs["recommendations"])}
        u = np.asarray(table[self.get("user_col")], np.int64)
        it = np.asarray(table[self.get("item_col")], np.int64)
        truth: dict[int, list[int]] = {}
        for uu, ii in zip(u, it):
            truth.setdefault(int(uu), []).append(int(ii))
        users = sorted(truth)
        return Table({
            self.get("user_col"): np.asarray(users, np.float64),
            "prediction": [rec_map.get(uu, []) for uu in users],
            "label": [truth[uu] for uu in users],
        })


@register_stage
class RankingTrainValidationSplit(Estimator):
    """Per-user stratified split + grid evaluation
    (RankingTrainValidationSplit.scala:22-337)."""

    recommender = Param(None, "recommender estimator", required=True)
    user_col = Param("user", "user id column", ptype=str)
    item_col = Param("item", "item id column", ptype=str)
    train_ratio = Param(0.75, "per-user train fraction", ptype=float)
    min_ratings_per_user = Param(1, "drop users with fewer events", ptype=int)
    k = Param(10, "evaluation cutoff", ptype=int)
    metric_name = Param("ndcgAt", "selection metric", ptype=str)
    param_maps = Param(None, "list of param dicts to evaluate (None = [{}])")
    seed = Param(0, "shuffle seed", ptype=int)

    def _save_state(self):
        return {"recommender": self.get("recommender")}

    def _load_state(self, state):
        self.set(recommender=state["recommender"])

    def params_to_dict(self):
        d = dict(self._values)
        d.pop("recommender", None)
        return d

    def split(self, table: Table) -> tuple[Table, Table]:
        """Per-user stratified split (:88+): each user's events split by
        train_ratio, preserving at least one event on each side when
        possible."""
        u = np.asarray(table[self.get("user_col")], np.int64)
        rng = np.random.default_rng(self.get("seed"))
        train_mask = np.zeros(len(u), bool)
        for uu in np.unique(u):
            idx = np.nonzero(u == uu)[0]
            if len(idx) < self.get("min_ratings_per_user"):
                continue
            perm = rng.permutation(idx)
            n_train = int(round(len(idx) * self.get("train_ratio")))
            n_train = min(max(n_train, 1), len(idx) - 1) if len(idx) > 1 else 1
            train_mask[perm[:n_train]] = True
        test_mask = ~train_mask
        # drop users entirely filtered out
        keep = np.zeros(len(u), bool)
        for uu in np.unique(u):
            idx = np.nonzero(u == uu)[0]
            if train_mask[idx].any():
                keep[idx] = True
        return (table.gather(np.nonzero(train_mask & keep)[0]),
                table.gather(np.nonzero(test_mask & keep)[0]))

    def _fit(self, table: Table) -> "RankingTrainValidationSplitModel":
        train, test = self.split(table)
        maps = self.get("param_maps") or [{}]
        evaluator = RankingEvaluator(
            k=self.get("k"), metric_name=self.get("metric_name"),
        )
        results = []
        for pm in maps:
            est = self.get("recommender").copy(pm)
            adapter = RankingAdapter(
                recommender=est, k=self.get("k"),
                user_col=self.get("user_col"), item_col=self.get("item_col"),
            ).fit(train)
            scored = adapter.transform(test)
            results.append(evaluator.evaluate(scored))
        best = int(np.argmax(results))
        model = RankingTrainValidationSplitModel()
        model.best_model = self.get("recommender").copy(maps[best]).fit(table)
        model.validation_metrics = results
        model.best_params = dict(maps[best])
        return model


@register_stage
class RankingTrainValidationSplitModel(Model):
    best_model: Any = None
    validation_metrics: list = []
    best_params: dict = {}

    def _save_state(self):
        return {"best_model": self.best_model,
                "validation_metrics": list(self.validation_metrics),
                "best_params": dict(self.best_params)}

    def _load_state(self, state):
        self.best_model = state["best_model"]
        self.validation_metrics = state["validation_metrics"]
        self.best_params = state["best_params"]

    def _transform(self, table: Table) -> Table:
        return self.best_model.transform(table)
