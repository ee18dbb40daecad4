"""Recommendation subsystem: SAR + ranking evaluation/tuning.

Counterpart of mmlspark_tpu/recommendation. Reference module replaced:
src/recommendation/ — `SAR`/`SARModel` (SAR.scala:36-205,
SARModel.scala:21-167), `RecommendationIndexer`
(RecommendationIndexer.scala:16-130), `RankingAdapter`
(RankingAdapter.scala:66-151), `RankingEvaluator`/`AdvancedRankingMetrics`
(RankingEvaluator.scala:14-151), `RankingTrainValidationSplit`
(RankingTrainValidationSplit.scala:22-337). SAR's products and top-k run
on the card ("cuda" by default); `serve_recommender` serves a fitted
`SARModel` from a fused, device-resident top-k segment.
"""

from .indexer import RecommendationIndexer, RecommendationIndexerModel
from .ranking import (RankingAdapter, RankingAdapterModel, RankingEvaluator,
                      RankingTrainValidationSplit, RankingTrainValidationSplitModel,
                      ranking_metrics)
from .resident import SARHotPath, SARTopKScorer, serve_recommender, topk_reply
from .sar import SAR, SARModel

__all__ = [
    "RecommendationIndexer",
    "RecommendationIndexerModel",
    "SAR",
    "SARModel",
    "SARTopKScorer",
    "SARHotPath",
    "RankingAdapter",
    "RankingAdapterModel",
    "RankingEvaluator",
    "RankingTrainValidationSplit",
    "RankingTrainValidationSplitModel",
    "ranking_metrics",
    "serve_recommender",
    "topk_reply",
]
