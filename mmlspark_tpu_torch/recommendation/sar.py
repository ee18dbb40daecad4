"""SAR — Smart Adaptive Recommendations.

Counterpart of mmlspark_tpu/recommendation/sar.py. Reference:
src/recommendation/src/main/scala/SAR.scala:36-205 — user-item affinity
with time decay (:82-117: affinity = rating × 2^(-Δt_minutes /
(time_decay_coeff·24·60)), summed per (user, item)) and item-item
similarity from distinct-user co-occurrence with cooccurrence/jaccard/lift
normalization and a support threshold (:119-205); SARModel scoring
(SARModel.scala:95-130) = user-affinity × item-similarity matrix product +
top-k.

The affinity and the normalization are host numpy, as in the JAX package;
the co-occurrence `b.T @ b` of the distinct-occurrence matrix runs on the
fit's device (`device`, "cuda" by default). Its 0/1 float32 sums are exact
integers, so the similarity is the CPU's bit for bit on any device.
`SARModel` keeps its affinity, similarity and `seen` mask on its device
(`SARModel.device`, set by the fit; `to(device)` moves it) once and scores
there with `torch.matmul` (TF32 off, as everywhere in the port).

Two rules keep the device's answers independent of how users are batched:

- every score product runs in slices of `SCORE_ROWS` rows (the last one
  zero-padded), so each row's scores come from the same GEMM shape
  whatever the batch — the blocked `recommend_for_all_users`, one user's
  serving request and a 256-row serving batch give the same bits;
- `topk_desc` is `jax.lax.top_k`'s order: largest first, the lower index
  first among equal values (SAR scores tie often: 0.0 for items with no
  co-occurrence, -inf for seen ones). `torch.topk` promises no order among
  ties, so it is a stable descending sort and its first k.
"""

from __future__ import annotations

from datetime import datetime
from typing import Any

import numpy as np
import torch

from ..core.kernels import resolve_device
from ..core.params import Param
from ..core.pipeline import Estimator, Model
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["SAR", "SARModel", "topk_desc", "score_rows", "SCORE_ROWS"]

#: rows in one score product: every user's scores come from a GEMM of
#: this many rows, so they do not depend on how users were batched
SCORE_ROWS = 128


def score_rows(affinity_rows: torch.Tensor, similarity: torch.Tensor) -> torch.Tensor:
    """affinity_rows @ similarity in products of SCORE_ROWS rows each."""
    n = affinity_rows.shape[0]
    pad = (-n) % SCORE_ROWS
    if pad:
        affinity_rows = torch.cat(
            [affinity_rows, affinity_rows.new_zeros((pad, affinity_rows.shape[1]))])
    out = torch.cat([torch.matmul(part, similarity)
                     for part in affinity_rows.split(SCORE_ROWS)])
    return out[:n]


def topk_desc(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest values, largest
    first, equal values in ascending index order."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _to_minutes(values, fmt: str | None) -> np.ndarray:
    """Timestamps (epoch seconds, numpy datetimes, or strings with fmt) ->
    float minutes."""
    vals = list(values)
    if not vals:
        return np.zeros(0)
    v0 = vals[0]
    if isinstance(v0, (int, float, np.number)):
        return np.asarray(vals, np.float64) / 60.0
    if isinstance(v0, np.datetime64):
        return np.asarray(vals).astype("datetime64[s]").astype(np.float64) / 60.0
    fmt = fmt or "%Y-%m-%d %H:%M:%S"
    return np.asarray(
        [datetime.strptime(str(v), fmt).timestamp() for v in vals], np.float64
    ) / 60.0


@register_stage
class SAR(Estimator):
    """Reference params: SARParams (SAR.scala:39-56) + Spark ALS-style cols."""

    user_col = Param("user", "indexed user id column", ptype=str)
    item_col = Param("item", "indexed item id column", ptype=str)
    rating_col = Param(None, "rating column (optional)", ptype=str)
    time_col = Param(None, "activity timestamp column (optional)", ptype=str)
    similarity_function = Param("jaccard", "jaccard | lift | cooccurrence", ptype=str)
    support_threshold = Param(4, "min co-occurrence to keep a similarity", ptype=int)
    time_decay_coeff = Param(30, "half-life in days for affinity decay", ptype=int)
    start_time = Param(None, "reference time (default: max activity time)", ptype=str)
    activity_time_format = Param("%Y-%m-%d %H:%M:%S", "strptime format", ptype=str)
    start_time_format = Param("%Y-%m-%d %H:%M:%S", "strptime format", ptype=str)
    num_users = Param(None, "explicit user vocabulary size (default: max id + 1)",
                      ptype=int)
    num_items = Param(None, "explicit item vocabulary size (default: max id + 1)",
                      ptype=int)
    device = Param("cuda", "torch device of the co-occurrence product and of the "
                   "fitted model: cuda | cpu", ptype=str)

    def set_indexer_model(self, indexer_model) -> "SAR":
        """Wire vocabulary sizes from a fitted RecommendationIndexerModel so
        items/users with no interactions still exist in the model (reference
        SARModel operates on the indexer's full id space,
        RecommendationIndexer.scala:16-130)."""
        self.set(num_users=indexer_model.n_users, num_items=indexer_model.n_items)
        return self

    def _fit(self, table: Table) -> "SARModel":
        device = resolve_device(self.get("device"))
        u = np.asarray(table[self.get("user_col")], np.int64)
        it = np.asarray(table[self.get("item_col")], np.int64)
        if len(u) == 0 and not (self.get("num_users") and self.get("num_items")):
            raise ValueError(
                "cannot fit SAR on an empty table without explicit "
                "num_users/num_items"
            )
        max_u = int(u.max()) if len(u) else -1
        max_i = int(it.max()) if len(it) else -1
        n_users = self.get("num_users") or max_u + 1
        n_items = self.get("num_items") or max_i + 1
        if max_u >= n_users or max_i >= n_items:
            raise ValueError(
                f"interaction ids exceed declared vocab: max user {max_u} "
                f"(num_users={n_users}), max item {max_i} (num_items={n_items})"
            )

        # -- affinity weights (SAR.scala:82-117) ------------------------- #
        if self.get("rating_col") and self.get("rating_col") in table:
            w = np.asarray(table[self.get("rating_col")], np.float64)
        else:
            w = np.ones(len(u), np.float64)
        if self.get("time_col") and self.get("time_col") in table and len(u):
            t_min = _to_minutes(table[self.get("time_col")],
                                self.get("activity_time_format"))
            if self.get("start_time"):
                ref = datetime.strptime(
                    self.get("start_time"), self.get("start_time_format")
                ).timestamp() / 60.0
            else:
                ref = float(t_min.max())
            half_life_min = self.get("time_decay_coeff") * 24 * 60
            w = w * np.power(2.0, -(ref - t_min) / half_life_min)

        affinity = np.zeros((n_users, n_items), np.float64)
        np.add.at(affinity, (u, it), w)

        # -- item-item similarity (SAR.scala:119-205) -------------------- #
        occurrence = np.zeros((n_users, n_items), np.float32)
        occurrence[u, it] = 1.0  # distinct (user, item)
        b = torch.as_tensor(occurrence, device=device)
        # (I, I) on the device — the reference's breeze SparseMatrix product;
        # 0/1 sums in f32 are exact integers below 2^24 users
        cooccur = (b.T @ b).cpu().numpy().astype(np.float64)
        del b
        occ = np.diag(cooccur).copy()

        fn = self.get("similarity_function")
        with np.errstate(divide="ignore", invalid="ignore"):
            if fn == "jaccard":
                denom = occ[:, None] + occ[None, :] - cooccur
                sim = np.where(denom > 0, cooccur / denom, 0.0)
            elif fn == "lift":
                denom = occ[:, None] * occ[None, :]
                sim = np.where(denom > 0, cooccur / denom, 0.0)
            elif fn in ("cooccurrence", "cooccur"):
                sim = cooccur
            else:
                raise ValueError(f"unknown similarity_function {fn!r}")
        sim = np.where(cooccur >= self.get("support_threshold"), sim, 0.0)

        model = SARModel(
            user_col=self.get("user_col"), item_col=self.get("item_col"),
        )
        model.user_affinity = affinity.astype(np.float32)
        model.item_similarity = sim.astype(np.float32)
        model.seen = occurrence.astype(bool)
        model.device = str(device)
        return model


@register_stage
class SARModel(Model):
    """Scoring: affinity (U×I) @ similarity (I×I), top-k in `lax.top_k`'s
    order (reference SARModel.scala:95-130 BlockMatrix multiply + top-k
    udf). `device` is where the model scores: the fit's device, "cuda" for
    a model loaded from disk; `to(device)` moves it."""

    user_col = Param("user", "indexed user id column", ptype=str)
    item_col = Param("item", "indexed item id column", ptype=str)
    prediction_col = Param("prediction", "predicted affinity column", ptype=str)

    user_affinity: np.ndarray | None = None    # (U, I) float32
    item_similarity: np.ndarray | None = None  # (I, I) float32
    seen: np.ndarray | None = None             # (U, I) bool
    device: str = "cuda"

    # device copies of the host arrays, uploaded once and reused across
    # calls; None until first use and after _load_state / to()
    _device_cache: "dict[str, Any] | None" = None

    # rows per device block in recommend_for_all_users: bounds peak device
    # memory at block×I instead of U×I
    USER_BLOCK = 4096

    def to(self, device: str) -> "SARModel":
        """Score on `device` from now on (returns self)."""
        self.device = str(resolve_device(device))
        self.invalidate_device_cache()
        return self

    def _device_arrays(self) -> dict[str, Any]:
        if self._device_cache is None:
            dev = resolve_device(self.device)
            self._device_cache = {
                "affinity": torch.as_tensor(self.user_affinity, device=dev),
                "similarity": torch.as_tensor(self.item_similarity, device=dev),
                "seen": (torch.as_tensor(self.seen, device=dev)
                         if self.seen is not None else None),
            }
        return self._device_cache

    def invalidate_device_cache(self) -> None:
        self._device_cache = None

    def _transform(self, table: Table) -> Table:
        """Per (user, item) row: predicted affinity score. Gathers only the
        requested users' affinity rows — an (n_requested × I) product, never
        the full U×I score matrix."""
        u = np.asarray(table[self.get("user_col")], np.int64)
        it = np.asarray(table[self.get("item_col")], np.int64)
        n_u, n_i = self.user_affinity.shape
        valid = (u >= 0) & (u < n_u) & (it >= 0) & (it < n_i)
        pred = np.zeros(len(u), np.float64)
        if valid.any():
            dev = self._device_arrays()
            users, pos = np.unique(u[valid], return_inverse=True)
            sel = torch.as_tensor(users, device=dev["affinity"].device)
            with torch.no_grad():
                rows = score_rows(dev["affinity"].index_select(0, sel),
                                  dev["similarity"]).cpu().numpy()
            pred[valid] = rows[pos, it[valid]]
        return table.with_column(self.get("prediction_col"), pred)

    def recommend_for_all_users(self, k: int, remove_seen: bool = True,
                                user_block: int | None = None) -> Table:
        """Reference: SARModel.recommendForAllUsers (SARModel.scala:95-130).
        Returns Table{user, recommendations, ratings} with top-k item ids.

        Scores `user_block` users at a time so peak device memory is
        block×I rather than U×I; every row is scored by the same
        SCORE_ROWS-row product and the top-k is row-independent, so the
        blocked result is byte-identical to the single big product."""
        dev = self._device_arrays()
        n_users, n_items = self.user_affinity.shape
        k = min(k, n_items)
        block = user_block or self.USER_BLOCK
        mask_seen = remove_seen and dev["seen"] is not None
        vals_parts, idx_parts = [], []
        with torch.no_grad():
            for lo in range(0, n_users, block):
                hi = min(lo + block, n_users)
                scores = score_rows(dev["affinity"][lo:hi], dev["similarity"])
                if mask_seen:
                    scores = torch.where(dev["seen"][lo:hi], -torch.inf, scores)
                v, i = topk_desc(scores, k)
                vals_parts.append(v.cpu().numpy().astype(np.float64))
                idx_parts.append(i.cpu().numpy().astype(np.int64))
        vals = (np.concatenate(vals_parts) if vals_parts
                else np.zeros((0, k), np.float64))
        idx = (np.concatenate(idx_parts) if idx_parts
               else np.zeros((0, k), np.int64))
        # users with fewer than k unseen items: top_k still returns the
        # -inf (seen) entries — mark them invalid (id -1) instead of
        # leaking seen items back as 0-rated recommendations
        invalid = ~np.isfinite(vals)
        idx = np.where(invalid, -1, idx)
        vals = np.where(invalid, 0.0, vals)
        return Table({
            self.get("user_col"): np.arange(n_users, dtype=np.float64),
            "recommendations": idx,
            "ratings": vals,
        })

    def _save_state(self) -> dict[str, Any]:
        return {
            "user_affinity": self.user_affinity,
            "item_similarity": self.item_similarity,
            "seen": self.seen.astype(np.uint8) if self.seen is not None else None,
        }

    def _load_state(self, state: dict[str, Any]) -> None:
        self.user_affinity = np.asarray(state["user_affinity"], np.float32)
        self.item_similarity = np.asarray(state["item_similarity"], np.float32)
        seen = state.get("seen")
        self.seen = None if seen is None else np.asarray(seen, bool)
        self.invalidate_device_cache()
