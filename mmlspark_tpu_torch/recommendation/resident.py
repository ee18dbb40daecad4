"""Device-resident SAR serving: pinned similarity, fused top-k scoring.

Counterpart of mmlspark_tpu/recommendation/resident.py. The GBDT hot path
(io_http/serving.py + core/fusion.ResidentExecutor) pins a fused segment's
params on the device once and scores request batches through one
captured program per bucket rung. This module puts the SAR recommender on
the same rails:

- `SARTopKScorer` wraps a fitted `SARModel` as a registered Transformer
  whose `device_kernel()` is one composition — gather the requested
  users' affinity rows, multiply into the device-pinned item-item
  similarity matrix (sar.py's `score_rows`), mask seen items, take the
  top-k in `lax.top_k`'s order (sar.py's `topk_desc`, a stable sort) —
  so the whole user-id -> recommendations computation is one CUDA graph
  per ladder rung on the card.
- `SARHotPath` specializes `_HotPath` for two output columns
  (recommendation ids + ratings per request) and counts its traffic
  under the `sar_resident` route label, so
  `mmlspark_tpu_serving_path_total{path="sar_resident"}` separates SAR
  traffic from GBDT's `resident` in one process's scrape.
- `serve_recommender` is the `serve_model` twin: full-ladder warmup
  gates /readyz, every rung's resident reply is byte-compared against
  the handler path before it may route (divergence disables the route,
  never changes answers), readback completes lag-1 async, and steady
  state captures nothing because the bucket ladder closes the shape set.

Every user's scores come from a product of `SCORE_ROWS` rows whatever
the batch, so the resident route, the handler path and
`SARModel.recommend_for_all_users` on the same device give the same
bytes for a user.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from ..core.fusion import DeviceKernel, fuse, _on_mesh
from ..core.kernels import resolve_device
from ..core.params import Param
from ..core.pipeline import Model, PipelineModel
from ..core.schema import Table
from ..core.serialize import register_stage
from ..io_http.schema import HTTPRequestData, HTTPResponseData, RequestDecoder, parse_request
from ..io_http.serving import ServingServer, _HotPath, _start_leading
from .sar import SARModel, score_rows, topk_desc

__all__ = ["SARTopKScorer", "SARHotPath", "serve_recommender", "topk_reply"]

# the two output columns every SAR scoring path produces, in reply order
TOPK_COLS = ("recommendations", "ratings")


@register_stage
class SARTopKScorer(Model):
    """Top-k recommendation scoring as a fusable pipeline stage.

    Consumes a `features` column of user ids — (n, 1) float, the
    RequestDecoder's output shape — and produces `recommendations`
    (int64 item ids, -1 for exhausted/invalid slots) and `ratings`
    (float64 scores, 0.0 on those slots), row-aligned with
    `SARModel.recommend_for_all_users`. The kernel is total over any
    float input: out-of-range or non-integral user ids yield all-(-1)
    rows instead of failing the batch, so padded/garbage rows can ride
    through the resident executor and the route contract stays
    byte-deterministic. `device` is where a bare `transform` scores (the
    model's); a fused segment scores on its own device."""

    user_col = Param("user", "request field carrying the user id", ptype=str)
    k = Param(10, "recommendations per user", ptype=int)
    remove_seen = Param(True, "mask items the user already interacted with",
                        ptype=bool)

    user_affinity: np.ndarray | None = None    # (U, I) float32
    item_similarity: np.ndarray | None = None  # (I, I) float32
    seen: np.ndarray | None = None             # (U, I) bool
    device: str = "cuda"

    _kernel: "DeviceKernel | None" = None
    _host_params = None

    @classmethod
    def from_model(cls, model: SARModel, k: int = 10,
                   remove_seen: bool = True) -> "SARTopKScorer":
        scorer = cls(user_col=model.get("user_col"), k=int(k),
                     remove_seen=bool(remove_seen))
        scorer.user_affinity = model.user_affinity
        scorer.item_similarity = model.item_similarity
        scorer.seen = model.seen
        scorer.device = model.device
        return scorer

    def device_kernel(self) -> "DeviceKernel | str":
        if self.user_affinity is None or self.item_similarity is None:
            return "scorer holds no fitted SAR state"
        if self._kernel is not None:
            return self._kernel
        n_users, n_items = self.user_affinity.shape
        k = min(int(self.get("k")), n_items)
        mask_seen = bool(self.get("remove_seen")) and self.seen is not None
        # host tensors: the fused segment moves them to its device once
        params = {"affinity": torch.as_tensor(self.user_affinity),
                  "similarity": torch.as_tensor(self.item_similarity)}
        if mask_seen:
            params["seen"] = torch.as_tensor(self.seen)

        def fn(p, cols):
            raw = cols["features"][:, 0]
            ids = raw.to(torch.int32)
            # total over any float payload: out-of-range / fractional /
            # NaN user ids score a clamped row but reply all-invalid
            valid = (ids >= 0) & (ids < n_users) & (raw == ids.to(raw.dtype))
            safe = ids.clamp(0, n_users - 1).long()
            scores = score_rows(p["affinity"].index_select(0, safe), p["similarity"])
            if mask_seen:
                scores = torch.where(p["seen"].index_select(0, safe), -torch.inf, scores)
            vals, idx = topk_desc(scores, k)
            # -inf slots = fewer than k unseen items, same convention as
            # SARModel.recommend_for_all_users
            bad = ~torch.isfinite(vals) | ~valid[:, None]
            return {"recommendations": torch.where(bad, -1, idx),
                    "ratings": torch.where(bad, 0.0, vals)}

        self._kernel = DeviceKernel(
            fn=fn,
            input_cols=("features",),
            output_cols=TOPK_COLS,
            params=params,
            name="SARTopKScorer",
            out_dtypes={"recommendations": np.int64, "ratings": np.float64},
            mesh_desc="rows P(data) / similarity+affinity replicated",
        )
        return self._kernel

    def _transform(self, table: Table) -> Table:
        """The same composition run eagerly on `device` (the fused path is
        the serving route; this keeps bare `transform` correct for staged
        pipelines and tests). User ids go up as float32, as a fused
        segment uploads them."""
        kern = self.device_kernel()
        if isinstance(kern, str):
            raise ValueError(kern)
        if "features" in table:
            feats = np.asarray(table["features"], np.float64)
        else:
            feats = np.asarray(table[self.get("user_col")],
                               np.float64).reshape(-1, 1)
        dev = resolve_device(self.device)
        if self._host_params is None or self._host_params[0] != dev:
            self._host_params = (dev, {name: t.to(dev) for name, t in kern.params.items()})
        with torch.no_grad():
            outs = kern.fn(self._host_params[1], {
                "features": torch.as_tensor(feats.astype(np.float32), device=dev)})
        result = table
        for c in kern.output_cols:
            arr = outs[c].cpu().numpy()
            want = kern.out_dtypes.get(c)
            if want is not None and arr.dtype != np.dtype(want):
                arr = arr.astype(want)
            result = result.with_column(c, arr)
        return result

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
        self._kernel = None
        self._host_params = None


def topk_reply(table: Table, reply_col: str = "reply") -> Table:
    """`make_reply` for the two-column top-k schema: one JSON body per row
    carrying both lists, byte-for-byte what `SARHotPath.replies_for`
    produces (tolist() -> Python ints/floats -> json.dumps)."""
    ids = np.asarray(table["recommendations"]).tolist()
    ratings = np.asarray(table["ratings"]).tolist()
    replies = [HTTPResponseData(
        status_code=200, reason="OK",
        headers={"Content-Type": "application/json"},
        entity=json.dumps(
            {"recommendations": i, "ratings": r}).encode(),
    ) for i, r in zip(ids, ratings)]
    return table.with_column(reply_col, replies)


class SARHotPath(_HotPath):
    """The SAR resident fast lane: same routing, warmup byte-compare, and
    readback machinery as the GBDT `_HotPath`, specialized for the
    two-column top-k reply and counted under its own route label."""

    resident_label = "sar_resident"

    def fetch_values(self, outs, n_valid: int, ledger=None):
        res = self.executor.fetch(outs, n_valid, ledger=ledger)
        return res["recommendations"], res["ratings"]

    def replies_for(self, vals, binary_mask=None
                    ) -> "list[HTTPResponseData]":
        # the two-column top-k reply stays JSON regardless of Accept —
        # binary negotiation covers single-value scoring replies only
        ids, ratings = vals
        return [HTTPResponseData(
            status_code=200, reason="OK",
            headers={"Content-Type": "application/json"},
            entity=json.dumps(
                {"recommendations": i, "ratings": r}).encode(),
        ) for i, r in zip(np.asarray(ids).tolist(),
                          np.asarray(ratings).tolist())]


def serve_recommender(
    model: SARModel,
    k: int = 10,
    remove_seen: bool = True,
    host: str = "127.0.0.1",
    port: int = 0,
    mesh=None,
    hot_path: bool = True,
    device: str = "cuda",
    **server_kw,
) -> "ServingServer | dict":
    """Deploy a fitted `SARModel`: JSON `{user: id}` in,
    `{recommendations: [...], ratings: [...]}` out.

    The similarity matrix and affinity table pin on `device` once inside
    the fused segment; the handler path and the resident route replay
    the SAME captured graph of a rung with the SAME pinned params
    (`_FusedSegment` shares them), so warmup's per-rung byte comparison
    holds by construction and any divergence disables the fast lane
    rather than changing answers. `serve_model(sar_model, ...)` delegates
    here. With `mesh` (several ranks) every rank calls it, as it calls
    `serve_model`: shard 0 serves, the others follow until it stops."""
    if model.user_affinity is None or model.item_similarity is None:
        raise ValueError("serve_recommender needs a fitted SARModel")
    scorer = SARTopKScorer.from_model(model, k=k, remove_seen=remove_seen)
    fused = fuse(PipelineModel([scorer]), mesh=mesh, device=device)
    led = _on_mesh(fused)
    if led is not None:
        # a mesh of several ranks: serve_model's split, shard 0 serving
        if led._effective_mesh().shard_index != 0:
            return led._follow()
        led._open_lead()
    user_col = model.get("user_col")
    # one decoder serves the handler fast path AND the resident route,
    # so the cached schema and its hit/fallback counts stay unified
    decoder = RequestDecoder([user_col])
    hp = None
    if hot_path:
        try:
            rex = fused.resident_executor()
        except Exception:  # noqa: BLE001 — the fast lane is strictly optional
            rex = None
        if rex is not None and not isinstance(rex, str) \
                and rex.upload_cols == ("features",):
            hp = SARHotPath(rex, decoder, "features", "recommendations",
                            readback_lag=fused.get("readback_lag"))

    def handler(table: Table) -> Table:
        reqs = list(table["request"])
        feats = decoder.decode(reqs)
        if feats is not None:
            scored = fused.transform(
                Table({"request": reqs, "features": feats}))
            return topk_reply(scored)
        t = parse_request(table)
        if user_col not in t:
            raise ValueError(f"request missing field {user_col!r}")
        t = t.with_column(
            "features",
            np.asarray(t[user_col], np.float64).reshape(-1, 1))
        return topk_reply(fused.transform(t))

    server_kw.setdefault("bucket_batches", True)
    # user id 0 always exists in a fitted model's id space, and 0.0 is
    # f32-exact — warmup captures and byte-verifies every ladder rung
    server_kw.setdefault("warmup_request",
                         HTTPRequestData.from_json("/", {user_col: 0}))
    if hp is not None:
        server_kw.setdefault("bucket_multiple_of", hp.executor.data_axis_size)
    return _start_leading(led, lambda: ServingServer(handler, host=host, port=port,
                                                     hot_path=hp, **server_kw))
