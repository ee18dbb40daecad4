"""Driver of GBDT batch scoring: one caller scores host Tables of rows
through `GBDTClassificationModel.transform`, call after call.

The model is made in set-up from the seed (inputs/lgbm_model.py): bin
boundaries sketched from a sample of rows at the configuration's
`max_bin`, random leaf-wise trees over them, written as LightGBM's
model.txt and loaded by `Booster.from_lightgbm_text`, the path by which
users score a LightGBM model. A pool of row tables, made on the device
from the seed, is scored in turn.

The output check walks the model's trees over the raw rows in float64
(reference/gbdt.py) for the calls drawn from the seed, and compares the
raw-prediction and probability columns."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.inputs import data_module, lgbm_model
from perfbench.reference import gbdt as ref


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.kept: dict = {}
        stride = int(traffic["check_every"])
        self.phase = int(np.random.default_rng([seed, 13]).integers(stride))
        self.stride = stride

    def setup(self, warm: bool = True) -> None:
        from mmlspark_tpu_torch.core import Table
        from mmlspark_tpu_torch.gbdt.booster import Booster
        from mmlspark_tpu_torch.gbdt.estimators import GBDTClassificationModel

        data = data_module(self.cfg["data"])
        t = self.traffic
        sample, _ = data.make(t["sketch_rows"], self.seed + 1, self.device)
        bounds = lgbm_model.boundaries(sample.cpu().numpy(), self.cfg["max_bin"])
        self.trees = lgbm_model.random_trees(bounds, self.cfg["num_iterations"],
                                             self.cfg["num_leaves"], self.seed)
        text = lgbm_model.to_text(self.trees, list(data.FEATURES))
        self.model = GBDTClassificationModel(features_col="features")
        self.model.booster = Booster.from_lightgbm_text(text, device=self.device)
        self.model.classes = np.array([0.0, 1.0])
        x, _ = data.make(t["rows"] * t["pool"], self.seed + 2, self.device)
        self.rows = x.view(t["pool"], t["rows"], -1).cpu().numpy()
        del x, sample
        self.pool = [Table({"features": r}) for r in self.rows]
        if warm:
            for _ in range(2):
                self.model.transform(self.pool[0])

    def call(self, i: int) -> dict:
        out = self.model.transform(self.pool[i % len(self.pool)])
        self.last = (i, out["raw_prediction"], out["probability"])
        if i % self.stride == self.phase:
            self.kept[i] = self.last[1:]
        return {"rows": self.traffic["rows"]}

    def release(self) -> None:
        if hasattr(self, "last"):
            i, raw, prob = self.last
            self.kept[i] = (raw, prob)
        self.model = None
        self.pool = None

    def check(self) -> dict:
        raw_gap = prob_gap = 0.0
        for i, (raw, prob) in self.kept.items():
            x = torch.as_tensor(self.rows[i % len(self.rows)], device=self.device)
            want = ref.walk_lgbm(self.trees, x).cpu().numpy()
            p = 1.0 / (1.0 + np.exp(-want))
            raw_gap = max(raw_gap, float(np.abs(raw - np.stack([-want, want], 1)).max()))
            prob_gap = max(prob_gap, float(np.abs(prob - np.stack([1 - p, p], 1)).max()))
        return {"raw_gap": raw_gap, "prob_gap": prob_gap}

    def control(self) -> dict:
        """The reference walk in bfloat16 (values, thresholds and sums) in
        the program's place."""
        for i in list(self.kept):
            x = torch.as_tensor(self.rows[i % len(self.rows)], device=self.device)
            raw = ref.walk_lgbm(self.trees, x, torch.bfloat16).double().cpu().numpy()
            p = 1.0 / (1.0 + np.exp(-raw))
            self.kept[i] = (np.stack([-raw, raw], 1), np.stack([1 - p, p], 1))
        return self.check()
