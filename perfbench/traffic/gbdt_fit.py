"""Driver of GBDT fits: one caller fits `GBDTClassifier` on one host
Table, fit after fit, each with its own binning (a user's fit pays for
it). The rows are the configuration's data set, made on the device from
the seed and handed to the program as host arrays.

The output check judges the window's last fit against the plain
reference (reference/gbdt.py): the bin boundaries, and the splits and
leaf values of its first `check_trees` trees, each at the margins the
fit's earlier trees give, as the reference works them out."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.inputs import data_module
from perfbench.reference import gbdt as ref

FIT_KEYS = ("num_iterations", "num_leaves", "max_bin", "learning_rate", "min_data_in_leaf",
            "min_sum_hessian_in_leaf", "bin_dtype", "device_binning",
            "bin_construct_sample_cnt", "objective")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.boosters: list = []
        self._ref_bins = None

    def estimator(self, rounds: int):
        from mmlspark_tpu_torch.gbdt.estimators import GBDTClassifier

        params = {k: self.cfg[k] for k in FIT_KEYS}
        params["num_iterations"] = rounds
        return GBDTClassifier(features_col="features", label_col="label", verbosity=0,
                              device=self.device, **params)

    def setup(self, warm: bool = True) -> None:
        from mmlspark_tpu_torch.core import Table

        x, y = data_module(self.cfg["data"]).make(self.cfg["rows"], self.seed, self.device)
        self.x = x.cpu().numpy()
        self.y = y.cpu().numpy().astype(np.float64)
        del x, y
        self.table = Table({"features": self.x, "label": self.y})
        if warm:
            self.estimator(self.traffic["warmup_rounds"]).fit(self.table)

    def call(self, i: int) -> dict:
        model = self.estimator(self.cfg["num_iterations"]).fit(self.table)
        self.boosters.append(model.booster)
        rounds = self.cfg["num_iterations"]
        return {"fits": 1, "row_rounds": len(self.y) * rounds,
                "split_steps": rounds * (self.cfg["num_leaves"] - 1)}

    def release(self) -> None:
        self.table = None

    def forest(self, booster) -> ref.Forest:
        return ref.Forest(booster.feature, booster.threshold_bin, booster.left, booster.right,
                          booster.value, booster.bin_mapper.upper_bounds, booster.init_score)

    def check(self, forest: ref.Forest | None = None) -> dict:
        forest = forest or self.forest(self.boosters[-1])
        trees = list(range(min(self.traffic["check_trees"], forest.feature.shape[0])))
        return ref.check_fit(self.x, self.y, forest, trees, self.cfg, self.device)

    def control(self) -> dict:
        """The reference itself, one step below float32 (bf16 gradients and
        hessians), in the program's place."""
        forest = ref.grow_fit(self.x, self.y, self.cfg, self.traffic["check_trees"],
                              self.device)
        return self.check(forest)

    def ref_bins(self) -> torch.Tensor:
        """The reference's bins of the rows, on the device (for counts)."""
        if self._ref_bins is None:
            bounds, nbins = ref.sketch(self.x, self.cfg["max_bin"],
                                       self.cfg["bin_construct_sample_cnt"])
            self._ref_bins = ref.bin_rows(torch.as_tensor(self.x, device=self.device),
                                          ref.snap_f32(bounds), nbins)
        return self._ref_bins
