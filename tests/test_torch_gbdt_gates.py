"""The classifier quality gate of tests/benchmarks/test_gbdt_benchmarks.py:41-61
through the port on the CPU: chip_smoke.py's `boosting_gate` (the function
the smoke runs on the card) fits GBDTClassifier under gbdt, rf, dart and
goss with bagging_fraction 0.85 and seed 42 on each data set, and every
held-out accuracy must lie within the precision of the committed
tests/benchmarks/benchmarks_classifier.csv. One case a data set; the gate
reads the committed baselines and writes nothing.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("dataset", list(chip_smoke.GATE_SETS["classifier"]))
def test_classifier_gate_passes_on_cpu(dataset):
    rows = chip_smoke.boosting_gate("classifier", "cpu", [dataset])
    assert [r["name"] for r in rows] == [f"{dataset}_{b}" for b in ("gbdt", "rf", "dart", "goss")]
    bad = [r for r in rows if not r["within"]]
    assert not bad, bad
