"""The regressor quality gate of tests/benchmarks/test_gbdt_benchmarks.py:63-84
through the port on the CPU (chip_smoke.py's `boosting_gate`, as the
classifier's in test_torch_gbdt_gates.py): held-out RMSE under gbdt, rf,
dart and goss within the precision of the committed
tests/benchmarks/benchmarks_regressor.csv, one case a data set. Also the
generators chip_smoke.py copies from tests/benchmarks/datasets.py (which
imports the JAX package) against the originals.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from benchmarks import datasets  # noqa: E402  (tests/benchmarks)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("dataset", list(chip_smoke.GATE_SETS["regressor"]))
def test_regressor_gate_passes_on_cpu(dataset):
    rows = chip_smoke.boosting_gate("regressor", "cpu", [dataset])
    assert [r["name"] for r in rows] == [f"{dataset}_{b}" for b in ("gbdt", "rf", "dart", "goss")]
    bad = [r for r in rows if not r["within"]]
    assert not bad, bad


@pytest.mark.parametrize("suite,name", [(s, n) for s in ("classifier", "regressor")
                                        for n in chip_smoke.GATE_SETS[s]])
def test_smoke_gate_generators_are_the_benchmark_generators(suite, name):
    want = (datasets.CLASSIFICATION if suite == "classifier" else datasets.REGRESSION)[name]()
    x, y = chip_smoke.GATE_SETS[suite][name]()
    assert np.array_equal(x, np.asarray(want["features"]))
    assert np.array_equal(y, np.asarray(want["label"]))
    assert y.dtype == np.float64
