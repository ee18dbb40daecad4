"""The port's serial hyperband sweep (automl/sweep.py, one worker process,
on the CPU) against the JAX package's on the same table and trials:
every (trial, rung) score equal or within one validation row, the same
trials pruned at each rung, the same survivors and the same pick.
tests/test_torch_sweep.py has the rest of the sweep's cases.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_sweep import make_scheduler, sweep_cols  # noqa: E402


def test_serial_sweep_prunes_and_picks_like_the_jax_package(tmp_path):
    port = make_scheduler(tmp_path / "port", workers=1).run(Table(sweep_cols()))
    ref = make_scheduler(tmp_path / "jax", workers=1, jax=True).run(JaxTable(sweep_cols()))
    assert sorted(port.results) == sorted(ref.results)
    one_row = 1.0 / 60          # a fold holds 60 validation rows
    for key, value in port.results.items():
        assert value == ref.results[key] or abs(value - ref.results[key]) <= one_row, key
    assert port.pruned == ref.pruned and sum(len(v) for v in port.pruned.values()) >= 1
    assert port.survivors == ref.survivors
    assert port.best_trial == ref.best_trial and port.best_params == ref.best_params
    assert [c["builds"] for c in port.worker_counters] == [1.0]
