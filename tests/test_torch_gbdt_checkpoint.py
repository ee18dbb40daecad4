"""Checkpointed, preemptible GBDT fits in the port (mmlspark_tpu_torch), on the
CPU: `checkpoint_dir` with `checkpoint_every_n` runs the boosting loop in
chunks of rounds with a snapshot after each, and a preempted fit resumes at
the newest verified snapshot.

The reference promises a resumed fit byte-identical to an uninterrupted
one (mmlspark_tpu/resilience/elastic.py:24-31). So tests/test_elastic.py's
GBDT cases (:334-413) run on the port with its own gate, `to_text()` equal
byte for byte; a resume re-derives the carried margins through
`predict_raw`, which must give the loop's f32 bits, so the preempted fits
cover multiclass and the renewed objectives too. One checkpointed fit of
the JAX package and the port's are held together by
`chip_smoke.compare_fits` as in tests/test_torch_gbdt_boosting.py, and the
JAX package's snapshots resume in the port.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core import kernels as jax_kernels  # noqa: E402
from mmlspark_tpu.gbdt.booster import Booster as JaxBooster  # noqa: E402
from mmlspark_tpu.gbdt.booster import TrainOptions as JaxOptions  # noqa: E402
from mmlspark_tpu_torch.core import Table  # noqa: E402
from mmlspark_tpu_torch.gbdt import GBDTClassifier  # noqa: E402
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions  # noqa: E402
from mmlspark_tpu_torch.resilience.elastic import (  # noqa: E402
    Preempted,
    PreemptionGuard,
    TrainingCheckpointer,
    set_active_guard,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


class TripGuard(PreemptionGuard):
    """Injectable preemption: drains after the Nth step-boundary poll."""

    def __init__(self, after: int, **kw):
        kw.setdefault("install", False)
        super().__init__(**kw)
        self.polls = 0
        self.after = after

    def should_checkpoint(self) -> bool:
        self.polls += 1
        if self.polls >= self.after:
            self.request_drain("test-trip")
        return super().should_checkpoint()


@pytest.fixture(autouse=True)
def _no_leaked_guard():
    yield
    set_active_guard(None)


def _gbdt_table(n=200, f=5, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)
    return Table({"features": x, "label": y})


@pytest.mark.parametrize("opts", [
    {},
    {"boosting_type": "goss"},
    {"boosting_type": "rf", "bagging_fraction": 0.7, "bagging_freq": 1},
    {"bagging_fraction": 0.8, "bagging_freq": 3},
], ids=["gbdt", "goss", "rf", "bagged"])
def test_chunked_equals_unchunked(tmp_path, opts):
    tbl = _gbdt_table()
    ref = GBDTClassifier(num_iterations=8, num_leaves=7, seed=3, device="cpu", **opts).fit(tbl)
    chunked = GBDTClassifier(num_iterations=8, num_leaves=7, seed=3, device="cpu",
                             checkpoint_dir=str(tmp_path / "ck"), checkpoint_every_n=3,
                             **opts).fit(tbl)
    assert chunked.booster.to_text() == ref.booster.to_text()
    # a snapshot after every chunk of 3: rounds 3, 6 and 8
    tags = [e["tag"] for e in TrainingCheckpointer(str(tmp_path / "ck")).entries()]
    assert tags == ["round-000003", "round-000006", "round-000008"]


def test_an_unaligned_period_is_aligned_to_the_bag(tmp_path):
    """checkpoint_every_n 4 under a bag renewed every 3 rounds runs chunks
    of 3: each chunk starts with a fresh bag, as the carried one lives only
    on the device."""
    tbl = _gbdt_table()
    kw = dict(num_iterations=10, num_leaves=7, seed=3, device="cpu", bagging_fraction=0.8,
              bagging_freq=3)
    x, y = np.asarray(tbl["features"]), np.asarray(tbl["label"])
    ref = Booster.train(x, y, TrainOptions(objective="binary", **kw))
    logs = []
    ck = str(tmp_path / "ck")
    got = Booster.train(x, y, TrainOptions(objective="binary", checkpoint_dir=ck,
                                           checkpoint_every_n=4, **kw), log=logs.append)
    tags = [e["tag"] for e in TrainingCheckpointer(ck).entries()]
    assert "checkpoint every 3 rounds" in logs
    assert tags == ["round-000006", "round-000009", "round-000010"]   # the newest 3 kept
    assert got.to_text() == ref.to_text()


def _preempted_then_resumed(tmp_path, make, x, y, trip=3):
    ck = str(tmp_path / "ck")
    set_active_guard(TripGuard(trip))
    with pytest.raises(Preempted) as ei:
        make(ck).fit(Table({"features": x, "label": y}))
    set_active_guard(None)
    assert ei.value.exit_code == 75
    assert os.path.dirname(ei.value.checkpoint_path) == ck
    return make(ck).fit(Table({"features": x, "label": y}))


def test_preempt_mid_fit_resume_byte_identical(tmp_path):
    tbl = _gbdt_table()
    ref = GBDTClassifier(num_iterations=10, num_leaves=7, seed=3, device="cpu").fit(tbl)

    def est(ck):
        return GBDTClassifier(num_iterations=10, num_leaves=7, seed=3, device="cpu",
                              checkpoint_dir=ck, checkpoint_every_n=2)

    resumed = _preempted_then_resumed(tmp_path, est, np.asarray(tbl["features"]),
                                      np.asarray(tbl["label"]))
    assert resumed.booster.to_text() == ref.booster.to_text()
    np.testing.assert_array_equal(np.asarray(resumed.transform(tbl)["probability"]),
                                  np.asarray(ref.transform(tbl)["probability"]))


def _regression(n=300, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    return x, 2.0 * x[:, 0] - x[:, 1] * x[:, 2] + 0.3 * rng.normal(size=n)


def _multiclass(n=180, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    return x, np.argmax(x[:, :3], axis=1).astype(np.float64)


# the carry after a resume: predict_raw's margins must be the loop's bits
# for (n, K) margins, for the renewed objectives, under goss, rf and bags,
# and at more rows than the host walk takes (the batched traversal)
RESUMED = {
    "binary": (lambda: (np.asarray(_gbdt_table()["features"]),
                        np.asarray(_gbdt_table()["label"])), dict(objective="binary")),
    "binary_traversal": (lambda: chip_smoke.make_dataset(900, 8), dict(objective="binary")),
    "multiclass": (_multiclass, dict(objective="multiclass", num_class=3)),
    "l1": (_regression, dict(objective="l1")),
    "quantile": (_regression, dict(objective="quantile", alpha=0.7)),
    "mape": (_regression, dict(objective="mape")),
    "goss": (_regression, dict(objective="regression", boosting_type="goss")),
    "rf": (_regression, dict(objective="regression", boosting_type="rf",
                             bagging_fraction=0.7, bagging_freq=1)),
    "bagged": (_regression, dict(objective="regression", bagging_fraction=0.8,
                                 bagging_freq=2, feature_fraction=0.8)),
    "multiclass_dart": (_multiclass, dict(objective="multiclass", num_class=3,
                                          boosting_type="dart")),
}


@pytest.mark.parametrize("case", sorted(RESUMED))
def test_preempted_fit_resumes_to_the_uninterrupted_trees(tmp_path, case):
    data, kw = RESUMED[case]
    x, y = data()
    kw = dict(num_iterations=8, num_leaves=7, seed=3, device="cpu", **kw)
    ref = Booster.train(x, y, TrainOptions(**kw))
    ck = str(tmp_path / "ck")
    opts = TrainOptions(checkpoint_dir=ck, checkpoint_every_n=2, **kw)
    set_active_guard(TripGuard(2))
    with pytest.raises(Preempted) as ei:
        Booster.train(x, y, opts)
    set_active_guard(None)
    assert ei.value.checkpoint_path.endswith("round-000004.bin")
    logs = []
    resumed = Booster.train(x, y, opts, log=logs.append)
    assert any(line.startswith("resumed from ckpt-00000001-round-000004.bin: 4 rounds")
               for line in logs), logs
    assert resumed.to_text() == ref.to_text()
    np.testing.assert_array_equal(resumed.predict_raw(x), ref.predict_raw(x))


def test_multiclass_chunked_equals_unchunked(tmp_path):
    x, y = _multiclass()
    tbl = Table({"features": x, "label": y})
    kw = dict(num_iterations=6, num_leaves=7, seed=2, objective="multiclass", device="cpu")
    ref = GBDTClassifier(**kw).fit(tbl)
    chunked = GBDTClassifier(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every_n=2,
                             **kw).fit(tbl)
    assert chunked.booster.to_text() == ref.booster.to_text()


def test_config_mismatch_ignores_checkpoint(tmp_path):
    tbl = _gbdt_table()
    ck = str(tmp_path / "ck")
    set_active_guard(TripGuard(2))
    with pytest.raises(Preempted):
        GBDTClassifier(num_iterations=10, num_leaves=7, seed=3, device="cpu",
                       checkpoint_dir=ck, checkpoint_every_n=2).fit(tbl)
    set_active_guard(None)
    x, y = np.asarray(tbl["features"]), np.asarray(tbl["label"])
    kw = dict(objective="binary", num_iterations=10, num_leaves=15, seed=3, device="cpu")
    logs = []
    got = Booster.train(x, y, TrainOptions(checkpoint_dir=ck, checkpoint_every_n=2, **kw),
                        log=logs.append)
    assert any("config mismatch" in line for line in logs), logs
    assert got.to_text() == Booster.train(x, y, TrainOptions(**kw)).to_text()


def test_a_finished_snapshot_is_the_fit(tmp_path):
    """Run again over a finished fit's snapshots, the fit grows nothing
    and returns the snapshot's model."""
    x, y = chip_smoke.make_dataset(300, 8)
    opts = TrainOptions(objective="binary", num_iterations=5, num_leaves=7, device="cpu",
                        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every_n=2)
    first = Booster.train(x, y, opts)
    logs = []
    again = Booster.train(x, y, opts, log=logs.append)
    assert again.to_text() == first.to_text()
    assert not any(line.startswith("boosting:") for line in logs), logs


def test_early_stopping_disables_checkpoints(tmp_path):
    x, y = chip_smoke.make_dataset(600, 8)
    ck = str(tmp_path / "ck")
    kw = dict(objective="binary", num_iterations=30, num_leaves=7, learning_rate=0.5,
              early_stopping_round=3, device="cpu")
    valid = (x[400:], y[400:])
    logs = []
    got = Booster.train(x[:400], y[:400], TrainOptions(checkpoint_dir=ck, checkpoint_every_n=2,
                                                       **kw), valid=valid, log=logs.append)
    assert any(line.startswith("checkpointing disabled") for line in logs), logs
    assert not os.path.exists(ck)
    ref = Booster.train(x[:400], y[:400], TrainOptions(**kw), valid=valid)
    assert got.to_text() == ref.to_text()


def test_single_class_dart_ignores_checkpoints(tmp_path):
    """The reference's single-class dart branch takes no checkpoints
    (booster.py:543-590); the port's neither."""
    x, y = chip_smoke.make_dataset(400, 8)
    ck = str(tmp_path / "ck")
    kw = dict(objective="binary", boosting_type="dart", num_iterations=6, num_leaves=7,
              seed=3, device="cpu")
    got = Booster.train(x, y, TrainOptions(checkpoint_dir=ck, checkpoint_every_n=2, **kw))
    assert not os.path.exists(ck)
    assert got.to_text() == Booster.train(x, y, TrainOptions(**kw)).to_text()


def test_checkpointed_fit_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    x, y = chip_smoke.make_dataset(100, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Booster.train(x, y, TrainOptions(objective="binary", num_iterations=4,
                                         checkpoint_dir=str(tmp_path / "ck"),
                                         checkpoint_every_n=2))
    assert not os.path.exists(str(tmp_path / "ck"))


def _loop(x, y, rounds, **spec_kw):
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.gbdt.engine import GrowConfig
    from mmlspark_tpu_torch.gbdt.fused import FusedTrainSpec, make_fused_train_fn
    from mmlspark_tpu_torch.gbdt.objectives import get_objective

    mapper = BinMapper().fit(x)
    nb = max(int(mapper.num_bins.max()), 2)
    fn = make_fused_train_fn(x.shape[1], nb, GrowConfig(num_leaves=7), mapper.num_bins,
                             np.zeros(x.shape[1], bool), get_objective("binary"),
                             FusedTrainSpec(num_rounds=rounds, **spec_kw), device="cpu")
    args = (torch.as_tensor(mapper.transform(x).astype(np.int32)),
            torch.as_tensor(y, dtype=torch.float32), torch.ones(len(y)))
    return fn, args


def test_round_offset_zero_gives_the_loops_trees_and_chunks_continue_them():
    x, y = chip_smoke.make_dataset(500, 8)
    spec = dict(bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8)
    whole, args = _loop(x, y, 6, **spec)
    pred0 = torch.zeros(len(y))
    t_all, p_all, _ = whole(*args, pred0, 7)
    t_zero, p_zero, _ = whole(*args, pred0, 7, round_offset=0)
    assert all(torch.equal(a, b) for a, b in zip(t_all, t_zero))
    assert torch.equal(p_all, p_zero)
    # rounds 0-3 then 4-5 from the carried margins: the same trees and bits
    first, _ = _loop(x, y, 4, **spec)
    rest, _ = _loop(x, y, 2, **spec)
    t_a, p_a, _ = first(*args, pred0, 7)
    t_b, p_b, _ = rest(*args, p_a, 7, round_offset=4)
    for field_all, field_a, field_b in zip(t_all, t_a, t_b):
        assert torch.equal(field_all, torch.cat([field_a, field_b]))
    assert torch.equal(p_all, p_b)
    # a chunk that would start inside a bag period has no bag to carry
    with pytest.raises(ValueError, match="bagging_freq"):
        rest(*args, p_a, 7, round_offset=3)


def _jax(fn):
    prior = jax_kernels.kernel_mode()
    try:
        jax_kernels.set_kernel_mode("xla")
        return fn()
    finally:
        jax_kernels.set_kernel_mode(prior)


def test_checkpointed_fit_matches_the_jax_packages_and_resumes_its_snapshots(tmp_path):
    """The JAX package's checkpointed fit and the port's grow the same
    trees; the port resumes from the JAX package's snapshots (the same
    file format, config and model text) and reads its final model."""
    x, y = chip_smoke.make_dataset(600, 8)
    kw = dict(objective="binary", num_iterations=8, num_leaves=7, seed=3,
              bagging_fraction=0.8, bagging_freq=3, checkpoint_every_n=3)
    jax_ck = str(tmp_path / "jax")
    ref = _jax(lambda: JaxBooster.train(x, y, JaxOptions(checkpoint_dir=jax_ck, **kw)))
    port = Booster.train(x, y, TrainOptions(device="cpu", checkpoint_dir=str(tmp_path / "port"),
                                            **kw))
    parity = chip_smoke.compare_fits(ref, port, ref.bin_mapper.transform(x))
    assert parity["trees_compared"] == ref.num_trees, parity["near_ties"]
    # every round is done in the JAX package's newest snapshot: resuming it
    # grows nothing and gives its model text
    logs = []
    resumed = Booster.train(x, y, TrainOptions(device="cpu", checkpoint_dir=jax_ck, **kw),
                            log=logs.append)
    assert any(line.startswith("resumed from") for line in logs), logs
    assert resumed.to_text() == ref.to_text()
