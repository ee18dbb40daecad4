"""Each cell's run with its timed path broken underneath must come out
not correct: the harness's look for a card is skipped (the CPU and tiny
sizes stand in) and the rest of a run is driven as the benchmark drives
it. The faults a cell can have: a step that returns its state unchanged,
half of the batch left out, and an answer altered where it is produced
(no cell exchanges anything between cards)."""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests._tiny import SEED, TINY


def run(cell, extra=None):
    over = {k: dict(v) for k, v in TINY[cell].items()}
    for k, v in (extra or {}).items():
        over.setdefault(k, {}).update(v)
    result, _ = harness.run_cell(cell, SEED, 0.3, False, device="cpu", overrides=over)
    return result


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    assert run(cell)["correct"]


# ---- the GBDT fit ------------------------------------------------------- #

def _wrap_grow(monkeypatch, change):
    from mmlspark_tpu_torch.gbdt import fused

    make = fused.make_grow_fn

    def patched(*a, **k):
        grow = make(*a, **k)
        return lambda *g: change(*grow(*g))

    monkeypatch.setattr(fused, "make_grow_fn", patched)


def test_fit_round_that_leaves_the_margins_unchanged(monkeypatch):
    _wrap_grow(monkeypatch, lambda tree, rv, node: (tree, torch.zeros_like(rv), node))
    assert not run("higgs.fit")["correct"]


def test_fit_histograms_over_half_the_rows(monkeypatch):
    from mmlspark_tpu_torch.gbdt import engine

    hist = engine.histogram

    def half(bins, stats, num_bins):
        stats = stats.clone()
        stats[1::2] = 0
        return hist(bins, stats, num_bins)

    monkeypatch.setattr(engine, "histogram", half)
    assert not run("higgs.fit")["correct"]


def test_fit_leaf_value_altered(monkeypatch):
    def alter(tree, rv, node):
        leaf = int(torch.nonzero(tree.is_leaf)[0])
        value = tree.value.clone()
        value[leaf] *= 1.05
        return tree._replace(value=value), rv, node

    _wrap_grow(monkeypatch, alter)
    assert not run("higgs.fit")["correct"]


# ---- GBDT scoring ------------------------------------------------------- #

def test_score_walk_that_never_leaves_the_root(monkeypatch):
    from mmlspark_tpu_torch.gbdt.booster import Booster

    def stuck(self, trees, bins):
        return torch.full((bins.shape[0],), self.init_score, dtype=torch.float32,
                          device=bins.device)

    monkeypatch.setattr(Booster, "_walk", stuck)
    assert not run("higgs.score")["correct"]


def test_score_half_the_rows(monkeypatch):
    from mmlspark_tpu_torch.gbdt.booster import Booster

    predict = Booster.predict_raw

    def half(self, x, *a, **k):
        out = predict(self, x[::2], *a, **k)
        return np.repeat(out, 2)[:len(x)]

    monkeypatch.setattr(Booster, "predict_raw", half)
    assert not run("higgs.score")["correct"]


def test_score_answer_altered(monkeypatch):
    from mmlspark_tpu_torch.gbdt.booster import Booster

    predict = Booster.predict_raw

    def altered(self, x, *a, **k):
        out = predict(self, x, *a, **k).copy()
        out[0] += 1e-3
        return out

    monkeypatch.setattr(Booster, "predict_raw", altered)
    assert not run("higgs.score")["correct"]


# ---- the encoder -------------------------------------------------------- #

BERT = ["bert_base.score_512", "bert_base.score_128"]
ALL_ROWS = {"traffic": {"check_rows": 10 ** 6}}


@pytest.mark.parametrize("cell", BERT)
def test_encoder_attention_that_returns_the_state_unchanged(monkeypatch, cell):
    from mmlspark_tpu_torch.nn import attention

    monkeypatch.setattr(attention.SelfAttention, "forward", lambda self, x: torch.zeros_like(x))
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", BERT)
def test_encoder_half_the_minibatch(monkeypatch, cell):
    from mmlspark_tpu_torch.nn.runner import DeepModelTransformer

    forward = DeepModelTransformer._forward

    def half(self, model, fetches, x, mean, std):
        outs = forward(self, model, fetches, x[: max(len(x) // 2, 1)], mean, std)
        return tuple(torch.cat([o, o])[: len(x)] for o in outs)

    monkeypatch.setattr(DeepModelTransformer, "_forward", half)
    assert not run(cell, ALL_ROWS)["correct"]


@pytest.mark.parametrize("cell", BERT)
def test_encoder_logit_altered(monkeypatch, cell):
    from mmlspark_tpu_torch.nn.runner import DeepModelTransformer

    forward = DeepModelTransformer._forward

    def altered(self, model, fetches, x, mean, std):
        outs = list(forward(self, model, fetches, x, mean, std))
        outs[0] = outs[0].clone()
        outs[0][0, 0] += 0.05
        return tuple(outs)

    monkeypatch.setattr(DeepModelTransformer, "_forward", altered)
    assert not run(cell, ALL_ROWS)["correct"]
