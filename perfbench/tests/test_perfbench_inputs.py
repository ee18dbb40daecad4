"""The Higgs generator's schema and seed determinism, and the LightGBM
model text the scoring cell writes, read back by the port's parser."""

import numpy as np
import torch

from perfbench.inputs import encoder, higgs, lgbm_model
from perfbench.reference import gbdt as ref


def test_higgs_schema():
    x, y = higgs.make(200_000, 2 ** 40 + 3, "cpu")
    assert x.shape == (200_000, 28) and x.dtype == torch.float32
    assert len(higgs.FEATURES) == 28 and higgs.FEATURES[-1] == "m_wwbb"
    assert (x[:, higgs.PT] > 0.26).all() and (x[:, higgs.MET] > 0).all()
    assert x[:, higgs.ETA].abs().max() <= 2.4 and x[:, higgs.PHI].abs().max() <= 1.7413
    for j in higgs.BTAG:
        assert set(torch.unique(x[:, j]).tolist()) == set(np.float32(higgs.BTAG_LEVELS))
    assert (x[:, 21:] > 0).all()
    assert 0.51 < float(y.mean()) < 0.55 and set(torch.unique(y).tolist()) == {0.0, 1.0}


def test_higgs_seed_determinism():
    a = higgs.make(1000, 12345678901, "cpu")
    b = higgs.make(1000, 12345678901, "cpu")
    c = higgs.make(1000, 12345678902, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


def test_encoder_weights_seeded_and_named():
    cfg = {"num_layers": 1, "d_model": 8, "num_heads": 2, "d_ff": 16, "vocab_size": 11,
           "max_len": 4, "num_outputs": 2, "init_std": 0.02}
    a = encoder.make_weights(cfg, 2 ** 35, "cpu")
    b = encoder.make_weights(cfg, 2 ** 35, "cpu")
    assert list(a) == [n for n, _ in encoder.param_spec(cfg)]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert abs(float(a["ln_attn_0.weight"].mean()) - 1) < 0.05
    assert float(a["mlp_up_0.weight"].std()) < 0.05


def test_lgbm_text_round_trip_through_the_port():
    from mmlspark_tpu_torch.gbdt.booster import Booster

    x, _ = higgs.make(4000, 77, "cpu")
    bounds = lgbm_model.boundaries(x.numpy(), 63)
    assert all(len(b) <= 62 for b in bounds) and len(bounds[higgs.BTAG[0]]) == 2
    trees = lgbm_model.random_trees(bounds, 3, 15, seed=5)
    text = lgbm_model.to_text(trees, list(higgs.FEATURES))
    booster = Booster.from_lightgbm_text(text, device="cpu")
    assert booster.num_trees == 3
    raw = booster.predict_raw(x.numpy().astype(np.float64), device="device")
    want = ref.walk_lgbm(trees, x.double()).numpy()
    np.testing.assert_allclose(raw, want, rtol=0, atol=1e-6)
    # every leaf of every tree is reachable: one split a new leaf
    assert (np.sort(np.concatenate([~trees.left_child[0][trees.left_child[0] < 0],
                                    ~trees.right_child[0][trees.right_child[0] < 0]]))
            == np.arange(15)).all()
