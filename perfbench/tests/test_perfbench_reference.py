"""Each reference against the port on the CPU at a tiny size (the
program's readings within the cell's limits), and each control (the
reference one precision step below the configuration's, in the program's
place) outside them. On the card the same comparison runs at the cells'
own sizes (perfbench/calibrate.py)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.calibrate import readings
from perfbench.reference import bert, gbdt
from perfbench.tests._tiny import SEED, TINY

PB = Path(__file__).resolve().parents[1]


def limits(cell):
    return json.loads((PB / "workloads" / f"{cell}.json").read_text())["limits"]


def within(reading, lim):
    return all(reading[k] <= v for k, v in lim.items())


@pytest.mark.parametrize("cell", sorted(TINY))
def test_program_within_and_control_outside_the_limits(cell):
    calls = 1 if cell == "higgs.fit" else 2
    prog = readings(cell, SEED, calls, False, "cpu", TINY[cell])
    ctrl = readings(cell, SEED, calls, True, "cpu", TINY[cell])
    assert within(prog, limits(cell)), prog
    assert not within(ctrl, limits(cell)), ctrl


def test_encoder_reference_equals_a_dense_transformer():
    """The reference's attention and blocks against torch's own
    multi-head attention on the same weights."""
    cfg = {"num_layers": 1, "d_model": 16, "num_heads": 2, "d_ff": 32, "vocab_size": 20,
           "max_len": 8, "num_outputs": 2, "init_std": 0.3}
    from perfbench.inputs import encoder

    w = encoder.make_weights(cfg, 3, "cpu")
    ids = torch.randint(0, 20, (3, 8), generator=torch.Generator().manual_seed(1))
    got = bert.forward(w, cfg, ids)
    mha = torch.nn.MultiheadAttention(16, 2, batch_first=True)
    with torch.no_grad():
        mha.in_proj_weight.copy_(torch.cat([w[f"attn_0.{p}.weight"] for p in
                                            ("query", "key", "value")]))
        mha.in_proj_bias.copy_(torch.cat([w[f"attn_0.{p}.bias"] for p in
                                          ("query", "key", "value")]))
        mha.out_proj.weight.copy_(w["attn_0.out.weight"])
        mha.out_proj.bias.copy_(w["attn_0.out.bias"])
        ln = torch.nn.functional.layer_norm
        h = w["embed.weight"][ids] + w["pos_embed"][:8]
        x = ln(h, (16,), w["ln_attn_0.weight"], w["ln_attn_0.bias"], 1e-6)
        h = h + mha(x, x, x, need_weights=False)[0]
        x = ln(h, (16,), w["ln_mlp_0.weight"], w["ln_mlp_0.bias"], 1e-6)
        x = torch.nn.functional.gelu(x @ w["mlp_up_0.weight"].t() + w["mlp_up_0.bias"],
                                     approximate="tanh")
        h = h + x @ w["mlp_down_0.weight"].t() + w["mlp_down_0.bias"]
        pooled = ln(h, (16,), w["ln_final.weight"], w["ln_final.bias"], 1e-6).mean(1)
        want = pooled @ w["head.weight"].t() + w["head.bias"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fp8_control_rounds_every_product():
    a = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    exact = bert.f32_gemm(a, a)
    low = bert.fp8_gemm(a, a)
    assert 1e-3 < float((low - exact).abs().max() / exact.abs().max()) < 0.2


def test_grown_tree_judged_by_the_check_is_sound():
    """The reference grower at float64 grows what the check expects:
    nothing forgone, and leaf values equal to the float32 rounding of the
    margins the grower carries."""
    from perfbench.inputs import higgs

    cfg = {"max_bin": 63, "bin_construct_sample_cnt": 200000, "num_leaves": 7,
           "min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 5.0, "learning_rate": 0.1}
    x, y = higgs.make(5000, 9, "cpu")
    fo = gbdt.grow_fit(x.numpy(), y.numpy(), cfg, 2, "cpu", torch.float64, torch.float64)
    r = gbdt.check_fit(x.numpy(), y.numpy(), fo, [0, 1], cfg, "cpu")
    assert r["bounds_mismatch"] == 0 and r["split_share"] < 1e-9
    assert r["leaf_gap_w"] < 1e-6


def test_lgbm_walk_by_hand():
    from perfbench.inputs.lgbm_model import Trees

    # one tree: x0 <= 0.5 ? (x1 <= 2 ? leaf0 : leaf2) : leaf1
    trees = Trees(np.array([[0, 1]]), np.array([[0.5, 2.0]]), np.array([[1, ~0]]),
                  np.array([[~1, ~2]]), np.array([[1.0, 2.0, 3.0]]))
    x = torch.tensor([[0.4, 1.0], [0.4, 3.0], [0.6, 0.0], [0.5, 2.0]], dtype=torch.float64)
    assert gbdt.walk_lgbm(trees, x).tolist() == [1.0, 3.0, 2.0, 1.0]
