"""The benchmark's arithmetic on hand-worked shapes: roofline and `_mfu`
counts, node row counts, p95 over all calls, and the trace's busy time,
idle gaps and launch times."""

import math

import numpy as np
import pytest
import torch

from perfbench import counts, peaks
from perfbench.metrics import score_p95_ms
from perfbench.trace import Trace, short


def test_k1_bound_is_the_kernel_tables():
    # Higgs shape 1,048,576 x 28 uint8 at 3% kept: PERF.md's kernel table
    # gives 0.0040 ms (bytes) for B 256
    kept = 0.03 * 1_048_576
    s = counts.k1_launch_seconds(kept, 1_048_576, 28, 256)
    want = (kept * 28 + 1_048_576 * 12 + 28 * 256 * 12) / peaks.HBM_BYTES_PER_S
    assert s == pytest.approx(want) and s * 1e3 == pytest.approx(0.0040, rel=0.03)


def test_k2_bound_is_the_kernel_tables():
    # kernel table row bert_bf16: B 64, T 512, H 12, D 64: 0.0606 ms (bytes)
    assert counts.k2_launch_seconds(64, 512, 12, 64) * 1e3 == pytest.approx(0.0606, rel=0.01)
    # slice shape B 64, T 512, H 8, D 64: 0.0404 ms
    assert counts.k2_launch_seconds(64, 512, 8, 64) * 1e3 == pytest.approx(0.0404, rel=0.01)


def test_encoder_flops_by_hand():
    # BERT-base at T 512: 2 * 12 * (4 d^2 + 2 d ff + 2 T d) + head
    d, ff, t = 768, 3072, 512
    want = 2 * 12 * (4 * d * d + 2 * d * ff + 2 * t * d) + 2 * d * 2 / t
    assert counts.encoder_flops_per_token(12, d, ff, t, 2) == pytest.approx(want)
    assert 185e6 < want < 195e6


def test_fit_seconds_by_hand():
    rows, f, rounds, small = 1000, 4, 2, 1500.0
    want = (rows * f * 4 / peaks.PCIE_BYTES_PER_S
            + rows * f * 5 / peaks.HBM_BYTES_PER_S
            + rounds * rows * 28 / peaks.HBM_BYTES_PER_S
            + (small + rounds * rows) * (f + 12) / peaks.HBM_BYTES_PER_S)
    assert counts.fit_seconds(rows, f, rounds, small) == pytest.approx(want)


def test_score_seconds_by_hand():
    want = (100 * 3 * 4 + 100 * 4) / peaks.PCIE_BYTES_PER_S + (100 * 3 * 4 + 400) / \
        peaks.HBM_BYTES_PER_S
    assert counts.score_call_seconds(100, 3, 500) == pytest.approx(want)


def test_node_rows_and_smaller_children():
    # root splits feature 0 at bin 1; its right child (2) splits feature 1 at 0
    feature = np.array([0, -1, 1, -1, -1])
    thr = np.array([1, 0, 0, 0, 0])
    left = np.array([1, -1, 3, -1, -1])
    right = np.array([2, -1, 4, -1, -1])
    bins = torch.tensor([[0, 0], [1, 1], [2, 0], [3, 1], [2, 1]])
    cnt = counts.node_rows(feature, thr, left, right, bins)
    assert cnt.tolist() == [5, 2, 3, 1, 2]
    assert counts.smaller_child_rows(feature, left, right, cnt) == 2 + 1


def test_p95_counts_a_stall_and_every_call():
    calls = [0.1] * 99 + [5.0]
    assert score_p95_ms.p95(calls) == 0.1
    calls = [0.1] * 90 + [5.0] * 10
    assert score_p95_ms.p95(calls) == 5.0
    assert score_p95_ms.p95([0.2, math.inf]) == math.inf


def test_busy_is_the_union_and_gaps_are_named_by_what_ends_them():
    tr = Trace(0, 100, [("void k1<int>(P)", 10, 30, 1), ("void k2(P)", 20, 40, 2),
                        ("void k1<int>(P)", 60, 70, 3), ("Memcpy HtoD", 80, 90, 4)],
               runtime=[(1, 5)])
    assert tr.busy_s() == pytest.approx(50e-9)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(30e-9)]
    assert dict((n, v) for n, v in b["idle_gaps"]) == pytest.approx(
        {"before k1": 30e-9, "before Memcpy HtoD": 10e-9, "window end": 10e-9})
    assert tr.launch_ns(r"k1").tolist() == [5, 60] and tr.launch_ns(r"k2").tolist() == [20]
    assert tr.kernel_count(r"k1") == 2 and tr.kernel_seconds(r"k2") == pytest.approx(20e-9)
    assert short("void hist_kernel<unsigned char, false>(Params)") == "hist_kernel"
