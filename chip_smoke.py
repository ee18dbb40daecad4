#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mmlspark_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments, on a machine with one
H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout (`nvcc`, into
build/mmlspark_tpu_torch/), holds every kernel against its plain PyTorch
version on the card, drives the port's two main paths through the stages
a user calls — GBDTClassifier fit on the Adult-Census shape (32,768 rows x
14 features, 31 leaves, 100 rounds), then transform and
ComputeModelStatistics, the Higgs-shaped fit binned on the card and scored
by the fused bin -> traverse program, a 10-class fit on digits, the
regression objectives' quality gate through GBDTRegressor, the Adult fit
under bagged gbdt, goss, rf and dart, an early-stopped fit and its warm
start, the classifier and regressor quality gates, categorical fits at
the UCI Adult schema and at the Amazon Employee Access schema (max_bin
1023, K1 at 1,024 bins), the numeric Adult fit at max_bin 16383 (K1 at
16,384 bins); and
DeepModelTransformer serving 1,024 rows x 512 token ids through bench.py's
accelerator transformer (8 layers, d_model 512, 8 heads, vocab 16,384) with
attention_impl="flash", in bf16 and in f32, through two small bf16
transformers (head dims 16 and 8) and through a BERT-base-wide one (head
dim 192) — and shows through the kernels' launch counters that each path
ran on its kernel. It prints one JSON line per phase:

  env          torch/CUDA versions and the card (the nvidia-smi name and
               power limit also stand alone on the next line)
  build        nvcc seconds, and which libraries came from the cache
  ex2_rate     the card's issue rate of ex2.approx.f32 (tools/mma_rate.cu):
               K2's floor at small head dims, one exponential a score
  kernels      each kernel against its plain version at its path's
               shapes: errors, repeatability, median ms (CUDA events), the
               plain version's and one PyTorch library call's ms, and the
               bound (least time the card could take); K1 "histogram" at
               HIST_SHAPES, which take every launch branch of its wrapper
               (each row names its plan), with its host microseconds a
               call and an empty kernel launched as its plans are (the
               floor of a call timed this way); K2 "flash_attention" with
               the kernel path each shape took ("tf32x3", "wgmma", "mma"
               or "wide"), its achieved TFLOP/s, and its exponentials with
               their time at the measured ex2 rate
  slice_adult  the GBDT path: fit seconds, launches (must be 3,100),
               train accuracy > 0.7, held-out AUC > 0.75, and the card's
               scores equal to the host walk bit for bit
  profile_adult a 10-round Adult fit under torch.profiler: device kernel
               time by name against wall time
  slice_parity the same data, 10 rounds, fitted on "cpu" and on "cuda":
               equal trees, or trees that part only at printed near-ties
               (compared past a tie whose two splits route every row alike)
  slice_higgs  1,048,576 x 28, 63 leaves, uint8 bins binned on the card
               (device_binning), 5 rounds (315 launches); the host binning
               timed alone beside the card's; the card's, the CPU's and
               the host's bins of 65,536 rows equal
  slice_predict  the Higgs booster over its 1,048,576 rows through the
               fused bin -> traverse program (device_predict_fn), end to
               end and resident, equal bit for bit to predict_raw;
               predict_leaf and truncated(2) against the host walk
  slice_multiclass  GBDTClassifier on digits (1,347 rows fitted, 450
               held out, 10 classes, 30 rounds of 15 leaves: 4,500
               launches), accuracy against the JAX package's, card against
               host walk, CPU against card trees for 3 rounds
  slice_objectives  tests/benchmarks/test_gbdt_benchmarks.py:86-114's
               objectives gate through GBDTRegressor on the card (l1,
               huber, quantile, poisson, tweedie: 2,250 launches)
  slice_boosting  the Adult shape through GBDTClassifier under bagged
               gbdt (bagging 0.8 every round, feature fraction 0.8), goss,
               rf and dart: each fit's seconds, 3,100 launches, train
               accuracy > 0.7, held-out AUC > 0.75, card scores equal to
               the host walk; first, two rounds of each loop under sync
               debug mode "error" (nothing read back)
  slice_boosting_parity  the random draws (bag, goss, feature and drop
               keys of rounds 0, 1, 7, 99) at 32,768 and 1,048,576 rows on
               the card and the CPU, bit for bit; the Adult data fitted on
               "cpu" and "cuda" for 10 rounds under each boosting type:
               the bags, feature masks and drop sets the loops used
               (fused.round_hook) equal every round, GOSS's row weights up
               to the first parting tree; the card's trees meet
               compare_fits at 1e-5 through the CPU's row-order histogram
               and at 1e-4 through K1; a draw's host microseconds and
               device ms at both sizes; then the same two rules for l1,
               quantile and mape under bagged gbdt, goss and dart (10
               rounds on airfoil_like), early stopping of a multiclass and
               a regression fit (the same best round on both devices), and
               an rf warm start
  slice_early_stopping  GBDTClassifier on the Adult shape with
               validation_fraction 0.1, early_stopping_round 5, learning
               rate 0.5: best_iteration + 1 trees kept, the held-out loss
               from predict_raw(num_iteration=i) smallest at the best
               round, launches of exactly the rounds run; a warm start
               from its model_string keeps its trees first
  slice_gates  tests/benchmarks/test_gbdt_benchmarks.py:41-84 on the card:
               16 classifier and 12 regressor fits (gbdt, rf, dart, goss;
               bagging 0.85, seed 42), each within its precision of the
               committed CSVs (21,600 launches); the same fits on the CPU,
               their trees and the card's by compare_fits at 1e-4
  slice_categorical  UCI Adult's schema (6 numeric columns, 8 categorical
               at adult.names's cardinalities, "?" as NaN): 32,768 rows
               through GBDTClassifier(categorical_slot_indexes=...), 100
               rounds of 31 leaves (3,100 launches), held-out AUC > 0.75,
               accuracy > 0.7, card scores = the host walk, category
               subsets of many; sync-free rounds; 10 rounds CPU against card
  slice_high_cardinality  the Amazon Employee Access schema (9
               categorical columns, up to 7,518 categories): max_bin 1023
               with uint8 asked for (the reference's warning, int32 bins),
               K1 at 1,024 bins (3,100 launches), held-out AUC above a
               constant's, card = host walk; 10 rounds CPU against card,
               and the numeric Adult shape at max_bin 511 likewise
  slice_max_bin_16383  the numeric Adult shape at max_bin 16383: K1 at
               16,384 bins in bin ranges (3,100 launches), held-out AUC >
               0.75, accuracy > 0.7, card = host walk; 10 rounds CPU
               against card
  slice_transformer  the DNN path: tokens/s, K2 launches (must be 128,
               on "wgmma"), finite logits, probabilities summing to 1; the
               same 1,024 x 512 tokens served in f32 (128 launches on
               "tf32x3", f32 tokens/s); f32 flash against f32 dense on the
               card, card against CPU on 2 rows, bf16 against f32; 4 rows
               x 4,096 tokens (8 launches)
  small_transformer  1,024 rows x 512 tokens in bf16 through
               TransformerEncoder's default width (d_model 64, 4 heads of
               16) and the reference tests' width (d_model 32, 4 heads of
               8), 2 layers each: 32 K2 launches on "mma" in each of 400
               passes, tokens/s of all of them with their spread, and one
               pass profiled (device busy share, K2's share)
  serve_wide   1,024 rows x 512 tokens at minibatch 4 through a 2-layer
               TransformerEncoder of d_model 768 over 4 heads (D = 192) in
               bf16 and in f32, 5 timed passes each: 512 K2 launches a
               pass, all on "wgmma" in bf16 and on "wide" in f32; f32 card
               against CPU and flash against dense
  profile_transformer  4 minibatches under torch.profiler: K2's and the
               GEMMs' share of device time, device busy share
  stage_roundtrip  the serving stage saved and loaded through
               core.serialize serves the same logits
  slice_zoo    model_zoo/resnet20_digits.model on the card against the CPU

then the {"kernels": [...]} summary, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits nonzero; it also exits nonzero,
printing no result, without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import csv
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12        # f32 outside the tensor cores
H100_TF32_OPS_PER_S = 495e12      # dense TF32 tensor cores
HIST_BINS = 256


def emit(doc: dict) -> None:
    print(json.dumps(doc), flush=True)


def make_dataset(n: int, f: int, seed: int = 7):
    """Synthetic stand-in for Adult Census (copy of bench.py make_dataset):
    mixed informative numeric features, binary label with label noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[:, 3] = np.round(np.abs(x[:, 3]) * 5)          # discrete-ish columns
    x[:, 7] = np.round(np.abs(x[:, 7]) * 3)
    logits = (
        x[:, 0] - 0.7 * x[:, 1] + 0.4 * x[:, 2] * x[:, 4] + 0.2 * x[:, 3]
    )
    y = (logits + rng.normal(scale=0.8, size=n) > 0).astype(np.float64)
    return x, y


def make_dataset_wide(n: int, f: int, seed: int = 9):
    """The Higgs-shaped data set (copy of bench.py make_dataset_wide)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    logits = x[:, 0] - 0.6 * x[:, 1] + 0.3 * x[:, 2] * x[:, 3] + 0.2 * x[:, 4]
    y = (logits + rng.normal(scale=0.9, size=n) > 0).astype(np.float64)
    return x.astype(np.float64), y


# UCI Adult (adult.names): the 14 columns of adult.data in its order, the
# 8 categorical ones with their published cardinalities
ADULT_COLUMNS = ("age", "workclass", "fnlwgt", "education", "education-num", "marital-status",
                 "occupation", "relationship", "race", "sex", "capital-gain", "capital-loss",
                 "hours-per-week", "native-country")
ADULT_CATEGORIES = {"workclass": 8, "education": 16, "marital-status": 7, "occupation": 14,
                    "relationship": 6, "race": 5, "sex": 2, "native-country": 41}
ADULT_CATEGORICAL = tuple(ADULT_COLUMNS.index(c) for c in ADULT_CATEGORIES)


def _zipf_codes(rng, n: int, k: int, s: float) -> np.ndarray:
    """n rows of k categories: each category once (where n >= k, so the
    column has its full cardinality), the other rows Zipf-like (weight of
    rank r is 1 / r**s); ranks shuffled over the category ids 0..k-1."""
    p = 1.0 / np.arange(1, k + 1) ** s
    ranks = np.concatenate([np.arange(min(k, n)),
                            rng.choice(k, size=n - min(k, n), p=p / p.sum())])
    return rng.permutation(k)[rng.permutation(ranks)]


def make_adult_categorical(n: int, seed: int = 17):
    """A seeded stand-in for UCI Adult at its schema: age, fnlwgt,
    education-num, capital-gain, capital-loss and hours-per-week numeric,
    the 8 ADULT_CATEGORIES columns as category codes 0..k-1 (education-num
    follows education, as in the file), "?" (workclass, occupation,
    native-country) as NaN as the published file has them. Labels: a
    seeded logistic of numeric terms plus a per-category effect, ~24%
    positive as in the file."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, len(ADULT_COLUMNS)))
    col = ADULT_COLUMNS.index
    logit = np.zeros(n)
    for name, k in ADULT_CATEGORIES.items():
        codes = _zipf_codes(rng, n, k, 1.2)
        x[:, col(name)] = codes
        logit += rng.normal(scale=0.8, size=k)[codes]
    x[:, col("age")] = np.clip(np.round(rng.normal(38.6, 13.6, n)), 17, 90)
    x[:, col("fnlwgt")] = np.round(np.exp(rng.normal(np.log(178000.0), 0.5, n)))
    x[:, col("education-num")] = x[:, col("education")] + 1
    x[:, col("capital-gain")] = np.where(rng.random(n) < 0.08,
                                         np.round(np.exp(rng.normal(8.5, 1.0, n))), 0.0)
    x[:, col("capital-loss")] = np.where(rng.random(n) < 0.05,
                                         np.round(rng.normal(1870, 360, n)), 0.0)
    x[:, col("hours-per-week")] = np.clip(np.round(rng.normal(40.4, 12.3, n)), 1, 99)
    logit += (0.04 * (x[:, col("age")] - 38.6) + 0.3 * (x[:, col("education-num")] - 8.5)
              + 0.03 * (x[:, col("hours-per-week")] - 40.4)
              + 2.0 * (x[:, col("capital-gain")] > 0) + 1.0 * (x[:, col("capital-loss")] > 0))
    for name, share in (("workclass", 0.056), ("occupation", 0.057), ("native-country", 0.018)):
        x[rng.random(n) < share, col(name)] = np.nan
    z = logit + rng.logistic(size=n)
    y = (z > np.quantile(z, 0.76)).astype(np.float64)
    return x, y


# The Amazon Employee Access Challenge (Kaggle 2013) train.csv: 9
# categorical columns in its order and their published cardinalities
AMAZON_CATEGORIES = {"RESOURCE": 7518, "MGR_ID": 4243, "ROLE_ROLLUP_1": 128,
                     "ROLE_ROLLUP_2": 177, "ROLE_DEPTNAME": 449, "ROLE_TITLE": 343,
                     "ROLE_FAMILY_DESC": 2358, "ROLE_FAMILY": 67, "ROLE_CODE": 343}
AMAZON_ROWS = 32769


def make_amazon_access(n: int, seed: int = 19):
    """A seeded stand-in for the Amazon Employee Access Challenge's
    train.csv: the 9 AMAZON_CATEGORIES columns as large integer ids with
    Zipf-like frequencies (ROLE_CODE one to one with ROLE_TITLE, as in the
    file), and ACTION ~94% 1 from per-category effects."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, len(AMAZON_CATEGORIES)))
    logit = np.zeros(n)
    codes_of = {}
    for j, (name, k) in enumerate(AMAZON_CATEGORIES.items()):
        codes = codes_of["ROLE_TITLE"] if name == "ROLE_CODE" else _zipf_codes(rng, n, k, 1.05)
        codes_of[name] = codes
        x[:, j] = rng.choice(np.arange(1000, 400000), size=k, replace=False)[codes]
        if name != "ROLE_CODE":
            logit += rng.normal(scale=1.0, size=k)[codes]
    z = logit + rng.logistic(size=n)
    y = (z > np.quantile(z, 0.058)).astype(np.float64)
    return x, y


def median_ms(fn, reps: int = 30, warmup: int = 5, before=None) -> float:
    """Median device time of fn() over `reps` calls, each between two CUDA
    events; `before` runs outside the timed region. A sleep kernel holds
    the stream while the calls are queued, so the card runs them back to
    back and the events time the device work, not the host's launch gaps."""
    for _ in range(warmup):
        if before:
            before()
        fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(200_000_000)
    for _ in range(reps):
        if before:
            before()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def host_us_per_call(fn, reps: int = 200) -> float:
    """Host wall time of one call, launch overhead included (synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def host_enqueue_us(fn, reps: int = 200) -> float:
    """Host wall time of one call while a sleep kernel holds the stream:
    the wrapper's own cost (checks, plan, launch), with none of the
    device's time in it."""
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    print(smi, flush=True)
    return {"nvidia_smi": smi}


def phase_build() -> None:
    from mmlspark_tpu_torch.core import kernels

    # the microbenchmark builds beside the kernels, not after them
    with ThreadPoolExecutor(1) as pool:
        rate_lib = pool.submit(rate_lib_path)
        report = kernels.build()
        rate_lib.result()
    emit({"phase": "build", "nvcc_seconds": report["seconds"],
          "built": report["built"], "from_cache": report["cached"]})


def rate_lib_path() -> Path:
    """tools/mma_rate.cu (the issue rates of mma.sync and ex2) built with
    the port's flags into build/tools/, keyed on a hash of the source and
    the flags."""
    from mmlspark_tpu_torch.core import kernels

    src = ROOT / "tools" / "mma_rate.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(kernels.NVCC_FLAGS).encode())
    path = ROOT / "build" / "tools" / f"libmma_rate-{key.hexdigest()[:16]}.so"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


def rate_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(rate_lib_path()))
    lib.mma_rate.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
    lib.mma_rate.restype = ctypes.c_int
    return lib


EX2_MODE = 5            # tools/mma_rate.cu's "ex2" mode


def ex2_rate() -> dict:
    """The card's issue rate of ex2.approx.ftz.f32: tools/mma_rate.cu's
    "ex2" mode, 8 independent chains a thread at 32 warps an SM, timed with
    median_ms. Exponentials a second, for the floor of K2 where every score
    costs one."""
    lib = rate_lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, warps_per_sm, chains, iters = 256, 32, 8, 4096
    blocks = sms * warps_per_sm // (threads // 32)
    sink = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.mma_rate(EX2_MODE, chains, blocks, threads, iters, sink.data_ptr(), stream)
        if err:
            raise RuntimeError(f"the ex2 rate kernel failed: cudaError {err}")

    ms = median_ms(run, reps=10, warmup=2)
    n = blocks * threads * iters * chains
    return {"ex2_per_s": n / (ms * 1e-3), "ex2_per_s_per_sm": n / (ms * 1e-3) / sms,
            "ms": ms, "ex2": n, "sms": sms, "warps_per_sm": warps_per_sm, "chains": chains}


def phase_ex2_rate() -> dict:
    doc = {"phase": "ex2_rate", **ex2_rate()}
    emit(doc)
    return doc


def _hist_inputs(n: int, f: int, bin_dtype, mask_frac: float, seed: int,
                 quantized: bool = True, num_bins: int = HIST_BINS):
    """Bins uniform over num_bins values; binary-objective-like stats (grad in
    [-1, 1], hess in [0, 0.25], count 1) on the kept rows, zeros elsewhere.
    Quantized, grad and hess are multiples of 2**-10, so every partial sum
    is exact in f32 and any correct summation order gives the same bits:
    the check then isolates the kernel's indexing from rounding order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bins = torch.randint(0, num_bins, (n, f), generator=g, device="cuda").to(bin_dtype)
    mask = (torch.rand(n, generator=g, device="cuda") < mask_frac).float()
    grad = torch.rand(n, generator=g, device="cuda") * 2 - 1
    hess = torch.rand(n, generator=g, device="cuda") * 0.25
    if quantized:
        grad, hess = torch.round(grad * 1024) / 1024, torch.round(hess * 1024) / 1024
    stats = torch.stack([grad * mask, hess * mask, (mask > 0).float()], dim=-1).contiguous()
    return bins, stats


def _hist_f64(bins: torch.Tensor, stats: torch.Tensor, num_bins: int = HIST_BINS) -> torch.Tensor:
    """The histogram summed in float64: the exact value to within far less
    than f32 rounding, to grade f32 sums taken in different orders."""
    n, f = bins.shape
    ids = (bins.long() + torch.arange(f, device=bins.device) * num_bins).reshape(-1)
    out = torch.zeros((f * num_bins, 3), dtype=torch.float64, device=bins.device)
    out.index_add_(0, ids, stats.double()[:, None, :].expand(n, f, 3).reshape(-1, 3))
    return out.view(f, num_bins, 3)


# K1 against its plain version: (name, n, F, bin dtype, share of rows kept,
# B). The first five are the main path's shapes (the Adult fit's root and a
# deep node, the Higgs fit's root) and a ragged n; the rest take each
# other launch configuration `launch_plan` can choose (HIST_BRANCHES): one
# block along the rows (n 1 and 31, and 50 rows in feature groups), B = 2
# and 64, one histogram copy of 17 warps, a tile under 256 rows without a
# feature split (F = 48 int32), feature groups along grid_y (F = 100), and
# the Higgs grid with gathered rows (3% kept). Above 256 bins (int32 bins;
# max_bin 511 gives 512, 1023 gives 1024, 16383 gives 16,384): the Adult
# shape at B 512, 1024 and 4096 (with every row kept and 3%), a ragged n at
# 1024, the Amazon-access shape slice_high_cardinality fits (32,769 x 9 at
# 1024) and the Higgs shape at 1024, whose blocks own a feature group and
# all its bins ("split"); the Adult shape at 16,384 (slice_max_bin_16383's
# calls), whose blocks own a range of them ("ranges"), and at 65,536, one
# block along the rows of each range ("one_block")
HIST_SHAPES = [
    ("adult_int32", 32768, 14, torch.int32, 1.0, 256),
    ("adult_uint8", 32768, 14, torch.uint8, 1.0, 256),
    ("adult_int32_masked3pct", 32768, 14, torch.int32, 0.03, 256),
    ("ragged_int32", 10007, 14, torch.int32, 1.0, 256),
    ("higgs_uint8", 1 << 20, 28, torch.uint8, 1.0, 256),
    ("higgs_uint8_masked3pct", 1 << 20, 28, torch.uint8, 0.03, 256),
    ("n1_int32", 1, 14, torch.int32, 1.0, 256),
    ("n31_uint8_b16", 31, 5, torch.uint8, 1.0, 16),
    ("b2_uint8", 5000, 5, torch.uint8, 1.0, 2),
    ("b64_int32", 5000, 5, torch.int32, 1.0, 64),
    ("f17_int32", 20000, 17, torch.int32, 1.0, 256),
    ("f48_int32_tile64", 50000, 48, torch.int32, 1.0, 256),
    ("split_f100_int32", 50000, 100, torch.int32, 1.0, 256),
    ("split_f100_uint8", 50000, 100, torch.uint8, 1.0, 256),
    ("split_f100_one_block", 50, 100, torch.int32, 1.0, 256),
    ("adult_int32_b512", 32768, 14, torch.int32, 1.0, 512),
    ("adult_int32_b1024", 32768, 14, torch.int32, 1.0, 1024),
    ("ragged_int32_b1024", 10007, 14, torch.int32, 1.0, 1024),
    ("amazon_int32_b1024", 32769, 9, torch.int32, 1.0, 1024),
    ("higgs_int32_b1024", 1 << 20, 28, torch.int32, 1.0, 1024),
    ("adult_int32_b4096", 32768, 14, torch.int32, 1.0, 4096),
    ("adult_int32_b4096_masked3pct", 32768, 14, torch.int32, 0.03, 4096),
    ("adult_int32_b16384", 32768, 14, torch.int32, 1.0, 16384),
    ("adult_int32_b65536", 32768, 14, torch.int32, 1.0, 65536),
]
HIST_BRANCHES = ("rows", "capped", "one_block", "small_tile", "split")   # LaunchPlan.branch
HIST_WIDE_BRANCHES = ("split", "ranges", "one_block")   # the branches taken above 256 bins
HIST_GRAPH_SHAPE = "adult_int32_b16384"       # replayed in a CUDA graph too


def histogram_rows() -> list:
    from mmlspark_tpu_torch.gbdt.hist_kernel import device_plan, histogram, histogram_torch

    rows = []
    for i, (name, n, f, dt, frac, nb) in enumerate(HIST_SHAPES):
        bins, stats = _hist_inputs(n, f, dt, frac, seed=100 + i, num_bins=nb)
        plan = device_plan(n, f, nb, bins.element_size(), 0)
        first = histogram(bins, stats, nb)
        again = histogram(bins, stats, nb)
        plain = histogram_torch(bins, stats, nb)
        torch.cuda.synchronize()
        diff = (first - plain).abs()
        max_abs = diff.max().item()
        max_rel = (diff / plain.abs().clamp_min(1e-30)).max().item()
        same_bits = torch.equal(first, again)
        assert torch.allclose(first, plain, rtol=1e-5, atol=1e-5), (name, max_abs, max_rel)
        assert same_bits, f"{name}: two launches gave different bits"
        # unquantized stats: the kernel and the plain version (atomics in
        # no fixed order) round differently. Both are graded against the
        # float64 sum, relative to the bin's absolute mass sum(|stats|),
        # which bounds the rounding of any summation order
        _, fstats = _hist_inputs(n, f, dt, frac, seed=100 + i, quantized=False, num_bins=nb)
        exact = _hist_f64(bins, fstats, nb)
        mass = _hist_f64(bins, fstats.abs(), nb)
        fk, fp = histogram(bins, fstats, nb), histogram_torch(bins, fstats, nb)
        float_same_bits = torch.equal(fk, histogram(bins, fstats, nb))
        float_err = (fk - fp).abs().max().item()
        kernel_vs_mass = ((fk.double() - exact).abs() / mass.clamp_min(1e-30)).max().item()
        plain_vs_mass = ((fp.double() - exact).abs() / mass.clamp_min(1e-30)).max().item()
        assert kernel_vs_mass <= 1e-5, (name, kernel_vs_mass)
        assert float_same_bits, f"{name}: two launches on float stats gave different bits"
        del exact, mass, fk, fp

        kernel_ms = median_ms(lambda: histogram(bins, stats, nb))
        call_us = host_us_per_call(lambda: histogram(bins, stats, nb))
        enqueue_us = host_enqueue_us(lambda: histogram(bins, stats, nb))
        plain_ms = median_ms(lambda: histogram_torch(bins, stats, nb), reps=20)
        ids = (bins.long() + torch.arange(f, device="cuda") * nb).reshape(-1)
        data = stats[:, None, :].expand(n, f, 3).reshape(-1, 3)
        out = torch.zeros((f * nb, 3), device="cuda")
        library_ms = median_ms(lambda: out.index_add_(0, ids, data), reps=20,
                               before=out.zero_)
        # the least the function must move: every row's stats (to see which
        # rows are kept), the bins of the kept rows, the output once
        kept = int((stats != 0).any(dim=1).sum().item())
        bytes_moved = (kept * f * bins.element_size() + stats.numel() * 4
                       + f * nb * 3 * 4)
        ops = kept * f * 3
        bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
        ops_ms = ops / H100_F32_OPS_PER_S * 1e3
        rows.append({
            "shape": name, "n": n, "features": f, "bins": nb,
            "bin_dtype": str(dt).replace("torch.", ""), "rows_kept": frac,
            "rows_with_stats": kept, "branch": plan.branch, "plan": plan._asdict(),
            "max_abs_err": max_abs, "max_rel_err": max_rel, "same_bits": same_bits,
            "float_stats_max_abs_err": float_err,
            "float_stats_kernel_err_over_mass": kernel_vs_mass,
            "float_stats_plain_err_over_mass": plain_vs_mass,
            "ms": kernel_ms, "host_us_per_call": call_us, "host_enqueue_us": enqueue_us,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bytes": bytes_moved, "bound_ms": max(bytes_ms, ops_ms),
            "bound_us": max(bytes_ms, ops_ms) * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        if name == HIST_GRAPH_SHAPE:
            rows[-1]["graph_replays_eager_bits"] = _hist_graph_replays(bins, stats, nb)
        del bins, stats, first, again, plain, ids, data, out, fstats
    assert any(r.get("graph_replays_eager_bits") for r in rows), "no K1 shape replayed in a graph"
    missing = set(HIST_BRANCHES) - {r["branch"] for r in rows}
    assert not missing, f"no K1 shape took the launch branches {sorted(missing)}"
    missing = set(HIST_WIDE_BRANCHES) - {r["branch"] for r in rows if r["bins"] > 256}
    assert not missing, f"no K1 shape above 256 bins took the branches {sorted(missing)}"
    return rows


def _hist_graph_replays(bins: torch.Tensor, stats: torch.Tensor, nb: int) -> bool:
    """K1 captured in a CUDA graph, then replayed on new stats written into
    the captured input: each replay gives the eager call's bits."""
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    stats = stats.clone()
    histogram(bins, stats, nb)                     # warm-up: scratch on this stream
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = histogram(bins, stats, nb)
    equal = True
    for seed in (1, 2):
        g = torch.Generator(device="cuda").manual_seed(seed)
        fresh = torch.rand(stats.shape, generator=g, device="cuda") * 2 - 1
        stats.copy_(torch.round(fresh * 1024) / 1024)
        graph.replay()
        torch.cuda.synchronize()
        equal = equal and torch.equal(captured, histogram(bins, stats, nb))
    assert equal, "K1 replayed in a CUDA graph differs from the eager call"
    return equal


def hist_empty_launch_ms() -> dict:
    """The floor of one K1 call timed as median_ms times it: an empty
    kernel launched as the Adult shape's plan is (cooperatively, 64 blocks
    of 896 threads) and as a one-block plan is (plainly)."""
    from mmlspark_tpu_torch.gbdt.hist_kernel import _lib, _num_sms, launch_plan

    lib = _lib()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, plan in (("adult_plan", launch_plan(32768, 14, HIST_BINS, 4, _num_sms(0))),
                        ("one_block_plan", launch_plan(31, 14, HIST_BINS, 4, _num_sms(0)))):
        def run():
            err = lib.mmlspark_hist_empty(plan.grid_x, plan.grid_y, plan.threads, 0, stream)
            if err:
                raise RuntimeError(f"the empty kernel failed: cudaError {err}")
        out[label] = {"grid": [plan.grid_x, plan.grid_y], "threads": plan.threads,
                      "ms": median_ms(run)}
    return out


# K2 against its plain version: (name, B, Tq, Tk, H, D, dtype, causal).
# The slice shape is the serving transformer's attention (64 rows x 512
# tokens, 8 heads of 64); "masked" is tests/test_attention.py:120-132's
# construction; "no_keys" has Tk = 0, so every row has l == 0. d128 holds
# the wgmma path's other head dim; d32 and d8 (causal) the mma path at the
# reference tests' small widths and short ragged sequences, where the
# grid's fill sets the time. "default" is TransformerEncoder's own default
# width (d_model 64, 4 heads of 16; mmlspark_tpu/nn/models.py:177-178) at
# the slice's 64 rows x 512 tokens: the mma path at serving width;
# "serve_d8" the D = 8 small transformer's attention at the same rows and
# tokens. The mma path takes 8-warp blocks at default and serve_d8, 2-warp
# blocks at d32 and d8. "pad_d24" is a head dim K2 is not built for (a
# d_model 96 model over 4 heads): the wrapper pads it to 32 for "mma".
# The rows above head dim 128: d192 is serve_wide's attention
# (TransformerEncoder d_model 768 over 4 heads, the importers' default heads
# at BERT-base width) at 4 rows x 512 tokens, d256 the next such width
# (d_model 1,024) under a causal mask, pad_d160 a head dim between the
# built ones (wgmma at 192 reads its true 160 columns: no pad copy),
# d192_causal_ragged the TMA zero-fill of rows past T at B 2, T 1,000;
# bf16 runs them on "wgmma" (64-row items: too few 128-row ones to fill
# the card), f32 on "wide". d192_b16 has 256 items of 128 rows, so wgmma
# takes them with two consumer warpgroups. d320 (d_model 1,280 over 4
# heads) takes "wide" in both dtypes.
FLASH_SHAPES = [
    ("slice_bf16", 64, 512, 512, 8, 64, torch.bfloat16, False),
    ("slice_f32", 64, 512, 512, 8, 64, torch.float32, False),
    ("long_bf16", 4, 4096, 4096, 8, 64, torch.bfloat16, False),
    ("ragged_causal_bf16", 2, 1000, 1000, 8, 64, torch.bfloat16, True),
    ("d128_bf16", 8, 1024, 1024, 4, 128, torch.bfloat16, True),
    ("d32_bf16", 4, 300, 300, 4, 32, torch.bfloat16, False),
    ("d8_bf16", 4, 300, 300, 4, 8, torch.bfloat16, True),
    ("cross_f32", 1, 24, 40, 2, 16, torch.float32, False),
    ("masked_f32", 1, 4, 8, 1, 8, torch.float32, True),
    ("no_keys_f32", 1, 4, 0, 1, 8, torch.float32, True),
    ("default_f32", 64, 512, 512, 4, 16, torch.float32, False),
    ("default_bf16", 64, 512, 512, 4, 16, torch.bfloat16, False),
    ("serve_d8_bf16", 64, 512, 512, 4, 8, torch.bfloat16, False),
    ("pad_d24_bf16", 4, 300, 300, 4, 24, torch.bfloat16, False),
    ("d192_bf16", 4, 512, 512, 4, 192, torch.bfloat16, False),
    ("d192_f32", 4, 512, 512, 4, 192, torch.float32, False),
    ("d256_causal_bf16", 4, 512, 512, 4, 256, torch.bfloat16, True),
    ("d256_causal_f32", 4, 512, 512, 4, 256, torch.float32, True),
    ("pad_d160_bf16", 4, 512, 512, 4, 160, torch.bfloat16, False),
    ("d192_causal_ragged_bf16", 2, 1000, 1000, 4, 192, torch.bfloat16, True),
    ("d192_b16_bf16", 16, 512, 512, 4, 192, torch.bfloat16, False),
    ("d320_bf16", 4, 512, 512, 4, 320, torch.bfloat16, False),
    ("d320_f32", 4, 512, 512, 4, 320, torch.float32, False),
]


def flash_path(dtype, d: int) -> str:
    """The K2 kernel a (dtype, head dim) must take: f32 on 3xTF32 up to D
    128 and on the wide kernel above; bf16 on mma.sync up to D 32, on
    wgmma up to 256 (at 64, 128, 192 or 256) and on the wide kernel
    above."""
    if dtype == torch.float32:
        return "tf32x3" if d <= 128 else "wide"
    if d <= 32:
        return "mma"
    return "wgmma" if d <= 256 else "wide"


def flash_pads(dtype, d: int) -> bool:
    """Whether the wrapper copies q, k, v into zero-padded tensors first: up
    to D 128 for a D between the built ones (8, 16, 32, 64, 128); above,
    only where a row is no multiple of 16 bytes."""
    if d <= 128:
        return d not in (8, 16, 32, 64, 128)
    return d * (4 if dtype == torch.float32 else 2) % 16 != 0
# f32: the reference's own gate between attention tiers
# (tests/test_attention.py:56). bf16: the output is rounded to bf16 once,
# and p is rounded to bf16 before the PV product at a running max that
# may differ between the kernel's key tiles and the plain version's
# 128-key blocks, so the two may part by a bf16 ulp or two of the output:
# rtol 2**-7 is two ulps at the top of a binade, atol 2e-3 covers outputs
# near 0, whose ulp is smaller than that rounding noise. lse sums the
# unrounded p in f32 in both, so it keeps the f32 gate.
FLASH_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (2e-3, 2.0 ** -7)}
H100_BF16_OPS_PER_S = 989e12      # dense bf16 tensor cores


def _flash_inputs(name, b, tq, tk, h, d, dtype, seed):
    if name == "masked_f32":
        rng = np.random.default_rng(5)       # test_attention.py's _qkv(seed=5)
        qkv = [rng.normal(size=(b, t, h, d)) for t in (tq, tk, tk)]
        return [torch.tensor(a, dtype=dtype, device="cuda") for a in qkv]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype)
            for t in (tq, tk, tk)]


def flash_rows(ex2_per_s: "float | None" = None) -> list:
    """K2 against `flash_attention_torch` on the card at FLASH_SHAPES:
    the kernel path that ran (it must be `flash_path`'s), out and lse
    errors, the same bits on two launches, median ms beside the plain
    version's, F.scaled_dot_product_attention's (on pre-transposed
    (B, H, T, D), a yardstick the port never calls) and the bound; and the
    scores' exponentials, one a visible (query, key) pair, with their time
    at the card's ex2 rate (`ex2_rate`, measured here if not given)."""
    import torch.nn.functional as F

    from mmlspark_tpu_torch.nn.attention import (_flash_fwd_lse, flash_attention,
                                                 flash_attention_torch)

    if ex2_per_s is None:
        ex2_per_s = ex2_rate()["ex2_per_s"]
    rows = []
    with torch.no_grad():
        for i, (name, b, tq, tk, h, d, dt, causal) in enumerate(FLASH_SHAPES):
            q, k, v = _flash_inputs(name, b, tq, tk, h, d, dt, seed=200 + i)
            out, lse = _flash_fwd_lse(q, k, v, causal)
            path = flash_attention.last_path
            assert path == flash_path(dt, d), f"{name}: K2 ran {path}, want {flash_path(dt, d)}"
            # a padded launch returns a view of its wider output
            assert out.is_contiguous() != flash_pads(dt, d), \
                f"{name}: pad copy {not out.is_contiguous()}, want {flash_pads(dt, d)}"
            out2, lse2 = _flash_fwd_lse(q, k, v, causal)
            p_out, p_lse = flash_attention_torch(q, k, v, causal)
            torch.cuda.synchronize()
            same_bits = torch.equal(out, out2) and torch.equal(lse, lse2)
            err = (out.float() - p_out.float()).abs()
            max_abs = err.max().item() if err.numel() else 0.0
            max_rel = (err / p_out.float().abs().clamp_min(1e-30)).max().item() if err.numel() else 0.0
            inf_match = torch.equal(torch.isinf(lse), torch.isinf(p_lse))
            fin = torch.isfinite(p_lse)
            lse_err = (lse[fin] - p_lse[fin]).abs().max().item() if fin.any() else 0.0
            atol, rtol = FLASH_TOL[dt]
            assert same_bits, f"{name}: two launches gave different bits"
            assert inf_match, f"{name}: lse is +inf at other rows than the plain version's"
            torch.testing.assert_close(out.float(), p_out.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{name} out: {m}")
            torch.testing.assert_close(lse[fin], p_lse[fin], atol=2e-5, rtol=1e-5,
                                       msg=lambda m: f"{name} lse: {m}")
            kernel_ms = median_ms(lambda: _flash_fwd_lse(q, k, v, causal))
            plain_ms = median_ms(lambda: flash_attention_torch(q, k, v, causal), reps=10,
                                 warmup=2)
            library_ms = None
            if tk > 0:
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                library_ms = median_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal))
            # bytes: q, k, v read once, out and lse written once; operations:
            # two products of 2 * D per visible (query, key) pair. The least
            # time for f32-accurate products on this card is three TF32
            # products per product (3xTF32) on the tensor cores: the f32
            # rate outside them (67 TFLOP/s) is slower than 495 / 3
            bytes_moved = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size() \
                + lse.numel() * 4
            pairs = (sum(min(t + 1, tk) for t in range(tq)) if causal else tq * tk) * b * h
            ops = 4 * pairs * d
            bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
            if dt == torch.bfloat16:
                ops_ms = ops / H100_BF16_OPS_PER_S * 1e3
            else:
                ops_ms = 3 * ops / H100_TF32_OPS_PER_S * 1e3
            rows.append({
                "shape": name, "B": b, "Tq": tq, "Tk": tk, "H": h, "D": d,
                "dtype": str(dt).replace("torch.", ""), "causal": causal, "path": path,
                "max_abs_err": max_abs, "max_rel_err": max_rel, "lse_max_abs_err": lse_err,
                "atol": atol, "rtol": rtol, "same_bits": same_bits,
                "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bytes": bytes_moved, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "exps": pairs, "exp_ms": pairs / ex2_per_s * 1e3,
                "achieved_tflops": ops / (kernel_ms * 1e-3) / 1e12 if kernel_ms > 0 else None,
            })
            del q, k, v, out, out2, lse, lse2, p_out, p_lse
    return rows


def phase_kernels(ex2_per_s: float) -> dict:
    kern = {"histogram": histogram_rows(), "histogram_empty_launch": hist_empty_launch_ms(),
            "flash_attention": flash_rows(ex2_per_s)}
    emit({"phase": "kernels", **kern})
    return kern


def _table(x, y):
    from mmlspark_tpu_torch.core import Table

    return Table({"features": x, "label": y})


def _metrics(scored) -> dict:
    from mmlspark_tpu_torch.automl import ComputeModelStatistics

    row = ComputeModelStatistics(scored_labels_col="prediction").transform(scored)
    return {"accuracy": float(row["accuracy"][0]), "auc": float(row["AUC"][0])}


def _grow_one_tree_without_sync(x, y) -> None:
    """One tree on the card under sync debug mode "error": the split loop
    must not read anything back to the host."""
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.gbdt.engine import GrowConfig, make_grow_fn

    mapper = BinMapper(max_bin=255).fit(x)
    bins = torch.as_tensor(mapper.transform(x), device="cuda")
    nb = max(int(mapper.num_bins.max()), 2)
    grow = make_grow_fn(x.shape[1], nb, GrowConfig(num_leaves=31), mapper.num_bins,
                        np.zeros(x.shape[1], bool), device="cuda")
    yt = torch.as_tensor(y, dtype=torch.float32, device="cuda")
    p = torch.full_like(yt, float(y.mean()))
    ones = torch.ones_like(yt)
    fmask = torch.ones(x.shape[1], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grow(bins, p - yt, p * (1 - p), ones, fmask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def phase_slice_adult() -> dict:
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    n, n_valid, f, rounds, leaves = 32768, 8192, 14, 100, 31
    x_all, y_all = make_dataset(n + n_valid, f)
    x, y, xv, yv = x_all[:n], y_all[:n], x_all[n:], y_all[n:]
    _grow_one_tree_without_sync(x, y)
    GBDTClassifier(num_iterations=2, num_leaves=leaves, device="cuda").fit(_table(x, y))

    torch.cuda.synchronize()
    histogram.launches = 0
    t0 = time.perf_counter()
    model = GBDTClassifier(num_iterations=rounds, num_leaves=leaves, device="cuda").fit(_table(x, y))
    fit_s = time.perf_counter() - t0
    launches = histogram.launches
    t0 = time.perf_counter()
    scored_valid = model.transform(_table(xv, yv))
    transform_s = time.perf_counter() - t0
    scored_train = model.transform(_table(x, y))
    launches_after = histogram.launches

    assert model.booster.device.startswith("cuda"), model.booster.device
    assert launches == rounds * leaves, f"histogram launched {launches} times, want {rounds * leaves}"
    assert launches_after == launches, "scoring must not build histograms"
    train, valid = _metrics(scored_train), _metrics(scored_valid)
    assert train["accuracy"] > 0.7, train
    assert valid["auc"] > 0.75, valid
    raw_card = model.booster.predict_raw(xv, device="device")
    raw_host = model.booster.predict_raw(xv, device="host")
    assert raw_card.shape == (n_valid,) and np.isfinite(raw_card).all()
    assert np.array_equal(raw_card, raw_host), "card traversal differs from the host walk"
    doc = {"phase": "slice_adult", "rows": n, "features": f, "rounds": rounds,
           "num_leaves": leaves, "fit_seconds": fit_s, "train_rows_per_s": n / fit_s,
           "row_rounds_per_s": n * rounds / fit_s, "histogram_launches": launches,
           "transform_rows": n_valid, "transform_seconds": transform_s,
           "train_accuracy": train["accuracy"], "valid_auc": valid["auc"],
           "valid_accuracy": valid["accuracy"], "card_equals_host_walk": True}
    emit(doc)
    return doc


def phase_profile_adult() -> dict:
    """Where the Adult fit's time goes: a 10-round fit under torch.profiler,
    the device time of every kernel summed by name against the fit's wall
    time. The profiler slows the host, so the busy share it gives is a
    lower bound of the unprofiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions

    x, y = make_dataset(32768, 14)
    opts = TrainOptions(objective="binary", num_iterations=10, num_leaves=31, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        Booster.train(x, y, opts)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            by_name[e.key] = (by_name.get(e.key, (0.0, 0))[0] + e.self_device_time_total,
                              by_name.get(e.key, (0.0, 0))[1] + e.count)
    device_s = sum(us for us, _ in by_name.values()) / 1e6
    hist = {k: v for k, v in by_name.items() if "hist_" in k}
    hist_s = sum(us for us, _ in hist.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    doc = {"phase": "profile_adult", "rounds": 10, "num_leaves": 31,
           "wall_seconds_profiled": wall_s,
           "device_kernel_seconds": device_s if by_name else None,
           "device_busy_share": device_s / wall_s if by_name else None,
           "histogram_kernel_seconds": hist_s if by_name else None,
           # K1's kernels by name, against the split search's scan (cumsum)
           "histogram_kernels": [{"name": k[:80], "seconds": us / 1e6, "count": c}
                                 for k, (us, c) in hist.items()],
           "scan_seconds": sum(us for k, (us, _) in by_name.items() if "scan" in k) / 1e6,
           "kernel_launches": sum(c for _, c in by_name.values()),
           "top_kernels": [{"name": k[:80], "seconds": us / 1e6, "count": c}
                           for k, (us, c) in top]}
    emit(doc)
    return doc


def _goes_left(booster, t, node, col):
    """Whether rows at nodes `node` of tree t with bins `col` go left: by
    the node's bitset at a categorical node, else by `<=` its threshold."""
    bitset = booster.cat_bitset[t]
    return np.where(booster.is_categorical[t][node],
                    bitset[node, np.minimum(col, bitset.shape[-1] - 1)],
                    col <= booster.threshold_bin[t][node])


def _rows_at(booster, t, node, bins):
    """Rows whose walk through tree t passes `node`."""
    at = np.zeros(len(bins), np.int64)
    seen = at == node
    for _ in range(booster.feature.shape[1]):
        f = booster.feature[t][at]
        go_left = _goes_left(booster, t, at, bins[np.arange(len(bins)), np.maximum(f, 0)])
        at = np.where(f < 0, at, np.where(go_left, booster.left[t][at], booster.right[t][at]))
        seen |= at == node
    return seen


def _node_bitsets(booster, t, width: int):
    """Tree t's (M, width) category bitsets, zero-padded to `width`."""
    b = booster.cat_bitset[t]
    return np.pad(b, ((0, 0), (0, width - b.shape[-1])))


def compare_fits(cpu, card, bins=None, tol: float = 1e-5, gain_floor: float = 0.0,
                 order_ties: bool = False) -> dict:
    """CPU and card trees of one fit (or any two fits of one data set).
    Where they part, the two splits' gains must be a near-tie (within `tol`
    relative). A tie whose two splits send every training row of the
    node the same way (`bins`, the fit's bin matrix: two thresholds around
    a run of empty bins, or two features that part the node's rows alike)
    changes no row's route, so the comparison goes on; any other tie ends
    it before its tree. Leaf values of the trees before that: rtol `tol`,
    and an absolute floor of `tol` times the tree's largest leaf value. A
    right child's histogram is its parent's minus its sibling's, so a small
    leaf's gradient sum carries the f32 rounding of sums far larger than
    itself: its absolute error scales with the tree's values. The default
    1e-5 holds two fits whose histograms add rows in the same order (the
    port against the JAX package; a card fit through the CPU's histogram);
    K1 adds them in another (slice_boosting_parity). A categorical node
    parts where its flag or its bitset differs (the order of two categories
    whose grad/hess ratios differ by rounding flips across the prefix's
    end), and routes its rows by its bitset. `gain_floor`: a gap within
    gain_floor times the tree's largest gain is a tie too (a node of one
    class's rows has only splits of zero gain in exact arithmetic, whose
    f32 values, ~1e-6, no order ranks; and where a gain is a small
    difference of a node's large objective terms, the terms' rounding
    moves it by more than `tol` of itself). `order_ties`: a categorical
    node that splits the same feature with another bitset is a tie too,
    whatever its gain: categories whose grad/hess ratios are equal in
    exact arithmetic (rows of equal margins and counts) are ordered by
    the last bits of their sums, so the two fits scan other prefixes."""
    ties, upto = [], cpu.num_trees
    width = max(cpu.cat_bitset.shape[-1], card.cat_bitset.shape[-1])
    for t in range(cpu.num_trees):
        parted = {int(m) for name in ("feature", "threshold_bin", "left", "right",
                                      "is_categorical")
                  for m in np.nonzero(getattr(cpu, name)[t] != getattr(card, name)[t])[0]}
        parted |= {int(m) for m in np.nonzero(
            (_node_bitsets(cpu, t, width) != _node_bitsets(card, t, width)).any(-1))[0]}
        # in split order (a node's children are numbered when it splits):
        # the first tie that routes rows differently makes the later ones
        for m in sorted(parted, key=lambda m: min(
                int(c) for c in (cpu.left[t, m], card.left[t, m]) if c >= 0)):
            g_cpu, g_card = float(cpu.gain[t, m]), float(card.gain[t, m])
            rel = abs(g_cpu - g_card) / max(abs(g_cpu), abs(g_card), 1e-30)
            tie = {"tree": t, "node": m, "cpu_gain": g_cpu, "cuda_gain": g_card,
                   "relative_gap": rel}
            floor = gain_floor * float(np.max(np.abs(cpu.gain[t])))
            if (order_ties and cpu.is_categorical[t, m] and card.is_categorical[t, m]
                    and cpu.feature[t, m] == card.feature[t, m]):
                left_cpu, left_card = (_node_bitsets(b, t, width)[m] for b in (cpu, card))
                tie["order_tie"] = True
                tie["categories_only_cpu"] = int((left_cpu & ~left_card).sum())
                tie["categories_only_cuda"] = int((left_card & ~left_cpu).sum())
            assert rel <= tol or abs(g_cpu - g_card) <= floor or tie.get("order_tie"), \
                f"trees part at tree {t} node {m} without a near-tie: {tie}"
            tie["routes_alike"] = False
            if (bins is not None and cpu.feature[t, m] >= 0 and card.feature[t, m] >= 0
                    and cpu.left[t, m] == card.left[t, m]
                    and cpu.right[t, m] == card.right[t, m]):
                rows = bins[_rows_at(cpu, t, m, bins)]
                at = np.full(len(rows), m)
                tie["routes_alike"] = bool(np.array_equal(
                    _goes_left(cpu, t, at, rows[:, cpu.feature[t, m]]),
                    _goes_left(card, t, at, rows[:, card.feature[t, m]])))
            ties.append(tie)
            if not tie["routes_alike"]:
                upto = t
                break
        if upto < cpu.num_trees:
            break
    value_err, value_err_scaled = 0.0, 0.0
    for t in range(upto):
        scale = float(np.max(np.abs(cpu.value[t])))
        err = np.abs(card.value[t].astype(np.float64) - cpu.value[t])
        np.testing.assert_allclose(card.value[t], cpu.value[t], rtol=tol,
                                   atol=tol * scale, err_msg=f"tree {t}")
        value_err = max(value_err, float(err.max()))
        value_err_scaled = max(value_err_scaled, float(err.max()) / max(scale, 1e-30))
    return {"trees_equal": not ties, "trees_compared": upto, "near_ties": ties,
            "max_value_abs_err": value_err, "max_value_err_over_tree_max": value_err_scaled}


def phase_slice_parity() -> dict:
    from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions

    x, y = make_dataset(32768, 14)
    fits = {}
    for device in ("cpu", "cuda"):
        opts = TrainOptions(objective="binary", num_iterations=10, num_leaves=31,
                            device=device)
        t0 = time.perf_counter()
        fits[device] = Booster.train(x, y, opts)
        fits[device + "_seconds"] = time.perf_counter() - t0
    doc = {"phase": "slice_parity", "rounds": 10,
           **compare_fits(fits["cpu"], fits["cuda"], fits["cpu"].bin_mapper.transform(x)),
           "cpu_fit_seconds": fits["cpu_seconds"], "cuda_fit_seconds": fits["cuda_seconds"]}
    emit(doc)
    return doc


def phase_slice_higgs() -> dict:
    """The Higgs-shaped fit as bench.py:384-388 runs it first: uint8 bins,
    binned on the card (`device_binning=True`). The host binning the fit no
    longer does is timed alone beside it, and the card's binning alone."""
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    n, f, rounds, leaves = 1 << 20, 28, 5, 63
    x, y = make_dataset_wide(n, f)
    opts = TrainOptions(objective="binary", num_iterations=rounds, num_leaves=leaves,
                        bin_dtype="uint8", device_binning=True, device="cuda")
    # host binning, timed alone: the boundary sketch (which the fit still
    # runs) and the host transform (which it no longer runs)
    t0 = time.perf_counter()
    host_mapper = BinMapper(max_bin=opts.max_bin,
                            bin_construct_sample_cnt=opts.bin_construct_sample_cnt).fit(x)
    sketch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_mapper.transform(x)
    host_transform_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    histogram.launches = 0
    t0 = time.perf_counter()
    booster = Booster.train(x, y, opts)
    fit_s = time.perf_counter() - t0
    launches = histogram.launches
    assert launches == rounds * leaves, f"histogram launched {launches} times, want {rounds * leaves}"
    # the card's binning alone: the raw values to the card, binned there
    mapper = booster.bin_mapper
    assert np.array_equal(mapper.upper_bounds, np.float64(np.float32(mapper.upper_bounds)))
    mapper.transform_device(x[:4096], "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bins_card = mapper.transform_device(x, "cuda")
    torch.cuda.synchronize()
    device_binning_s = time.perf_counter() - t0
    # three sets of bins of 65,536 f32 rows (the data set's values are
    # f32): the card's, the CPU's transform_device, the snapped host walk's
    sub = x[:65536]
    card = bins_card[:65536].cpu().numpy()
    assert np.array_equal(card, mapper.transform_device(sub, "cpu").numpy()), \
        "card and CPU device binning differ"
    assert np.array_equal(card, mapper.transform(sub)), "device and host binning differ"
    del bins_card
    raw = booster.predict_raw(sub, device="device")
    acc = float(((raw > 0) == (y[:65536] > 0.5)).mean())
    assert np.isfinite(raw).all() and acc > 0.6, acc
    doc = {"phase": "slice_higgs", "rows": n, "features": f, "rounds": rounds,
           "num_leaves": leaves, "bin_dtype": "uint8", "device_binning": True,
           "fit_seconds": fit_s, "host_binning_seconds": sketch_s + host_transform_s,
           "host_sketch_seconds": sketch_s, "host_transform_seconds": host_transform_s,
           "device_binning_seconds": device_binning_s, "bins_equal_65536_rows": True,
           "histogram_launches": launches, "train_accuracy_first_65536": acc}
    emit(doc)
    return {**doc, "booster": booster, "x": x}


def phase_slice_predict(booster, x) -> dict:
    """Scoring the Higgs booster over its 1,048,576 rows (bench.py:408-419's
    two tiers): the fused bin -> traverse program `device_predict_fn` end to
    end (numpy f32 in, margins out) and resident (the values already on
    the card), against the staged `predict_raw(device="device")` (host
    binning, then the card's walk), bit for bit; then `predict_leaf` and
    `truncated(2)` on 4,096 rows against the host walk."""
    x32 = np.ascontiguousarray(x, dtype=np.float32)
    n = len(x32)
    params, fn = booster.device_predict_fn()
    fn(params, x32[:4096]).cpu()
    t0 = time.perf_counter()
    margins = fn(params, x32).cpu().numpy()
    e2e_s = time.perf_counter() - t0
    xd = torch.as_tensor(x32, device="cuda")
    fn(params, xd)
    resident = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(params, xd)
        torch.cuda.synchronize()
        resident.append(time.perf_counter() - t0)
    resident_s = float(np.median(resident))
    t0 = time.perf_counter()
    staged = booster.predict_raw(x32, device="device")
    staged_s = time.perf_counter() - t0
    assert margins.shape == (n,) and np.isfinite(margins).all()
    assert np.array_equal(margins, staged), "the fused program differs from predict_raw"

    sub = x[:4096]
    host = booster.predict_raw(sub, device="host")
    leaf = booster.predict_leaf(sub)
    acc = np.full(len(sub), booster.init_score, np.float32)
    for t in range(booster.num_trees):
        acc = acc + booster.value[t][leaf[:, t]]
    assert np.array_equal(acc, host), "predict_leaf's leaves do not add up to the host walk"
    two = booster.truncated(2)
    two_host = two.predict_raw(sub, device="host")
    assert two.num_trees == 2
    assert np.array_equal(two.predict_raw(sub, device="device"), two_host)
    assert np.array_equal(booster.predict_raw(sub, device="device", num_iteration=2), two_host)
    tp, tfn = two.device_predict_fn()
    assert np.array_equal(tfn(tp, sub.astype(np.float32)).cpu().numpy(), two_host)
    doc = {"phase": "slice_predict", "rows": n, "features": x.shape[1],
           "trees": booster.num_trees,
           "fused_end_to_end_seconds": e2e_s, "fused_end_to_end_rows_per_s": n / e2e_s,
           "fused_resident_seconds": resident_s, "fused_resident_rows_per_s": n / resident_s,
           "staged_predict_raw_seconds": staged_s, "staged_rows_per_s": n / staged_s,
           "fused_equals_predict_raw": True, "leaf_and_truncated_equal_host_walk": True}
    emit(doc)
    return doc


# The JAX package's held-out accuracy on digits (first 1,347 rows fitted,
# last 450 scored) with GBDTClassifier(num_iterations=30, num_leaves=15),
# computed on the CPU with
#   JAX_PLATFORMS=cpu python -c "import numpy as np; from mmlspark_tpu.core.schema
#   import Table; from mmlspark_tpu.gbdt import GBDTClassifier; d = np.loadtxt(
#   'tests/benchmarks/data/digits.csv', delimiter=',', skiprows=1); x, y = d[:, 1:],
#   d[:, 0]; c = 1347; m = GBDTClassifier(num_iterations=30, num_leaves=15).fit(
#   Table({'features': x[:c], 'label': y[:c]})); print((np.asarray(m.transform(
#   Table({'features': x[c:]}))['prediction']) == y[c:]).mean())"
DIGITS_JAX_ACCURACY = 0.9044444444444445


def phase_slice_multiclass() -> dict:
    """Multiclass on the repo's own digits (1,797 x 64, 10 classes), 75/25:
    GBDTClassifier on the card, 30 rounds of 10 trees of 15 leaves."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    data = np.loadtxt(ROOT / "tests" / "benchmarks" / "data" / "digits.csv", delimiter=",",
                      skiprows=1)
    x, y = data[:, 1:], data[:, 0]
    cut = int(len(x) * 0.75)
    rounds, leaves, k = 30, 15, 10
    torch.cuda.synchronize()
    histogram.launches = 0
    t0 = time.perf_counter()
    model = GBDTClassifier(num_iterations=rounds, num_leaves=leaves, device="cuda").fit(
        _table(x[:cut], y[:cut]))
    fit_s = time.perf_counter() - t0
    launches = histogram.launches
    want = rounds * k * leaves
    assert launches == want, f"histogram launched {launches} times, want {want}"
    assert model.booster.objective == "multiclass" and model.booster.num_trees == rounds * k
    out = model.transform(Table({"features": x[cut:]}))
    prob = np.asarray(out["probability"])
    assert prob.shape == (len(x) - cut, k) and np.isfinite(prob).all()
    assert np.allclose(prob.sum(-1), 1.0, atol=1e-5)
    acc = float((np.asarray(out["prediction"]) == y[cut:]).mean())
    assert acc >= DIGITS_JAX_ACCURACY - 0.02, (acc, DIGITS_JAX_ACCURACY)
    raw_card = model.booster.predict_raw(x[cut:], device="device")
    assert np.array_equal(raw_card, model.booster.predict_raw(x[cut:], device="host")), \
        "card traversal differs from the host walk"
    # CPU and card trees, 3 rounds (30 trees)
    fits = {dev: Booster.train(x[:cut], y[:cut], TrainOptions(
        objective="multiclass", num_class=k, num_iterations=3, num_leaves=leaves, device=dev))
        for dev in ("cpu", "cuda")}
    # digits' pixels take 17 values and many are 0 in the same rows, so
    # tied splits are common: the fits may part at a tie before any tree
    # is whole
    parity = compare_fits(fits["cpu"], fits["cuda"],
                          fits["cpu"].bin_mapper.transform(x[:cut]))
    # so the per-class gradients and hessians are held on continuous
    # features too: tests/test_gbdt.py's 4-class data, 20 rounds of 4 trees
    xc, yc = make_classification(classes=4)
    fits4 = {dev: Booster.train(xc, yc, TrainOptions(
        objective="multiclass", num_class=4, num_iterations=20, num_leaves=leaves, device=dev))
        for dev in ("cpu", "cuda")}
    parity4 = compare_fits(fits4["cpu"], fits4["cuda"], fits4["cpu"].bin_mapper.transform(xc))
    assert parity4["trees_compared"] > 0, f"no 4-class tree compared: {parity4['near_ties']}"
    doc = {"phase": "slice_multiclass", "rows": cut, "held_out_rows": len(x) - cut,
           "features": x.shape[1], "classes": k, "rounds": rounds, "num_leaves": leaves,
           "fit_seconds": fit_s, "histogram_launches": launches, "held_out_accuracy": acc,
           "jax_held_out_accuracy": DIGITS_JAX_ACCURACY, "card_equals_host_walk": True,
           "parity_3_rounds": parity, "parity_4_class_20_rounds": parity4}
    emit(doc)
    return doc


def make_classification(n=2000, f=10, seed=0, classes=2):
    """A copy of tests/test_gbdt.py's classification data set (that module
    imports the JAX package)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    logits = x[:, 0] * 2.0 + x[:, 1] - 0.5 * x[:, 2] + 0.3 * rng.normal(size=n)
    if classes == 2:
        y = (logits > 0).astype(np.float64)
    else:
        y = np.digitize(logits, np.quantile(logits, np.linspace(0, 1, classes + 1)[1:-1]))
    return x, y.astype(np.float64)


# Copies of tests/benchmarks/datasets.py's generators (that module imports
# the JAX package): frozen, since the committed baselines depend on every
# draw. They return (x, y) in place of its Table.
def airfoil_like(n=1503, f=5, seed=21):
    """Regression, smooth nonlinear response (airfoil noise role)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, f))
    y = (
        20.0 * np.sin(2.5 * x[:, 0])
        + 8.0 * x[:, 1] * x[:, 2]
        + 5.0 * np.square(x[:, 3])
        + rng.normal(scale=1.5, size=n)
        + 120.0
    )
    return x, y.astype(np.float64)


def counts_like(n=900, f=6, seed=24):
    """Poisson counts (for poisson/tweedie objective gates)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    lam = np.exp(0.6 * x[:, 0] - 0.4 * x[:, 1] + 0.1)
    y = rng.poisson(lam).astype(float)
    return x, y.astype(np.float64)


def breast_tissue_like(n=420, f=9, seed=11):
    """6-class, well-separated clusters + overlap (BreastTissue role)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=2.2, size=(6, f))
    y = rng.integers(0, 6, size=n)
    x = centers[y] + rng.normal(scale=1.0, size=(n, f))
    return x, y.astype(np.float64)


def pima_like(n=768, f=8, seed=12):
    """Binary, noisy nonlinear boundary (PimaIndian diabetes role)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    logits = x[:, 0] + 0.8 * x[:, 1] * x[:, 2] - 0.6 * np.abs(x[:, 3]) + 0.4
    y = (logits + rng.normal(scale=1.2, size=n) > 0).astype(int)
    return x, y.astype(np.float64)


def breast_cancer_like(n=560, f=10, seed=13):
    """Binary, nearly separable (breast-cancer role)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n)
    x = rng.normal(size=(n, f)) + y[:, None] * np.linspace(1.6, 0.2, f)
    return x, y.astype(np.float64)


def transfusion_like(n=748, f=4, seed=14):
    """Binary, weak signal / high Bayes error (blood-transfusion role)."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(n, f))) * [1.0, 3.0, 10.0, 20.0]
    logits = 0.3 * x[:, 1] - 0.04 * x[:, 3]
    y = (logits + rng.normal(scale=1.0, size=n) > 0.4).astype(int)
    return x, y.astype(np.float64)


def energy_efficiency_like(n=768, f=8, seed=22):
    """Regression, additive with interactions (energyefficiency role)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, f))
    y = (
        15.0 * x[:, 0]
        - 10.0 * x[:, 1]
        + 6.0 * x[:, 2] * x[:, 3]
        + 3.0 * np.sin(6.0 * x[:, 4])
        + rng.normal(scale=1.0, size=n)
        + 20.0
    )
    return x, y.astype(np.float64)


def concrete_like(n=1030, f=8, seed=23):
    """Regression, heteroscedastic noise (Concrete strength role)."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(n, f)))
    base = 12.0 * x[:, 0] + 6.0 * np.sqrt(x[:, 1] + 0.1) - 4.0 * x[:, 2]
    y = base + rng.normal(scale=0.5 + 0.8 * x[:, 3], size=n) + 35.0
    return x, y.astype(np.float64)


# tests/benchmarks/datasets.py's suites, by the names in the baselines
GATE_SETS = {
    "classifier": {"BreastTissue": breast_tissue_like, "PimaIndian": pima_like,
                   "BreastCancer": breast_cancer_like, "Transfusion": transfusion_like},
    "regressor": {"airfoil": airfoil_like, "energyefficiency": energy_efficiency_like,
                  "Concrete": concrete_like},
}
GATE_BOOSTING_TYPES = ("gbdt", "rf", "dart", "goss")


def _baselines(suite: str) -> dict:
    with open(ROOT / "tests" / "benchmarks" / f"benchmarks_{suite}.csv") as fh:
        return {r["name"]: (float(r["value"]), float(r["precision"]))
                for r in csv.DictReader(fh)}


def boosting_gate(suite: str, device: str, datasets=None, models=None) -> list:
    """tests/benchmarks/test_gbdt_benchmarks.py:41-84 through the port on
    `device`: for each data set of the suite (all, or the names in
    `datasets`) and each boosting type, GBDTClassifier (held-out accuracy)
    or GBDTRegressor (held-out RMSE) with 30 rounds of 15 leaves,
    bagging_fraction 0.85 every round and seed 42, fitted on the first 75%
    of the rows. Each row holds its value beside
    tests/benchmarks/benchmarks_<suite>.csv's baseline and precision; the
    committed files are read, nothing is written. `models`, a dict, gets
    each row's (booster, fitted rows) under its name."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.gbdt import GBDTClassifier, GBDTRegressor

    base = _baselines(suite)
    est = GBDTClassifier if suite == "classifier" else GBDTRegressor
    rows = []
    for name, gen in GATE_SETS[suite].items():
        if datasets is not None and name not in datasets:
            continue
        x, y = gen()
        cut = int(len(x) * 0.75)
        for boosting in GATE_BOOSTING_TYPES:
            model = est(boosting_type=boosting, num_iterations=30, num_leaves=15,
                        bagging_fraction=0.85, bagging_freq=1, seed=42,
                        device=device).fit(_table(x[:cut], y[:cut]))
            pred = np.asarray(model.transform(Table({"features": x[cut:]}))["prediction"],
                              np.float64)
            value = (float((pred == y[cut:]).mean()) if suite == "classifier"
                     else float(np.sqrt(np.mean((pred - y[cut:]) ** 2))))
            ref, precision = base[f"{name}_{boosting}"]
            if models is not None:
                models[f"{name}_{boosting}"] = (model.booster, x[:cut])
            rows.append({"name": f"{name}_{boosting}", "value": value, "baseline": ref,
                         "precision": precision, "within": abs(value - ref) <= precision})
    if datasets is None:
        assert {r["name"] for r in rows} == set(base), (sorted(r["name"] for r in rows),
                                                        sorted(base))
    return rows


def objectives_gate(device: str) -> list:
    """tests/benchmarks/test_gbdt_benchmarks.py:86-114 through the port's
    GBDTRegressor on `device`: l1, huber and quantile on airfoil_like (test
    RMSE), poisson and tweedie on counts_like (mean poisson deviance), each
    30 rounds of 15 leaves on the first 75% of the rows. Each row holds its
    value beside tests/benchmarks/benchmarks_objectives.csv's baseline and
    precision."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.gbdt import GBDTRegressor

    with open(ROOT / "tests" / "benchmarks" / "benchmarks_objectives.csv") as fh:
        base = {r["name"]: (float(r["value"]), float(r["precision"]))
                for r in csv.DictReader(fh)}

    def predict(objective, x, y):
        cut = int(len(x) * 0.75)
        model = GBDTRegressor(objective=objective, num_iterations=30, num_leaves=15, seed=42,
                              device=device).fit(_table(x[:cut], y[:cut]))
        pred = model.transform(Table({"features": x[cut:]}))["prediction"]
        return np.asarray(pred, np.float64), y[cut:]

    values = {}
    x, y = airfoil_like()
    for objective in ("l1", "huber", "quantile"):
        pred, yt = predict(objective, x, y)
        values[f"airfoil_{objective}"] = float(np.sqrt(np.mean((pred - yt) ** 2)))
    x, y = counts_like()
    for objective in ("poisson", "tweedie"):
        pred, yc = predict(objective, x, y)
        eps = 1e-9
        values[f"counts_{objective}_deviance"] = float(np.mean(
            2 * (yc * np.log((yc + eps) / (pred + eps)) - (yc - pred))))
    assert set(values) == set(base), (sorted(values), sorted(base))
    return [{"name": name, "value": v, "baseline": base[name][0], "precision": base[name][1],
             "within": abs(v - base[name][0]) <= base[name][1]} for name, v in values.items()]


def phase_slice_objectives() -> dict:
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    torch.cuda.synchronize()
    histogram.launches = 0
    t0 = time.perf_counter()
    rows = objectives_gate("cuda")
    seconds = time.perf_counter() - t0
    launches = histogram.launches
    want = 5 * 30 * 15
    assert launches == want, f"histogram launched {launches} times, want {want}"
    bad = [r for r in rows if not r["within"]]
    assert not bad, f"objectives outside their benchmark precision: {bad}"
    doc = {"phase": "slice_objectives", "fits": 5, "rounds": 30, "num_leaves": 15,
           "seconds": seconds, "histogram_launches": launches, "gate": rows}
    emit(doc)
    return doc


# The boosting options of the Adult fit, as GBDTClassifier takes them
BOOSTING_FITS = {
    "gbdt_bagged": dict(boosting_type="gbdt", bagging_fraction=0.8, bagging_freq=1,
                        feature_fraction=0.8),
    "goss": dict(boosting_type="goss"),
    "rf": dict(boosting_type="rf"),
    "dart": dict(boosting_type="dart"),          # drop_rate 0.1, the default
}


def _rounds_without_sync(x, y, categorical_indexes=(), max_bin: int = 255) -> list:
    """Two rounds of each boosting type's loop on the card under sync debug
    mode "error": bagging with feature sampling (the second round carries
    the first one's bag), goss with feature sampling, rf and dart, with
    the given categorical features and max_bin. No round may read anything
    back to the host."""
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.gbdt.engine import GrowConfig
    from mmlspark_tpu_torch.gbdt.fused import (FusedTrainSpec, make_fused_dart_fn,
                                               make_fused_train_fn)
    from mmlspark_tpu_torch.gbdt.objectives import get_objective

    mapper = BinMapper(max_bin=max_bin, categorical_indexes=tuple(categorical_indexes)).fit(x)
    bins = torch.as_tensor(mapper.transform(x), device="cuda")
    nb = max(int(mapper.num_bins.max()), 2)
    yt = torch.as_tensor(y, dtype=torch.float32, device="cuda")
    w = torch.ones_like(yt)
    pred0 = torch.zeros_like(yt)
    cat_mask = np.isin(np.arange(x.shape[1]), list(categorical_indexes))
    args = (x.shape[1], nb, GrowConfig(num_leaves=31), mapper.num_bins, cat_mask,
            get_objective("binary"))
    specs = {
        "gbdt_bagged": FusedTrainSpec(num_rounds=2, bagging_fraction=0.8, bagging_freq=2,
                                      feature_fraction=0.8),
        "goss": FusedTrainSpec(num_rounds=2, boosting_type="goss", feature_fraction=0.8),
        "rf": FusedTrainSpec(num_rounds=2, boosting_type="rf"),
        "dart": FusedTrainSpec(num_rounds=2, boosting_type="dart", bagging_fraction=0.8,
                               bagging_freq=1, feature_fraction=0.8, drop_rate=0.5),
    }
    checked = []
    for name, spec in specs.items():
        if name == "dart":
            fn = make_fused_dart_fn(*args, spec, device="cuda")
            call = lambda: fn(bins, yt, w, pred0, 4, 3, 2)  # noqa: E731
        else:
            fn = make_fused_train_fn(*args, spec, device="cuda")
            call = lambda: fn(bins, yt, w, pred0, 3)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        checked.append(name)
    return checked


def phase_slice_boosting() -> dict:
    """The Adult shape through GBDTClassifier on the card under each
    boosting type: 100 rounds of 31 leaves, so 3,100 K1 launches a fit."""
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    n, n_valid, f, rounds, leaves = 32768, 8192, 14, 100, 31
    x_all, y_all = make_dataset(n + n_valid, f)
    x, y, xv, yv = x_all[:n], y_all[:n], x_all[n:], y_all[n:]
    sync_free = _rounds_without_sync(x, y)
    fits = {}
    for name, kw in BOOSTING_FITS.items():
        GBDTClassifier(num_iterations=2, num_leaves=leaves, device="cuda", **kw).fit(_table(x, y))
        torch.cuda.synchronize()
        histogram.launches = 0
        t0 = time.perf_counter()
        model = GBDTClassifier(num_iterations=rounds, num_leaves=leaves, device="cuda",
                               **kw).fit(_table(x, y))
        fit_s = time.perf_counter() - t0
        launches = histogram.launches
        assert launches == rounds * leaves, \
            f"{name}: histogram launched {launches} times, want {rounds * leaves}"
        train = _metrics(model.transform(_table(x, y)))
        valid = _metrics(model.transform(_table(xv, yv)))
        assert train["accuracy"] > 0.7, (name, train)
        assert valid["auc"] > 0.75, (name, valid)
        raw_card = model.booster.predict_raw(xv, device="device")
        assert raw_card.shape == (n_valid,) and np.isfinite(raw_card).all()
        assert np.array_equal(raw_card, model.booster.predict_raw(xv, device="host")), \
            f"{name}: card traversal differs from the host walk"
        fits[name] = {"options": kw, "fit_seconds": fit_s, "histogram_launches": launches,
                      "train_accuracy": train["accuracy"], "valid_auc": valid["auc"],
                      "valid_accuracy": valid["accuracy"], "card_equals_host_walk": True}
    doc = {"phase": "slice_boosting", "rows": n, "features": f, "rounds": rounds,
           "num_leaves": leaves, "sync_free_rounds": sync_free, "fits": fits,
           "histogram_launches": sum(v["histogram_launches"] for v in fits.values())}
    emit(doc)
    return doc


def _row_order_histogram(bins, stats, num_bins):
    """The CPU's plain histogram for a card fit: K1's place taken by
    `histogram_torch` on host copies, which adds the rows in order."""
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram_torch

    return histogram_torch(bins.cpu(), stats.cpu(), num_bins).to(bins.device)


def _fit_with_draws(x, y, kw: dict, rounds: int, device: str, row_order: bool = False):
    """A fit of `rounds` rounds with the options `kw` (binary, 31 leaves
    unless `kw` says otherwise) and, through fused.round_hook, each tree's random parts as the loop
    used them: (grow mask, feature mask, drop set or None), on the CPU.
    `row_order`: the card's histograms come from `_row_order_histogram` in
    place of K1."""
    from unittest import mock

    from mmlspark_tpu_torch.gbdt import engine, fused
    from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions

    parts = []
    fused.round_hook = lambda it, cls, mask, fmask, drop: parts.append(
        (mask.cpu(), fmask.cpu(), None if drop is None else drop.cpu()))
    try:
        with mock.patch.object(engine, "histogram",
                               _row_order_histogram if row_order else engine.histogram):
            t0 = time.perf_counter()
            booster = Booster.train(x, y, TrainOptions(**{
                "objective": "binary", "num_leaves": 31, **kw, "num_iterations": rounds,
                "device": device}))
            seconds = time.perf_counter() - t0
    finally:
        fused.round_hook = None
    return booster, parts, seconds


def cpu_card_parity(x, y, kw: dict, rounds: int = 10, ties: "dict | None" = None) -> dict:
    """The data fitted on "cpu" and on "cuda" (`_fit_with_draws`): the card
    fit through the CPU's row-order histogram in K1's place meets
    compare_fits at 1e-5 (the devices' other steps agree), the card fit
    through K1 at 1e-4 (its block-order sums), with compare_fits's other
    tie rules `ties` where given. Returns both comparisons with the fit
    seconds, and the two fits' random parts."""
    cpu, cpu_parts, cpu_s = _fit_with_draws(x, y, kw, rounds, "cpu")
    card, card_parts, card_s = _fit_with_draws(x, y, kw, rounds, "cuda")
    rows, _, rows_s = _fit_with_draws(x, y, kw, rounds, "cuda", row_order=True)
    bins = cpu.bin_mapper.transform(x)
    keys = ("trees_equal", "trees_compared", "near_ties", "max_value_err_over_tree_max")
    witness = compare_fits(cpu, rows, bins)
    k1 = compare_fits(cpu, card, bins, tol=1e-4, **(ties or {}))
    return ({"k1": {k: k1[k] for k in keys}, "row_order": {k: witness[k] for k in keys},
             "cpu_fit_seconds": cpu_s, "cuda_fit_seconds": card_s,
             "cuda_row_order_fit_seconds": rows_s}, (cpu_parts, card_parts))


def phase_slice_boosting_parity() -> dict:
    """The card's draws are the CPU's. `prng.uniform` for the bag, GOSS,
    feature and drop keys of several rounds at 32,768 and 1,048,576 rows,
    bit for bit. Then the Adult data fitted on "cpu" and on "cuda" for 10
    rounds under each boosting type, the random parts each tree grew from
    read through `fused.round_hook`: the bag, feature mask and dart drop
    set equal every round, GOSS's row weights (set by each fit's own
    margins) every round up to the card's first parting tree. Trees:
    the card fit through the CPU's row-order histogram (in K1's place)
    meets compare_fits's 1e-5 rules, so the devices' other steps agree;
    the card fit through K1 meets them at 1e-4, K1 adding a node's rows in
    block order (runs DE, DF: gain gaps at a parting up to 2.3e-5, leaf
    gaps up to 3.6e-5 of a tree's largest). Last, `boosting_paths_cpu_card`:
    the renewed objectives, early stopping and an rf warm start, each on
    both devices."""
    from mmlspark_tpu_torch.core import prng

    key, drop_key = prng.prng_key(3), prng.prng_key(4)
    keys = {}
    for it in (0, 1, 7, 99):
        kr = prng.fold_in(key, it)
        keys.update({f"bag_r{it}": prng.fold_in(kr, 1), f"goss_r{it}": prng.fold_in(kr, 2),
                     f"feature_r{it}": prng.fold_in(kr, 100),
                     f"drop_r{it}": prng.fold_in(drop_key, it)})
    draws = 0
    for n in (32768, 1 << 20):
        for name, k in keys.items():
            card = prng.uniform(k, (n,), "cuda").cpu()
            cpu = prng.uniform(k, (n,), "cpu")
            assert torch.equal(card.view(torch.int32), cpu.view(torch.int32)), \
                f"the card's draw {name} at n={n} differs from the CPU's"
            draws += 1
    # what a draw costs the loop: ~130 small integer kernels (threefry)
    bag_key = keys["bag_r0"]
    draw_cost = {f"rows_{n}": {
        "host_us_per_call": host_us_per_call(lambda: prng.uniform(bag_key, (n,), "cuda"), 50),
        "device_ms": median_ms(lambda: prng.uniform(bag_key, (n,), "cuda"))}
        for n in (32768, 1 << 20)}
    rounds = 10
    x, y = make_dataset(32768, 14)
    fits = {}
    for name, kw in BOOSTING_FITS.items():
        parity, (cpu_parts, card_parts) = cpu_card_parity(x, y, kw, rounds)
        k1 = parity["k1"]
        parted = k1["near_ties"][0]["tree"] if k1["near_ties"] else rounds
        assert len(cpu_parts) == len(card_parts) == rounds, (len(cpu_parts), len(card_parts))
        goss_equal = 0
        for r, ((m0, f0, d0), (m1, f1, d1)) in enumerate(zip(cpu_parts, card_parts)):
            assert torch.equal(f0, f1), f"{name}: round {r}'s feature mask differs"
            assert (d0 is None) == (d1 is None) and (d0 is None or torch.equal(d0, d1)), \
                f"{name}: round {r}'s drop set differs"
            if name != "goss":
                assert torch.equal(m0, m1), f"{name}: round {r}'s bag differs"
            elif torch.equal(m0, m1):
                goss_equal += 1
            else:
                assert r > parted, f"goss: round {r}'s row weights differ before tree {parted}"
        fits[name] = {
            "random_parts_equal_rounds": goss_equal if name == "goss" else rounds,
            "card_first_parting_tree": parted if parted < rounds else None, **parity}
    doc = {"phase": "slice_boosting_parity", "draws_equal": draws,
           "draw_rows": [32768, 1 << 20], "draw_cost": draw_cost, "rounds": rounds,
           "fits": fits, **boosting_paths_cpu_card()}
    emit(doc)
    return doc


def boosting_paths_cpu_card() -> dict:
    """Paths of the boosting loop held on the card against the CPU: the
    renewed objectives (l1, quantile, mape) under bagged gbdt, goss and dart
    on airfoil_like, 10 rounds of 15 leaves each (cpu_card_parity); early
    stopping for multiclass (make_classification's 4 classes) and
    regression (airfoil_like), patience 5 at learning rate 0.5: the same
    best iteration on both devices, best + 1 rounds kept, launches of
    exactly the rounds run, trees by compare_fits at 1e-4; and an rf warm
    start (5 rounds, then 5 more from that model) on both devices."""
    from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    xa, ya = airfoil_like()
    renewal = {f"{objective}_{name}": cpu_card_parity(
        xa, ya, {**BOOSTING_FITS[name], "objective": objective, "num_leaves": 15})[0]
        for objective in ("l1", "quantile", "mape") for name in ("gbdt_bagged", "goss", "dart")}

    xc, yc = make_classification(classes=4)
    stopping = {}
    for label, x, y, kw in (
            ("multiclass", xc, yc, dict(objective="multiclass", num_class=4)),
            ("regression", xa, ya, dict(objective="regression"))):
        cut = int(len(x) * 0.75)
        opts = dict(num_iterations=100, num_leaves=15, learning_rate=0.5,
                    early_stopping_round=5, **kw)
        fits, launches = {}, 0
        for dev in ("cpu", "cuda"):
            before = histogram.launches
            fits[dev] = Booster.train(x[:cut], y[:cut], TrainOptions(device=dev, **opts),
                                      valid=(x[cut:], y[cut:]))
            launches = histogram.launches - before
        cpu, card = fits["cpu"], fits["cuda"]
        k = kw.get("num_class", 1)
        best = card.best_iteration
        assert 0 <= best < 100 - 5 and best == cpu.best_iteration, (label, best,
                                                                     cpu.best_iteration)
        assert card.num_trees == cpu.num_trees == (best + 1) * k
        assert launches == (best + 1 + 5) * k * 15, (label, launches)
        out = compare_fits(cpu, card, cpu.bin_mapper.transform(x[:cut]), tol=1e-4)
        stopping[label] = {"best_iteration": best, "trees": card.num_trees,
                           "histogram_launches": launches,
                           **{key: out[key] for key in ("trees_equal", "trees_compared")}}

    xb, yb = make_classification()
    rf = dict(objective="binary", boosting_type="rf", num_leaves=15)
    warm = {}
    for dev in ("cpu", "cuda"):
        first = Booster.train(xb, yb, TrainOptions(num_iterations=5, device=dev, **rf))
        warm[dev] = Booster.train(xb, yb, TrainOptions(num_iterations=10, init_model=first,
                                                       device=dev, **rf))
        assert warm[dev].num_trees == 10
        for name in ("feature", "threshold_bin", "left", "right"):
            assert np.array_equal(getattr(warm[dev], name)[:5], getattr(first, name)), name
    out = compare_fits(warm["cpu"], warm["cuda"], warm["cpu"].bin_mapper.transform(xb), tol=1e-4)
    return {"renewal": renewal, "early_stopping": stopping,
            "rf_warm_start": {key: out[key] for key in ("trees_equal", "trees_compared",
                                                        "max_value_err_over_tree_max")}}


def phase_slice_early_stopping() -> dict:
    """An Adult fit on the card that stops early: GBDTClassifier with
    validation_fraction 0.1 and early_stopping_round 5 at learning rate
    0.5. The model keeps best_iteration + 1 rounds; the held-out loss
    recomputed from `predict_raw(num_iteration=...)` is smallest at
    best_iteration; a warm start from its `model_string` keeps its trees
    first."""
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
    from mmlspark_tpu_torch.gbdt.objectives import get_validation_loss

    n, f, rounds, leaves, patience, seed = 32768, 14, 100, 31, 5, 11
    x, y = make_dataset(n, f)
    params = dict(num_leaves=leaves, learning_rate=0.5, seed=seed, device="cuda")
    torch.cuda.synchronize()
    histogram.launches = 0
    t0 = time.perf_counter()
    model = GBDTClassifier(num_iterations=rounds, validation_fraction=0.1,
                           early_stopping_round=patience, **params).fit(_table(x, y))
    fit_s = time.perf_counter() - t0
    launches = histogram.launches
    booster = model.booster
    best = booster.best_iteration
    assert 0 <= best < rounds - patience, f"the fit did not stop early (best {best})"
    assert booster.num_trees == best + 1, (booster.num_trees, best)
    # the loop ran best + 1 + patience rounds, each of `leaves` launches
    assert launches == (best + 1 + patience) * leaves, (launches, best)
    held = np.random.default_rng(seed).permutation(n)[:int(round(0.1 * n))]
    loss_fn = get_validation_loss("binary")
    yv = torch.as_tensor(y[held], dtype=torch.float32, device="cuda")
    losses = [float(loss_fn(torch.as_tensor(booster.predict_raw(x[held], num_iteration=i),
                                            device="cuda"), yv))
              for i in range(1, best + 2)]
    assert int(np.argmin(losses)) == best, (int(np.argmin(losses)), best)

    histogram.launches = 0
    more = 10
    warm = GBDTClassifier(num_iterations=best + 1 + more, model_string=booster.to_text(),
                          **params).fit(_table(x, y))
    warm_launches = histogram.launches
    assert warm_launches == more * leaves, warm_launches
    assert warm.booster.num_trees == best + 1 + more
    for name in ("feature", "threshold_bin", "left", "right", "value"):
        assert np.array_equal(getattr(warm.booster, name)[:best + 1], getattr(booster, name)), name
    doc = {"phase": "slice_early_stopping", "rows": n - len(held), "held_out_rows": len(held),
           "max_rounds": rounds, "learning_rate": 0.5, "early_stopping_round": patience,
           "best_iteration": best, "trees_kept": booster.num_trees, "fit_seconds": fit_s,
           "histogram_launches": launches, "held_out_loss_at_best": losses[best],
           "held_out_loss_first": losses[0], "warm_start_rounds": more,
           "warm_start_launches": warm_launches, "warm_trees_first": True}
    emit(doc)
    return doc


def phase_slice_gates() -> dict:
    """tests/benchmarks/test_gbdt_benchmarks.py:41-84 on the card: 16
    classifier and 12 regressor fits, each row within its precision; then
    the same fits on the CPU, whose trees the card's meet by compare_fits
    at 1e-4."""
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    card = {}
    torch.cuda.synchronize()
    histogram.launches = 0
    t0 = time.perf_counter()
    rows = (boosting_gate("classifier", "cuda", models=card)
            + boosting_gate("regressor", "cuda", models=card))
    seconds = time.perf_counter() - t0
    launches = histogram.launches
    # 30 rounds of 15 leaves, BreastTissue's 6 trees a round, one elsewhere
    want = 4 * 30 * 15 * (6 + 3 + 3)
    assert launches == want, f"histogram launched {launches} times, want {want}"
    bad = [r for r in rows if not r["within"]]
    assert len(rows) == 28 and not bad, f"gate rows outside their precision: {bad}"
    # the same 28 fits on the CPU: the card's trees by compare_fits at 1e-4
    # (K1's block-order sums); a node of one class's rows has splits whose
    # gains are f32 noise (gain_floor)
    cpu = {}
    t0 = time.perf_counter()
    boosting_gate("classifier", "cpu", models=cpu)
    boosting_gate("regressor", "cpu", models=cpu)
    cpu_seconds = time.perf_counter() - t0
    trees = {}
    for name, (booster, x) in cpu.items():
        out = compare_fits(booster, card[name][0], booster.bin_mapper.transform(x), tol=1e-4,
                           gain_floor=1e-5)
        trees[name] = {k: out[k] for k in ("trees_equal", "trees_compared", "near_ties",
                                           "max_value_err_over_tree_max")}
        trees[name]["trees"] = booster.num_trees
    doc = {"phase": "slice_gates", "fits": len(rows), "rounds": 30, "num_leaves": 15,
           "seconds": seconds, "histogram_launches": launches, "gate": rows,
           "cpu_seconds": cpu_seconds, "cpu_card_trees": trees}
    emit(doc)
    return doc


# compare_fits's rules for K1 against the CPU on the categorical fits: a
# gain gap within 1e-4 of the tree's largest gain (their nodes' gains are
# small differences of large terms: 6.2e-4 of a 44.5 gain at Adult's tree
# 1, 2.9e3 at its root), and category order ties
CATEGORICAL_TIES = dict(gain_floor=1e-4, order_ties=True)


def _card_fit(x, y, xv, yv, params: dict, rounds: int = 100, leaves: int = 31):
    """GBDTClassifier on the card with `params`: a 2-round warm-up, then the
    counted fit of `rounds` rounds (exactly rounds x leaves K1 launches),
    held-out metrics, the card's scores against the host walk, and the
    bin dtypes and widths K1 saw (a pass-through spy on the engine's
    histogram) with the fit's warnings."""
    import warnings
    from unittest import mock

    from mmlspark_tpu_torch.gbdt import GBDTClassifier, engine
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    GBDTClassifier(num_iterations=2, num_leaves=leaves, device="cuda", **params).fit(_table(x, y))
    seen = set()

    def spy(bins, stats, num_bins):
        seen.add((str(bins.dtype).replace("torch.", ""), num_bins))
        return histogram(bins, stats, num_bins)

    torch.cuda.synchronize()
    histogram.launches = 0
    with mock.patch.object(engine, "histogram", spy), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        model = GBDTClassifier(num_iterations=rounds, num_leaves=leaves, device="cuda",
                               **params).fit(_table(x, y))
        fit_s = time.perf_counter() - t0
    launches = histogram.launches
    assert launches == rounds * leaves, f"histogram launched {launches} times, want {rounds * leaves}"
    booster = model.booster
    valid = _metrics(model.transform(_table(xv, yv)))
    raw_card = booster.predict_raw(xv, device="device")
    assert raw_card.shape == (len(xv),) and np.isfinite(raw_card).all()
    assert np.array_equal(raw_card, booster.predict_raw(xv, device="host")), \
        "card traversal differs from the host walk"
    split_cat = booster.is_categorical & (booster.feature >= 0)
    sizes = booster.cat_bitset[split_cat].sum(-1)
    return booster, {
        "fit_seconds": fit_s, "histogram_launches": launches, "valid_auc": valid["auc"],
        "valid_accuracy": valid["accuracy"], "card_equals_host_walk": True,
        "num_bins": [int(b) for b in booster.bin_mapper.num_bins],
        "k1_bins_seen": sorted(seen), "warnings": sorted({str(w.message) for w in caught}),
        "categorical_nodes": int(split_cat.sum()),
        "categorical_nodes_of_many": int((sizes > 1).sum()),
        "largest_subset": int(sizes.max(initial=0))}


def phase_slice_categorical() -> dict:
    """UCI Adult's schema (make_adult_categorical: 6 numeric columns and
    the 8 categorical ones at adult.names's cardinalities, "?" as NaN), on
    32,768 rows fitted and 8,192 held out, through
    GBDTClassifier(categorical_slot_indexes=...): 100 rounds of 31 leaves
    at max_bin 255, so 3,100 K1 launches; held-out AUC > 0.75 and accuracy
    > 0.7 (bench.py's canaries); card scores equal to the host walk; at
    least one categorical node with a subset of more than one category;
    two rounds of each loop under sync debug mode "error"; and 10 rounds
    fitted on "cpu" and "cuda" (cpu_card_parity, K1 with
    CATEGORICAL_TIES)."""
    n, n_valid = 32768, 8192
    x_all, y_all = make_adult_categorical(n + n_valid)
    x, y, xv, yv = x_all[:n], y_all[:n], x_all[n:], y_all[n:]
    cats = list(ADULT_CATEGORICAL)
    sync_free = _rounds_without_sync(x, y, cats)
    booster, fit = _card_fit(x, y, xv, yv, dict(categorical_slot_indexes=cats))
    assert fit["valid_auc"] > 0.75 and fit["valid_accuracy"] > 0.7, fit
    assert fit["categorical_nodes_of_many"] > 0, "no categorical node with a subset of many"
    assert fit["k1_bins_seen"] == [("int32", 256)], fit["k1_bins_seen"]
    parity = cpu_card_parity(x, y, dict(categorical_indexes=cats), ties=CATEGORICAL_TIES)[0]
    doc = {"phase": "slice_categorical", "rows": n, "held_out_rows": n_valid,
           "features": x.shape[1], "categorical_slots": cats, "rounds": 100, "num_leaves": 31,
           "max_bin": 255, "sync_free_rounds": sync_free, **fit, "parity_10_rounds": parity}
    emit(doc)
    return doc


def phase_slice_high_cardinality() -> dict:
    """The Amazon Employee Access Challenge's schema (make_amazon_access:
    9 categorical columns at train.csv's cardinalities, ~94% ACTION 1) on
    its 32,769 rows, 8,192 more held out, through GBDTClassifier with
    max_bin 1023 and bin_dtype "uint8" asked for: the reference's warning
    and int32 bins; the three widest columns keep their 1,023 most frequent
    categories, so K1 runs at B 1024 ("rows": one copy of 9 warps), 3,100
    launches; held-out AUC above a constant predictor's; card scores equal
    to the host walk; two rounds of each loop under sync debug mode
    "error"; 10 rounds on "cpu" and "cuda" (cpu_card_parity, K1 with
    CATEGORICAL_TIES), and the same for the numeric Adult shape
    (make_dataset) at max_bin 511 with compare_fits's plain rules."""
    from mmlspark_tpu_torch.gbdt.hist_kernel import device_plan

    n, n_valid = AMAZON_ROWS, 8192
    x_all, y_all = make_amazon_access(n + n_valid)
    x, y, xv, yv = x_all[:n], y_all[:n], x_all[n:], y_all[n:]
    cats = list(range(x.shape[1]))
    sync_free = _rounds_without_sync(x, y, cats, max_bin=1023)
    booster, fit = _card_fit(x, y, xv, yv, dict(
        categorical_slot_indexes=cats, max_bin=1023, bin_dtype="uint8"))
    assert fit["valid_auc"] > 0.5, fit
    assert any("storing bins as int32" in w for w in fit["warnings"]), fit["warnings"]
    assert fit["k1_bins_seen"] == [("int32", 1024)], fit["k1_bins_seen"]
    widest = sorted(fit["num_bins"])[-3:]
    assert widest == [1024] * 3, fit["num_bins"]
    plan = device_plan(n, x.shape[1], 1024, 4, 0)
    parity = cpu_card_parity(x, y, dict(categorical_indexes=cats, max_bin=1023),
                             ties=CATEGORICAL_TIES)[0]
    xn, yn = make_dataset(32768, 14)
    numeric = cpu_card_parity(xn, yn, dict(max_bin=511))[0]
    doc = {"phase": "slice_high_cardinality", "rows": n, "held_out_rows": n_valid,
           "features": x.shape[1], "positive_share": float(y.mean()), "rounds": 100,
           "num_leaves": 31, "max_bin": 1023, "bin_dtype_asked": "uint8", "k1_plan": plan.branch,
           "sync_free_rounds": sync_free, **fit, "parity_10_rounds": parity,
           "adult_numeric_max_bin_511_parity_10_rounds": numeric}
    emit(doc)
    return doc


def phase_slice_max_bin_16383() -> dict:
    """The numeric Adult shape (make_dataset: 32,768 rows fitted, 8,192 held
    out) through GBDTClassifier(max_bin=16383): its 12 continuous columns
    take 16,384 bins, past the ~14,000 of one feature a block that K1 held
    before bin ranges; 100 rounds of 31 leaves, so 3,100 launches, all at
    B 16,384 int32; held-out AUC > 0.75 and accuracy > 0.7 (bench.py's
    canaries); card scores equal to the host walk; 10 rounds on "cpu" and
    "cuda" (cpu_card_parity: the row-order witness at 1e-5, K1 at 1e-4)."""
    from mmlspark_tpu_torch.gbdt.hist_kernel import device_plan

    n, n_valid, f = 32768, 8192, 14
    x_all, y_all = make_dataset(n + n_valid, f)
    x, y, xv, yv = x_all[:n], y_all[:n], x_all[n:], y_all[n:]
    booster, fit = _card_fit(x, y, xv, yv, dict(max_bin=16383))
    assert fit["valid_auc"] > 0.75 and fit["valid_accuracy"] > 0.7, fit
    assert fit["k1_bins_seen"] == [("int32", 16384)], fit["k1_bins_seen"]
    assert sorted(fit["num_bins"])[-12:] == [16384] * 12, fit["num_bins"]
    plan = device_plan(n, f, 16384, 4, 0)
    split = booster.feature >= 0
    parity = cpu_card_parity(x, y, dict(max_bin=16383))[0]
    doc = {"phase": "slice_max_bin_16383", "rows": n, "held_out_rows": n_valid, "features": f,
           "rounds": 100, "num_leaves": 31, "max_bin": 16383, "k1_plan": plan._asdict(),
           "k1_branch": plan.branch, **{k: v for k, v in fit.items() if "categorical" not in k
                                        and k != "largest_subset"},
           "splits_past_bin_14376": int((booster.threshold_bin[split] > 14376).sum()),
           "splits": int(split.sum()), "parity_10_rounds": parity}
    emit(doc)
    return doc


# The serving transformer at bench.py's accelerator width (bench.py:632-645)
SLICE_TRANSFORMER = dict(num_layers=8, d_model=512, num_heads=8, d_ff=2048,
                         vocab_size=16384, max_len=4096, num_outputs=8)
SLICE_ROWS, SLICE_TOKENS, SLICE_BATCH = 1024, 512, 64


def _serve(bundle, rows, device, batch, fetch=None):
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import DeepModelTransformer

    stage = DeepModelTransformer(input_col="tokens", mini_batch_size=batch, device=device,
                                 fetch_dict=fetch or {"logits": "logits"}).set_model(bundle)
    return stage, stage.transform(Table({"tokens": rows}))


def _variant(bundle, **config):
    """The same weights under another attention impl or dtype."""
    from mmlspark_tpu_torch.nn import ModelBundle

    return ModelBundle(architecture=bundle.architecture, config={**bundle.config, **config},
                       variables=bundle.variables, input_shape=bundle.input_shape)


def phase_slice_transformer() -> dict:
    """The DNN slice's main path: 1,024 rows x 512 token ids through
    DeepModelTransformer on the card, attention_impl="flash" in bf16, one
    K2 launch per layer and minibatch; the same tokens served in f32 (K2's
    3xTF32 path); then the outputs checked three ways, and a 4 x 4096
    long-sequence run."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import ModelBundle
    from mmlspark_tpu_torch.nn.attention import flash_attention

    t0 = time.perf_counter()
    bundle = ModelBundle.init("transformer", (SLICE_TOKENS,), seed=0, attention_impl="flash",
                              dtype="bfloat16", **SLICE_TRANSFORMER)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    x = rng.integers(0, SLICE_TRANSFORMER["vocab_size"], size=(SLICE_ROWS, SLICE_TOKENS))
    fetch = {"logits": "logits", "prob": "probability"}
    # warm-up on one minibatch: weights to the card, cuBLAS handles
    stage, _ = _serve(bundle, x[:SLICE_BATCH], "cuda", SLICE_BATCH, fetch)
    torch.cuda.synchronize()

    flash_attention.launches = 0
    t0 = time.perf_counter()
    out = stage.transform(Table({"tokens": x}))
    serve_s = time.perf_counter() - t0
    launches = flash_attention.launches
    path = flash_attention.last_path
    want = SLICE_ROWS // SLICE_BATCH * SLICE_TRANSFORMER["num_layers"]
    assert launches == want, f"K2 launched {launches} times, want {want}"
    assert path == "wgmma", f"the serving path ran K2's {path} kernel, want wgmma"
    logits, prob = np.asarray(out["logits"]), np.asarray(out["prob"])
    assert logits.shape == (SLICE_ROWS, 8) and prob.shape == (SLICE_ROWS, 8)
    assert np.isfinite(logits).all() and np.isfinite(prob).all()
    assert np.allclose(prob.sum(-1), 1.0, atol=1e-5)

    # the same tokens served in f32 (the bundle's default dtype): every K2
    # launch on the 3xTF32 path; the first minibatch is the warm-up
    stage32, flash32 = _serve(_variant(bundle, dtype="float32"), x[:SLICE_BATCH], "cuda",
                              SLICE_BATCH)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    out32 = stage32.transform(Table({"tokens": x}))
    serve32_s = time.perf_counter() - t0
    launches32 = flash_attention.launches
    path32 = flash_attention.last_path
    assert launches32 == want, f"f32 serving launched K2 {launches32} times, want {want}"
    assert path32 == "tf32x3", f"f32 serving ran K2's {path32} kernel, want tf32x3"
    logits32 = np.asarray(out32["logits"])
    assert logits32.shape == (SLICE_ROWS, 8) and np.isfinite(logits32).all()

    # f32 flash against f32 dense on the card: the same weights and param
    # tree, the dense path runs no K2. f32 throughout (TF32 off for the
    # GEMMs; K2's 3xTF32 keeps f32 accuracy), so only the order of sums
    # differs: 1e-4
    before = flash_attention.launches
    _, dense = _serve(_variant(bundle, attention_impl="dense", dtype="float32"),
                      x[:SLICE_BATCH], "cuda", SLICE_BATCH)
    assert flash_attention.launches == before, "the dense path launched K2"
    dense, flash32 = np.asarray(dense["logits"]), np.asarray(flash32["logits"])
    flash_vs_dense = float(np.abs(flash32 - dense).max())
    np.testing.assert_allclose(flash32, dense, atol=1e-4, rtol=1e-4)
    # card against CPU, 2 rows in f32 (the CPU runs K2's plain version)
    f32 = _variant(bundle, dtype="float32")
    _, card2 = _serve(f32, x[:2], "cuda", 2)
    t0 = time.perf_counter()
    _, cpu2 = _serve(f32, x[:2], "cpu", 2)
    cpu2_s = time.perf_counter() - t0
    card2, cpu2 = np.asarray(card2["logits"]), np.asarray(cpu2["logits"])
    card_vs_cpu = float(np.abs(card2 - cpu2).max())
    np.testing.assert_allclose(card2, cpu2, atol=1e-4, rtol=1e-4)
    bf16_vs_f32 = float(np.abs(logits[:SLICE_BATCH] - flash32).max())

    # long sequences: 4 rows x 4,096 tokens, one minibatch
    xl = rng.integers(0, SLICE_TRANSFORMER["vocab_size"], size=(4, 4096))
    stage.set(mini_batch_size=4)
    stage.transform(Table({"tokens": xl}))          # warm-up at this shape
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    long_out = np.asarray(stage.transform(Table({"tokens": xl}))["logits"])
    long_s = time.perf_counter() - t0
    long_launches = flash_attention.launches
    assert long_launches == SLICE_TRANSFORMER["num_layers"], long_launches
    assert np.isfinite(long_out).all() and long_out.shape == (4, 8)
    stage.set(mini_batch_size=SLICE_BATCH)

    doc = {"phase": "slice_transformer", "config": SLICE_TRANSFORMER,
           "attention_impl": "flash", "dtype": "bfloat16", "rows": SLICE_ROWS,
           "tokens_per_row": SLICE_TOKENS, "mini_batch_size": SLICE_BATCH,
           "init_seconds": init_s, "serve_seconds": serve_s,
           "rows_per_s": SLICE_ROWS / serve_s, "tokens_per_s": SLICE_ROWS * SLICE_TOKENS / serve_s,
           "flash_launches": launches, "flash_path": path,
           "f32_serve_seconds": serve32_s, "f32_tokens_per_s": SLICE_ROWS * SLICE_TOKENS / serve32_s,
           "f32_flash_launches": launches32, "f32_flash_path": path32,
           "f32_flash_vs_dense_max_abs": flash_vs_dense,
           "card_vs_cpu_max_abs_f32_2rows": card_vs_cpu, "cpu_2rows_seconds": cpu2_s,
           "bf16_vs_f32_flash_max_abs": bf16_vs_f32,
           "long_rows": 4, "long_tokens_per_row": 4096, "long_seconds": long_s,
           "long_tokens_per_s": 4 * 4096 / long_s, "long_flash_launches": long_launches}
    emit(doc)
    return {**doc, "bundle": bundle, "stage": stage, "tokens": x}


# Two small bf16 transformers, K2 on its mma path: TransformerEncoder's
# default width, which bench.py's small transformer also uses (bench.py:628;
# mmlspark_tpu/nn/models.py:176-179), D = 16; and the width of the
# reference's own transformer tests (tests/test_attention.py:136), D = 8
SMALL_TRANSFORMERS = {
    "d16": dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=512, max_len=512,
                num_outputs=8),
    "d8": dict(num_layers=2, d_model=32, num_heads=4, d_ff=64, vocab_size=50, num_outputs=3),
}


# Timed passes of a small transformer. The host sets a pass's time, which
# spreads by ~20% between passes, while K2 is ~3% of it: 400 passes (~20 s)
# bring the rate's standard error to ~1%.
SMALL_PASSES = 400


def pass_rate(seconds: list, tokens_per_pass: int) -> dict:
    """Tokens/s of timed passes as all their tokens over all their seconds
    (a stall counts), with the passes' spread and the rate's relative
    standard error."""
    s = np.asarray(seconds)
    return {"passes": len(s), "tokens_per_s": tokens_per_pass * len(s) / s.sum(),
            "pass_seconds_min": float(s.min()), "pass_seconds_median": float(np.median(s)),
            "pass_seconds_max": float(s.max()),
            "rate_rel_stderr": float(s.std(ddof=1) / np.sqrt(len(s)) / s.mean())}


def serve_small(config: dict, seed: int = 11) -> dict:
    """1,024 rows x 512 token ids through DeepModelTransformer on the card,
    attention_impl="flash" with the bundle's dtype bf16 (not the stage's
    bfloat16 switch, which rounds token ids: ROADMAP Queue 3): one K2 launch
    per layer and minibatch, every one on "mma". The first minibatch is the
    warm-up; then SMALL_PASSES passes over all rows, each checked and
    timed, and one more under torch.profiler: how busy the device is, and
    K2's share of its time."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import ModelBundle
    from mmlspark_tpu_torch.nn.attention import flash_attention

    bundle = ModelBundle.init("transformer", (SLICE_TOKENS,), seed=0, attention_impl="flash",
                              dtype="bfloat16", **config)
    x = np.random.default_rng(seed).integers(0, config["vocab_size"],
                                             size=(SLICE_ROWS, SLICE_TOKENS))
    stage, _ = _serve(bundle, x[:SLICE_BATCH], "cuda", SLICE_BATCH,
                      {"logits": "logits", "prob": "probability"})
    want = SLICE_ROWS // SLICE_BATCH * config["num_layers"]
    n_out = config["num_outputs"]
    seconds = []
    for _ in range(SMALL_PASSES):
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        out = stage.transform(Table({"tokens": x}))
        seconds.append(time.perf_counter() - t0)
        launches, path = flash_attention.launches, flash_attention.last_path
        assert launches == want, f"K2 launched {launches} times, want {want}"
        assert path == "mma", f"the small transformer ran K2's {path} kernel, want mma"
        logits, prob = np.asarray(out["logits"]), np.asarray(out["prob"])
        assert logits.shape == (SLICE_ROWS, n_out) and prob.shape == (SLICE_ROWS, n_out)
        assert np.isfinite(logits).all() and np.isfinite(prob).all()
        assert np.allclose(prob.sum(-1), 1.0, atol=1e-5)
    return {"config": config, "head_dim": config["d_model"] // config["num_heads"],
            **pass_rate(seconds, SLICE_ROWS * SLICE_TOKENS),
            "flash_launches": launches, "flash_path": path,
            "profile": profile_serving(stage, x)}


def phase_small_transformer() -> dict:
    doc = {"phase": "small_transformer", "dtype": "bfloat16", "attention_impl": "flash",
           "rows": SLICE_ROWS, "tokens_per_row": SLICE_TOKENS, "mini_batch_size": SLICE_BATCH,
           **{name: serve_small(cfg) for name, cfg in SMALL_TRANSFORMERS.items()}}
    emit(doc)
    return doc


# Head dims above 128: TransformerEncoder at BERT-base width over the
# importers' default of 4 heads (mmlspark_tpu/nn/import_weights.py:436),
# D = 192, on K2's "wgmma" kernel in bf16 and its "wide" kernel in f32;
# depth cut to 2 layers
WIDE_TRANSFORMER = dict(num_layers=2, d_model=768, num_heads=4, d_ff=3072, vocab_size=16384,
                        max_len=SLICE_TOKENS, num_outputs=8)
# Serving runs at FLASH_SHAPES' d192 rows' shape (minibatches of 4 rows x
# 512 tokens), so the kernel rows time and check the launches it makes;
# WIDE_PASSES passes over slice_transformer's 1,024 rows give the rate and
# its spread
WIDE_BATCH, WIDE_PASSES = 4, 5


def phase_serve_wide() -> dict:
    """1,024 rows x 512 token ids through DeepModelTransformer on the card,
    in bf16 (the bundle's dtype, with the stage's bfloat16 switch off, as
    token models serve: ROADMAP Queue 3) and in f32, WIDE_PASSES timed
    passes each: exactly minibatches x 2 layers K2 launches a pass, every
    one on "wgmma" in bf16 and on "wide" in f32. Then f32 card against CPU
    on 2 rows and f32 flash against f32 dense on the card
    (slice_transformer's gates)."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import ModelBundle
    from mmlspark_tpu_torch.nn.attention import flash_attention

    bundle = ModelBundle.init("transformer", (SLICE_TOKENS,), seed=0, attention_impl="flash",
                              dtype="bfloat16", **WIDE_TRANSFORMER)
    x = np.random.default_rng(12).integers(0, WIDE_TRANSFORMER["vocab_size"],
                                           size=(SLICE_ROWS, SLICE_TOKENS))
    want = SLICE_ROWS // WIDE_BATCH * WIDE_TRANSFORMER["num_layers"]
    n_out = WIDE_TRANSFORMER["num_outputs"]
    doc = {"phase": "serve_wide", "config": WIDE_TRANSFORMER, "attention_impl": "flash",
           "head_dim": WIDE_TRANSFORMER["d_model"] // WIDE_TRANSFORMER["num_heads"],
           "rows": SLICE_ROWS, "tokens_per_row": SLICE_TOKENS, "mini_batch_size": WIDE_BATCH}
    served = {}
    for dtype in ("bfloat16", "float32"):
        b = bundle if dtype == "bfloat16" else _variant(bundle, dtype="float32")
        stage, _ = _serve(b, x[:WIDE_BATCH], "cuda", WIDE_BATCH,
                          {"logits": "logits", "prob": "probability"})
        seconds, total = [], 0
        for _ in range(WIDE_PASSES):
            torch.cuda.synchronize()
            flash_attention.launches = 0
            flash_attention.launches_by_path = {}
            t0 = time.perf_counter()
            out = stage.transform(Table({"tokens": x}))
            seconds.append(time.perf_counter() - t0)
            launches, by_path = flash_attention.launches, dict(flash_attention.launches_by_path)
            assert launches == want, f"{dtype}: K2 launched {launches} times, want {want}"
            kernel = flash_path(getattr(torch, dtype), doc["head_dim"])
            assert by_path == {kernel: want}, f"{dtype}: K2 launches by kernel {by_path}"
            total += launches
            logits, prob = np.asarray(out["logits"]), np.asarray(out["prob"])
            assert logits.shape == (SLICE_ROWS, n_out) and np.isfinite(logits).all()
            assert np.isfinite(prob).all() and np.allclose(prob.sum(-1), 1.0, atol=1e-5)
        served[dtype] = logits
        doc[dtype] = {**pass_rate(seconds, SLICE_ROWS * SLICE_TOKENS),
                      "flash_launches_per_pass": want, "flash_launches": total,
                      "flash_launches_by_path": by_path}
    f32 = _variant(bundle, dtype="float32")
    before = flash_attention.launches
    _, dense = _serve(_variant(bundle, attention_impl="dense", dtype="float32"),
                      x[:SLICE_BATCH], "cuda", WIDE_BATCH)
    assert flash_attention.launches == before, "the dense path launched K2"
    dense = np.asarray(dense["logits"])
    np.testing.assert_allclose(served["float32"][:SLICE_BATCH], dense, atol=1e-4, rtol=1e-4)
    _, card2 = _serve(f32, x[:2], "cuda", 2)
    _, cpu2 = _serve(f32, x[:2], "cpu", 2)
    card2, cpu2 = np.asarray(card2["logits"]), np.asarray(cpu2["logits"])
    np.testing.assert_allclose(card2, cpu2, atol=1e-4, rtol=1e-4)
    doc.update({
        "flash_launches": doc["bfloat16"]["flash_launches"] + doc["float32"]["flash_launches"],
        "f32_flash_vs_dense_max_abs": float(np.abs(served["float32"][:SLICE_BATCH] - dense).max()),
        "card_vs_cpu_max_abs_f32_2rows": float(np.abs(card2 - cpu2).max()),
        "bf16_vs_f32_flash_max_abs": float(np.abs(served["bfloat16"] - served["float32"]).max())})
    emit(doc)
    return doc


def profile_serving(stage, rows) -> dict:
    """Where the serving time goes: `rows` through the stage under
    torch.profiler, device kernel time by name against wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.core import Table

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stage.transform(Table({"tokens": rows}))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us, count = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (us + e.self_device_time_total, count + e.count)
    device_s = sum(us for us, _ in by_name.values()) / 1e6
    flash_s = sum(us for k, (us, _) in by_name.items() if "flash_fwd" in k) / 1e6
    gemm_s = sum(us for k, (us, _) in by_name.items()
                 if any(tag in k.lower() for tag in ("gemm", "nvjet", "xmma", "cutlass"))) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"rows": len(rows), "wall_seconds_profiled": wall_s,
            "device_kernel_seconds": device_s if by_name else None,
            "device_busy_share": device_s / wall_s if by_name else None,
            "flash_kernel_seconds": flash_s if by_name else None,
            "flash_share_of_device": flash_s / device_s if device_s else None,
            "gemm_seconds": gemm_s if by_name else None,
            "top_kernels": [{"name": k[:80], "seconds": us / 1e6, "count": c}
                            for k, (us, c) in top]}


def phase_profile_transformer(stage, x) -> dict:
    """The serving transformer's time, 4 minibatches under torch.profiler."""
    doc = {"phase": "profile_transformer", **profile_serving(stage, x[:4 * SLICE_BATCH])}
    emit(doc)
    return doc


def phase_stage_roundtrip(stage, x) -> dict:
    """The serving stage saved through core.serialize (the bundle as its
    base64 blob) and loaded back serves the same bits."""
    import shutil

    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.core.serialize import load_stage, save_stage

    path = ROOT / "build" / "chip_smoke" / "transformer_stage"
    shutil.rmtree(path, ignore_errors=True)
    rows = Table({"tokens": x[:SLICE_BATCH]})
    t0 = time.perf_counter()
    save_stage(stage, str(path))
    loaded = load_stage(str(path))
    roundtrip_s = time.perf_counter() - t0
    stage_bytes = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    shutil.rmtree(path, ignore_errors=True)
    want = np.asarray(stage.transform(rows)["logits"])
    got = np.asarray(loaded.transform(rows)["logits"])
    assert loaded.get("device") == "cuda" and np.array_equal(got, want), \
        "the loaded stage serves other logits"
    doc = {"phase": "stage_roundtrip", "stage_bytes": stage_bytes,
           "save_load_seconds": roundtrip_s, "same_logits": True}
    emit(doc)
    return doc


def phase_slice_zoo() -> dict:
    """model_zoo/resnet20_digits.model through the port's ModelBundle.load,
    the 1,797 digits images served on the card and on the CPU."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle

    bundle = ModelBundle.load(str(ROOT / "model_zoo" / "resnet20_digits.model"))
    data = np.loadtxt(ROOT / "tests" / "benchmarks" / "data" / "digits.csv",
                      delimiter=",", skiprows=1)
    y = data[:, 0]
    # utils/datagen.py digits_to_images: the bundle's input contract
    img = (np.repeat(data[:, 1:].reshape(-1, 8, 8)[..., None], 3, axis=-1)
           * (255.0 / 16.0)).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        stage = DeepModelTransformer(input_col="image", mini_batch_size=256, device=device,
                                     fetch_dict={"logits": "logits"}).set_model(bundle)
        t0 = time.perf_counter()
        out[device] = np.asarray(stage.transform(Table({"image": img}))["logits"])
        out[device + "_seconds"] = time.perf_counter() - t0
    gap = float(np.abs(out["cuda"] - out["cpu"]).max())
    # f32 convolutions, TF32 off on the card: the order of sums differs only
    np.testing.assert_allclose(out["cuda"], out["cpu"], atol=1e-4, rtol=1e-4)
    acc = float((out["cuda"].argmax(1) == y).mean())
    assert acc > 0.9, acc
    doc = {"phase": "slice_zoo", "model": "resnet20_digits", "rows": len(img),
           "card_vs_cpu_max_abs": gap, "accuracy_all_rows": acc,
           "card_seconds_first_call": out["cuda_seconds"], "cpu_seconds": out["cpu_seconds"]}
    emit(doc)
    return doc


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "mmlspark_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no mmlspark_tpu_torch/ beside {Path(__file__).name}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import mmlspark_tpu_torch  # noqa: F401  (sets the TF32 switches off)

    phase_env()
    phase_build()
    rate = phase_ex2_rate()
    kern = phase_kernels(rate["ex2_per_s"])
    adult = phase_slice_adult()
    phase_profile_adult()
    phase_slice_parity()
    higgs = phase_slice_higgs()
    phase_slice_predict(higgs.pop("booster"), higgs.pop("x"))
    multiclass = phase_slice_multiclass()
    objectives = phase_slice_objectives()
    boosting = phase_slice_boosting()
    phase_slice_boosting_parity()
    early = phase_slice_early_stopping()
    gates = phase_slice_gates()
    categorical = phase_slice_categorical()
    wide_bins = phase_slice_high_cardinality()
    max_bin = phase_slice_max_bin_16383()
    dnn = phase_slice_transformer()
    small = phase_small_transformer()
    wide = phase_serve_wide()
    phase_profile_transformer(dnn["stage"], dnn["tokens"])
    phase_stage_roundtrip(dnn["stage"], dnn["tokens"])
    phase_slice_zoo()

    main_shape = kern["histogram"][0]
    flash_main = kern["flash_attention"][0]
    f32_rows = [r for r in kern["flash_attention"] if r["path"] == "tf32x3"]
    f32_main = next(r for r in f32_rows if r["shape"] == "slice_f32")
    mma_rows = [r for r in kern["flash_attention"] if r["path"] == "mma"]
    mma_main = next(r for r in mma_rows if r["shape"] == "default_bf16")
    wgmma_wide_rows = [r for r in kern["flash_attention"]
                       if r["path"] == "wgmma" and r["D"] > 128]
    wgmma_d192 = next(r for r in wgmma_wide_rows if r["shape"] == "d192_bf16")
    wide_rows = [r for r in kern["flash_attention"] if r["path"] == "wide"]
    wide_main = next(r for r in wide_rows if r["shape"] == "d192_f32")
    emit({"kernels": [{
        "name": "histogram",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/hist_kernel.cu",
        "replaces": "mmlspark_tpu/gbdt/hist_kernel.py:227",
        # every fit of the main path: Adult, Higgs, digits multiclass, the
        # five objectives, the Adult fits under each boosting type, the
        # early-stopped fit and its warm start, the 28 gate fits, the
        # categorical Adult and Amazon-access fits (B 256 and 1024) and the
        # numeric Adult fit at max_bin 16383 (B 16,384)
        "launches": (adult["histogram_launches"] + higgs["histogram_launches"]
                     + multiclass["histogram_launches"] + objectives["histogram_launches"]
                     + boosting["histogram_launches"] + early["histogram_launches"]
                     + early["warm_start_launches"] + gates["histogram_launches"]
                     + categorical["histogram_launches"] + wide_bins["histogram_launches"]
                     + max_bin["histogram_launches"]),
        "launches_by_fit": {"adult": adult["histogram_launches"],
                            "higgs": higgs["histogram_launches"],
                            "multiclass": multiclass["histogram_launches"],
                            "objectives": objectives["histogram_launches"],
                            **{f"adult_{name}": fit["histogram_launches"]
                               for name, fit in boosting["fits"].items()},
                            "early_stopping": early["histogram_launches"],
                            "warm_start": early["warm_start_launches"],
                            "gates": gates["histogram_launches"],
                            "categorical": categorical["histogram_launches"],
                            "high_cardinality": wide_bins["histogram_launches"],
                            "max_bin_16383": max_bin["histogram_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in kern["histogram"]),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": main_shape["shape"],
        "host_us_per_call": main_shape["host_us_per_call"],
        "host_enqueue_us": main_shape["host_enqueue_us"],
        "empty_launch": kern["histogram_empty_launch"],
        "shapes": kern["histogram"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attn.cu",
        "replaces": "mmlspark_tpu/nn/attention.py:192",
        # the wgmma kernel: the bf16 serving transformer (D 64) and the
        # bf16 wide transformer (D 192)
        "launches": dnn["flash_launches"] + wide["bfloat16"]["flash_launches"],
        "launches_by_phase": {"slice_transformer": dnn["flash_launches"],
                              "serve_wide_bf16": wide["bfloat16"]["flash_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in kern["flash_attention"]),
        "ms": flash_main["ms"],
        "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound_ms"],
        "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["library_ms"],
        "shape": flash_main["shape"],
        "path": flash_main["path"],
        # its rows above head dim 128, d192 (serve_wide's) first
        "wide_rows": [{key: r[key] for key in ("shape", "D", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "max_abs_err")}
                      for r in [wgmma_d192] + [r for r in wgmma_wide_rows if r is not wgmma_d192]],
        "shapes": kern["flash_attention"],
    }, {
        # the same wrapper and TPU kernel; the CUDA kernel every f32 bundle
        # serves through, with its launches from the f32 serving run
        "name": "flash_attention_tf32x3",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attn.cu",
        "replaces": "mmlspark_tpu/nn/attention.py:192",
        "launches": dnn["f32_flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in f32_rows),
        "ms": f32_main["ms"],
        "plain_ms": f32_main["plain_ms"],
        "bound_ms": f32_main["bound_ms"],
        "bound_by": f32_main["bound_by"],
        "library_ms": f32_main["library_ms"],
        "shape": f32_main["shape"],
        "path": f32_main["path"],
    }, {
        # the same wrapper and TPU kernel; the CUDA kernel every bf16 bundle
        # with head dim 8, 16 or 32 serves through, with its launches from
        # the small transformer at TransformerEncoder's default width
        "name": "flash_attention_mma",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attn.cu",
        "replaces": "mmlspark_tpu/nn/attention.py:192",
        "launches": small["d16"]["flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in mma_rows),
        "ms": mma_main["ms"],
        "plain_ms": mma_main["plain_ms"],
        "bound_ms": mma_main["bound_ms"],
        "bound_by": mma_main["bound_by"],
        "library_ms": mma_main["library_ms"],
        "exp_ms": mma_main["exp_ms"],
        "shape": mma_main["shape"],
        "path": mma_main["path"],
    }, {
        # the same wrapper and TPU kernel; the CUDA kernel of f32 above head
        # dim 128 and bf16 above 256, with its launches from serve_wide's
        # f32 run
        "name": "flash_attention_wide",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attn.cu",
        "replaces": "mmlspark_tpu/nn/attention.py:192",
        "launches": wide["float32"]["flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in wide_rows),
        "ms": wide_main["ms"],
        "plain_ms": wide_main["plain_ms"],
        "bound_ms": wide_main["bound_ms"],
        "bound_by": wide_main["bound_by"],
        "library_ms": wide_main["library_ms"],
        "exp_ms": wide_main["exp_ms"],
        "shape": wide_main["shape"],
        "path": wide_main["path"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
