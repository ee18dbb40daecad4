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
16,384 bins), checkpointed, preempted and resumed Adult fits, the
LightGBM model.txt files of model_zoo/ scored on the card and boosters
exported to model.txt and read back; and
DeepModelTransformer serving 1,024 rows x 512 token ids through bench.py's
accelerator transformer (8 layers, d_model 512, 8 heads, vocab 16,384) with
attention_impl="flash", in bf16 and in f32, through two small bf16
transformers (head dims 16 and 8) and through a BERT-base-wide one (head
dim 192), transfer learning (an image chain on ImageTransformer,
torchvision-named ResNet-50 weights imported through ModelDownloader and
featurized at 224 by ImageFeaturizer, an encoder at BERT-base's widths
imported and served), a CSV at UCI Adult's schema read on the native
parser and fitted through CleanMissingData -> TrainClassifier, a hashed
text corpus through TextFeaturizer -> GBDTClassifier, a fused
CleanMissingData -> AssembleFeatures -> GBDTRegressor -> DataConversion
pipeline scoring 1,048,576 rows from CUDA graphs, that regressor and the
transformer served over HTTP by serve_model, then each on two replica
processes of a ServingFleet behind a ServingGateway, DNNLearner
training that transformer and ResNet-50, and recommendation and AutoML
(SAR at MovieLens-1M's shape and its resident top-k server, the ranking
stages, TuneHyperparameters, FindBestModel, the hyperband sweep over
worker processes, ImageLIME over ResNet-50), and streaming and the phase
profiler (that transformer and the Adult scorer in checkpointed
StreamingQuery and ParallelStreamingQuery runs, the profiler armed on a
server) — and
shows through the kernels' launch counters that each path ran on its
kernel. It prints one JSON line per phase:

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
               their time at the measured ex2 rate; K1 at one shape and
               K2 at the serving shape each captured in a CUDA graph and
               replayed on new inputs, equal to the eager call bit for bit
  slice_adult  the GBDT path: fit seconds, launches (must be 3,100),
               train accuracy > 0.7, held-out AUC > 0.75, and the card's
               scores equal to the host walk bit for bit
  profile_adult a 3-round Adult fit under torch.profiler: device kernel
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
               rf and dart, 25 rounds: each fit's seconds, 775 launches, train
               accuracy > 0.7, held-out AUC > 0.75, card scores equal to
               the host walk; first, two rounds of each loop under sync
               debug mode "error" (nothing read back)
  slice_boosting_parity  the random draws (bag, goss, feature and drop
               keys of rounds 0, 1, 7, 99) at 32,768 and 1,048,576 rows on
               the card and the CPU, bit for bit; the Adult data fitted on
               "cpu" and "cuda" for 5 rounds under each boosting type:
               the bags, feature masks and drop sets the loops used
               (fused.round_hook) equal every round, GOSS's row weights up
               to the first parting tree; the card's trees meet
               compare_fits at 1e-5 through the CPU's row-order histogram
               and at 1e-4 through K1; a draw's host microseconds and
               device ms at both sizes; then the same two rules for l1,
               quantile and mape under bagged gbdt, goss and dart (5
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
               committed CSVs (21,600 launches); the same fits on the CPU
               (gbdt and goss at 10 rounds), their trees and the card's by
               compare_fits at 1e-4
  slice_categorical  UCI Adult's schema (6 numeric columns, 8 categorical
               at adult.names's cardinalities, "?" as NaN): 32,768 rows
               through GBDTClassifier(categorical_slot_indexes=...), 50
               rounds of 31 leaves (1,550 launches), held-out AUC > 0.75,
               accuracy > 0.7, card scores = the host walk, category
               subsets of many; sync-free rounds; 5 rounds CPU against card
  slice_high_cardinality  the Amazon Employee Access schema (9
               categorical columns, up to 7,518 categories): max_bin 1023
               with uint8 asked for (the reference's warning, int32 bins),
               K1 at 1,024 bins (1,550 launches), held-out AUC above a
               constant's, card = host walk; 5 rounds CPU against card,
               and the numeric Adult shape at max_bin 511 likewise
  slice_max_bin_16383  the numeric Adult shape at max_bin 16383: K1 at
               16,384 bins in bin ranges (1,550 launches), held-out AUC >
               0.75, accuracy > 0.7, card = host walk; 5 rounds CPU
               against card
  slice_checkpoint  the Adult shape through GBDTClassifier (seed 3,
               bagging 0.8 every 3 rounds): uninterrupted; with
               checkpoint_every_n 10 (chunks of 9, aligned to the bag);
               preempted after the 5th snapshot (Preempted, exit code 75)
               and resumed by a fresh estimator; goss with
               checkpoint_every_n 7 and its uninterrupted twin: to_text()
               equal byte for byte to the uninterrupted fit's, the resumed
               fit's card scores equal bit for bit, 1,550 K1 launches a fit
               (50 rounds; 7,750); fit seconds, each snapshot's write seconds and
               bytes, the resume's restore seconds
  slice_lightgbm_import  model_zoo/gbdt_*.model (LightGBM model.txt)
               loaded on the card by load_native_model: the adult-census
               model's held-out AUC 0.91478 (index.json, 5 places), wdbc's
               AUC > 0.97 and diabetes's RMSE < 62.0 on the zoo's split;
               its fused bin -> traverse program over 1,048,576 f32 rows
               equal to predict_raw bit for bit (rows/s end to end and
               resident); slice_adult's and slice_categorical's boosters
               through to_lightgbm_text -> from_lightgbm_text within rtol
               1e-6, atol 1e-7; parse and export seconds
  slice_mesh   distributed GBDT: 4 spawned ranks on the one card over gloo
               (parallel.RankPool), each fitting slice_adult's data on its
               8,192 rows through GBDTClassifier(use_mesh=True), 10 rounds,
               under data_parallel, deterministic, voting_parallel (top_k
               5) and bagged gbdt: every rank's model one text, 310 K1
               launches a rank, held-out AUC > 0.75 (within 0.01 of
               slice_adult's first 10 rounds for the first two),
               data_parallel against those 10 trees of slice_adult's
               booster and every fit against 4 CPU ranks' 5-round fit by
               compare_fits at 1e-4; fit seconds, collectives, bytes merged
               and their host-timed share; then a one-rank mesh on NCCL,
               its fit equal to slice_adult's byte for byte
  slice_fusion_mesh  fused pipelines under a mesh of several ranks on
               slice_mesh's 4 card ranks (handed on, not spawned again),
               each part held against the same model's one-process fused
               transform on the card: (a) the Adult regressor (fitted here
               for slice_serving too) fused on a data mesh of 4 over
               1,048,576 f32 rows in chunks of 65,536: every rank's
               predictions byte-equal to one process's, mesh "4x1", no
               capture, miss or recompile on a second transform; (b) the
               serving transformer (bf16, flash) fused on the data mesh,
               256 x 512 tokens at minibatch 64: within 1e-4, K2 exactly 8
               x each rank's fused forwards, all on "wgmma"; (c) an f32
               MLP (1,024 -> 4,096 -> 4,096 -> 8) fused on a 2 x 2 data x
               model mesh, 4,096 rows: within 2e-4, placements ["custom"],
               eager; (d) serve_model of (b)'s model with the mesh: shard
               0 serves 128 requests of 512 ids from 16 keep-alive
               clients, every reply within 1e-4, every rung divisible by
               4, the followers stop; (e) a StreamingQuery of (a)'s model
               over 8 micro-batches of 8,192 rows on the mesh: the sink
               byte-equal to the one-rank query's; each part's ms at the
               slowest rank, the bytes its collectives moved, and the
               shard-skew ratio
  slice_parallel  the P4 layers on slice_mesh's 4 card ranks (handed on,
               not spawned again): ring and Ulysses attention on a seq axis
               of 4 (T 8,192, H 8, D 64, f32, causal and not, local_chunk
               512) against chunked_attention, the tensor-parallel MLP on a
               model axis of 4 (4,096 x 1,024, hidden 4,096), the GPipe
               pipeline (4 stages of d 1,024, batch 256, 8 microbatches)
               and MoE (8 experts on 4 ranks, 4,096 tokens, d 512, h 2,048,
               capacity 1.25) against their one-rank counterparts on the
               card, and DeepModelTransformer(use_mesh=True) serving the
               slice transformer on a data axis of 4 (256 x 512 tokens)
               within 1e-4 of one process, 32 K2 launches on wgmma in every
               rank; each layer's ms and the bytes its collectives moved
  slice_transformer  the DNN path: tokens/s, K2 launches (must be 128,
               on "wgmma"), finite logits, probabilities summing to 1; the
               same 1,024 x 512 tokens served in f32 (128 launches on
               "tf32x3", f32 tokens/s); f32 flash against f32 dense on the
               card, card against CPU on 2 rows, bf16 against f32; 4 rows
               x 4,096 tokens (8 launches)
  small_transformer  1,024 rows x 512 tokens in bf16 through
               TransformerEncoder's default width (d_model 64, 4 heads of
               16) and the reference tests' width (d_model 32, 4 heads of
               8), 2 layers each: 32 K2 launches on "mma" in each of 100
               passes, tokens/s of all of them with their spread, and one
               pass profiled (device busy share, K2's share)
  serve_wide   1,024 rows x 512 tokens at minibatch 4 through a 2-layer
               TransformerEncoder of d_model 768 over 4 heads (D = 192) in
               bf16 and in f32, 3 timed passes each: 512 K2 launches a
               pass, all on "wgmma" in bf16 and on "wide" in f32; f32 card
               against CPU and flash against dense
  profile_transformer  4 minibatches under torch.profiler: K2's and the
               GEMMs' share of device time, device busy share
  stage_roundtrip  the serving stage saved and loaded through
               core.serialize serves the same logits
  slice_zoo    model_zoo/resnet20_digits through ModelDownloader (its
               index.json sha256 checked) on the card against the CPU
  slice_featurize  transfer learning: (a) 512 seeded uint8 images of 256 x
               256 through ImageTransformer's resize(224) -> crop(192) ->
               flip -> gray -> blur(3) -> gaussian(5) -> threshold(100) on
               the card and the CPU (1e-3 before the threshold; equal past
               its edge), the chain's and the resize's ms, UnrollImage's
               shape; (b) tests/test_import_weights.py's torchvision-named
               ResNet-50 through ModelDownloader.import_external ->
               load_bundle, its logits held to the committed fixture on
               the card, then ImageFeaturizer (pooled_features, minibatch
               64) over the 512 images resized to 224 on the card: (512,
               2048) finite, 8 images card = CPU within 1e-4 of the
               largest, images/s; (c) the tiny imported encoder held to
               its fixture (dense and flash), then an encoder at
               BERT-base's published widths imported with 12 heads, flash,
               bf16: 1,024 x 512 tokens, exactly 192 K2 launches on
               "wgmma", tokens/s; its weights in f32, card = CPU on 4 x 128
               tokens (K2 on "tf32x3")
  slice_tabular  tabular ingest, featurization and text: (a) 40,960 rows
               of make_adult_categorical written as adult.data is (", ",
               level strings, "?", ~1% blank hours-per-week, income as
               ">50K" / "<=50K") read by read_csv on the native parser
               (which must run), equal to the csv module's table bit for
               bit, MB/s of both; (b) CleanMissingData -> TrainClassifier
               (GBDTClassifier, 100 rounds of 31 leaves) on 32,768 rows:
               108 featurized columns, exactly 3,100 K1 launches, held-out
               AUC > 0.75 and accuracy > 0.7, card scores = the host walk,
               the saved and loaded PipelineModel scoring alike; 5 rounds
               on "cpu" and "cuda" (the first 3,072 rows): equal matrices,
               trees by compare_fits at 1e-4 through K1 and 1e-5 through
               the row-order histogram; a fit from Cacher(device="cuda")'d
               columns = the f32 host fit's to_text; (c) 8,192 seeded
               documents through TextFeaturizer (4,096 hashed features,
               IDF) -> GBDTClassifier (20 rounds, exactly 620 K1 launches
               at F 4,096), held-out AUC > 0.75, card = host walk, 2 rounds
               on "cpu" and "cuda" (the first 512 documents)
  slice_serving  pipeline fusion and serving: a GBDTRegressor fitted on
               the Adult shape (exactly 3,100 K1 launches); (a) 1,048,576
               rows of 14 f32 columns (1% NaN in one) through
               fuse(CleanMissingData -> AssembleFeatures -> the regressor
               -> DataConversion), one fused segment of 4 stages replayed
               from CUDA graphs in 65,536-row chunks, equal to the staged
               transform byte for byte, no capture on a second run, rows/s
               of both; (b) serve_model of the regressor over HTTP,
               keep-alive clients at concurrency 1, 32 and 256 (512
               requests each) and a pass forced onto the resident route,
               every reply equal to make_reply of the staged transform,
               64 binary-wire requests, server and client p50/p99; (c) the
               serving transformer (bf16 bundle, flash) in a fused
               pipeline over HTTP, 1,024 requests of 512 token ids (half
               JSON, half binary wire) at concurrency 64: K2 on "wgmma"
               8 times a fused forward (graph replays included), the
               hot path never disabled, probabilities summing to 1,
               tokens/s, and 256 rows fused against the staged transform
  slice_fleet  the serving fleet (after slice_serving, whose regressor and
               transformer it serves again): (a) the regressor on two
               ServingFleet replicas (spawned processes, a CUDA context
               each) behind a ServingGateway, 1,024 requests through the
               gateway at concurrency 32 and 256 straight at a replica,
               every reply equal to make_reply of the parent's transform,
               the rendezvous totals equal to the replicas' own counters,
               a kill window (100 requests, a replica SIGKILLed, 200 more:
               no client-visible error), respawn, a rolling swap under
               load (no error, the same bytes), the stop; nvidia-smi's
               context count follows every spawn, kill and stop; (c) an
               SLOEngine, a TimelineRecorder and a FleetAutoscaler over
               that fleet; (b) the transformer on two replicas behind a
               gateway, 256 requests at concurrency 16, probabilities
               within 1e-4 of the staged transform, K2's wgmma launches = 8
               x each replica's fused forwards, read back from the replica
  slice_train  DNN training through DNNLearner: bench.py's transformer at
               its training width (8 layers, d_model 512, flash core in
               bf16, adamw, 32 x 512 tokens a step), 2 epochs of 32 steps
               (512 K2 launches, all on "wgmma", falling loss) and one under
               remat (512 launches); bench_trainer's ResNet-50 fine-tune
               (512 uint8 images of 224 x 224, batch 64, 2 epochs; its
               BatchNorm statistics move); a small f32 flash transformer
               on the CPU and the card (first-step gradients at the flash
               gradient gate, parameters after 2 epochs), fused = streamed
               = resumed byte for byte, 2 gloo ranks sharing the card
               (equal parameters); and K2's forward + ported backward
               against the plain forward + the same backward and SDPA
  slice_recsys_automl  recommendation and AutoML: (a) MovieLens-1M's
               shape seeded (6,040 users, 3,706 movies, 1,000,209 ratings
               over three years) through RecommendationIndexer ->
               SAR(jaccard, time decay) on the card and the CPU, the
               similarity bit-equal, recommend_for_all_users(k=10) within
               1e-5 of each row's largest rating (ids equal off near-ties),
               blocks of 1,000 = blocks of 4,096 byte for byte, and
               RankingAdapter / RankingEvaluator / RankingTrainValidationSplit
               on each user's last 10% by time; (b) serve_model(sar_model)
               (delegated to serve_recommender) forced onto the sar_resident
               route and with hot_path=False, 2,048 requests from 32
               keep-alive clients: the two servers' replies byte-equal and
               equal to (a)'s recommendations, the route never disabled;
               (c) TuneHyperparameters over GBDTClassifier on the Adult
               shape (learning rate x num_leaves, 5 rounds, 2 folds, 2
               threads, a trial ledger), K1 launches exact, FindBestModel
               against a default model (held-out AUC > 0.75), a resumed run
               skipping every trial, one fold's fit card vs CPU; (d) the
               hyperband sweep of bench.py:2556-2625 on the Adult shape at
               P=1, P=2 (ServingFleet worker processes sharing the card)
               and P=2 with a worker SIGKILLed: equal digests, one bin
               build a worker; (e) ImageLIME over the imported ResNet-50 at
               224 (2 images, 300 samples, 196 superpixels): superpixels
               card = CPU off near-ties, weights finite and bit-equal over
               two runs
  slice_streaming  the phase profiler and streaming: (a) the serving
               transformer behind a batch-mode ServingServer (a journal),
               streamed by a checkpointed StreamingQuery that fuses it:
               256 requests from 32 clients (half JSON, half the binary
               wire), each answered once, each micro-batch within 1e-4 of
               the staged transform, K2 on wgmma 8 a fused forward; 64 more
               parked, 2 micro-batches answered, the query and server
               stopped, the rest re-parked from the journal and answered
               once by a query restarted on the same checkpoint; (b)
               slice_tabular's Adult CSV in 8 files through DirectorySource
               -> the fused Adult scorer -> ForeachBatchSink, stopped after
               2 batches, the other 6 by a second query, byte-equal to one
               transform; (c) that scorer, KeyedShuffle, then a
               GroupedAggregator and a WindowedAggregator at 4 thread
               partitions, byte-equal to P = 1; (d) the grouped query on 2
               ServingFleet worker processes (binary wire), one SIGKILLed
               and respawned, byte-equal to P = 1, no new CUDA context; (e)
               the phase profiler armed on serve_model's transformer:
               resident ledgers' coverage of their RTT in 0.85-1.15, a
               compute phase, K2 = 8 x forwards armed and disarmed, the
               attribution table, a torch.profiler trace of 4 fused
               forwards. No K1 launch
  slice_elastic  elastic training on ServingFleet worker processes: (a)
               ElasticGBDTFit of the Adult shape (32,768 x 14, 7 rounds
               of 31 leaves, 8 virtual shards, 2 workers building host
               histograms: 0 K1 launches in the driver, no context on the
               card), (b) ElasticDNNFit of an MLP ([256, 256], input width
               108, 6,144 rows, batch 256, 24 steps, 2 workers on the
               card); each with worker 0 SIGKILLed mid-fit and respawned
               later, its model digest equal to an undisturbed P=1 fit's
               through in-process handlers; the GBDT's card scores = its
               host walk and held-out AUC > 0.75, the DNN's first merged
               gradient card = CPU at the trainer gate (rtol 2e-4, atol
               2e-5); fit, spawn and respawn seconds, re-shards, steps/s

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
import shutil
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


_STARTED = time.perf_counter()


def emit(doc: dict) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (`at_s`), so differences give each phase's wall time."""
    if "phase" in doc:
        doc = {**doc, "at_s": time.perf_counter() - _STARTED}
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
# the Higgs grid with gathered rows (3% kept); slice_tabular's featurized
# fits, whose feature groups also lie along grid_y: the one-hot Adult
# matrix (F = TABULAR_F) and the hashed text matrix (F 4,096 at TEXT_BINS,
# the bins its mapper gives). Above 256 bins (int32 bins;
# max_bin 511 gives 512, 1023 gives 1024, 16383 gives 16,384): the Adult
# shape at B 512, 1024 and 4096 (with every row kept and 3%), a ragged n at
# 1024, the Amazon-access shape slice_high_cardinality fits (32,769 x 9 at
# 1024) and the Higgs shape at 1024, whose blocks own a feature group and
# all its bins ("split"); the Adult shape at 16,384 (slice_max_bin_16383's
# calls), whose blocks own a range of them ("ranges"), and at 65,536, one
# block along the rows of each range ("one_block")
TABULAR_F = 108          # the one-hot Adult matrix's width (6 numeric, 102 levels)
TEXT_BINS = 27           # the bins the text fit's mapper gives its 4,096 columns
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
    ("tabular_f108_int32", 32768, TABULAR_F, torch.int32, 1.0, 256),
    ("text_f4096", 6144, 4096, torch.int32, 1.0, TEXT_BINS),
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
# heads) takes "wide" in both dtypes. "bert_bf16" is slice_featurize's
# imported BERT-base-wide encoder (d_model 768 over its 12 heads) at its
# minibatch of 64 rows x 512 tokens: wgmma at D 64.
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
    ("bert_bf16", 64, 512, 512, 12, 64, torch.bfloat16, False),
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
            if name == FLASH_GRAPH_SHAPE:
                rows[-1]["graph_replays_eager_bits"] = _flash_graph_replays(q, k, v, causal)
            del q, k, v, out, out2, lse, lse2, p_out, p_lse
    assert any(r.get("graph_replays_eager_bits") for r in rows), "no K2 shape replayed in a graph"
    return rows


# the shape slice_serving's fused segments replay K2 at (64 rows of the
# serving transformer: B 64, T 512, H 8, D 64, bf16, wgmma)
FLASH_GRAPH_SHAPE = "slice_bf16"


def _flash_graph_replays(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> bool:
    """K2 captured in a CUDA graph, then replayed on new q, k, v written
    into the captured inputs: each replay gives the eager call's bits."""
    from mmlspark_tpu_torch.nn.attention import _flash_fwd_lse

    q, k, v = q.clone(), k.clone(), v.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _flash_fwd_lse(q, k, v, causal)            # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, lse = _flash_fwd_lse(q, k, v, causal)
    equal = True
    for seed in (1, 2):
        g = torch.Generator(device="cuda").manual_seed(seed)
        for t in (q, k, v):
            t.copy_(torch.randn(t.shape, generator=g, device="cuda").to(t.dtype))
        graph.replay()
        torch.cuda.synchronize()
        e_out, e_lse = _flash_fwd_lse(q, k, v, causal)
        equal = equal and torch.equal(out, e_out) and torch.equal(lse, e_lse)
    assert equal, "K2 replayed in a CUDA graph differs from the eager call"
    return equal


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
    return {**doc, "booster": model.booster, "x_valid": xv}


# profile_adult's rounds: 3 (10, then 5, until the smoke's time ran short on
# slower card hosts)
PROFILE_ROUNDS = 3


def phase_profile_adult() -> dict:
    """Where the Adult fit's time goes: a PROFILE_ROUNDS-round fit under torch.profiler,
    the device time of every kernel summed by name against the fit's wall
    time. The profiler slows the host, so the busy share it gives is a
    lower bound of the unprofiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions

    x, y = make_dataset(32768, 14)
    opts = TrainOptions(objective="binary", num_iterations=PROFILE_ROUNDS, num_leaves=31,
                        device="cuda")
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
    doc = {"phase": "profile_adult", "rounds": PROFILE_ROUNDS, "num_leaves": 31,
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
    # features too: tests/test_gbdt.py's 4-class data, 10 rounds of 4 trees
    # (20 until the smoke's time ran short on slower card hosts)
    xc, yc = make_classification(classes=4)
    fits4 = {dev: Booster.train(xc, yc, TrainOptions(
        objective="multiclass", num_class=4, num_iterations=10, num_leaves=leaves, device=dev))
        for dev in ("cpu", "cuda")}
    parity4 = compare_fits(fits4["cpu"], fits4["cuda"], fits4["cpu"].bin_mapper.transform(xc))
    assert parity4["trees_compared"] > 0, f"no 4-class tree compared: {parity4['near_ties']}"
    doc = {"phase": "slice_multiclass", "rows": cut, "held_out_rows": len(x) - cut,
           "features": x.shape[1], "classes": k, "rounds": rounds, "num_leaves": leaves,
           "fit_seconds": fit_s, "histogram_launches": launches, "held_out_accuracy": acc,
           "jax_held_out_accuracy": DIGITS_JAX_ACCURACY, "card_equals_host_walk": True,
           "parity_3_rounds": parity, "parity_4_class_10_rounds": parity4}
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


def boosting_gate(suite: str, device: str, datasets=None, models=None,
                  rounds: "dict | None" = None) -> list:
    """tests/benchmarks/test_gbdt_benchmarks.py:41-84 through the port on
    `device`: for each data set of the suite (all, or the names in
    `datasets`) and each boosting type, GBDTClassifier (held-out accuracy)
    or GBDTRegressor (held-out RMSE) with 30 rounds of 15 leaves,
    bagging_fraction 0.85 every round and seed 42, fitted on the first 75%
    of the rows. Each row holds its value beside
    tests/benchmarks/benchmarks_<suite>.csv's baseline and precision; the
    committed files are read, nothing is written. `models`, a dict, gets
    each row's (booster, fitted rows) under its name. `rounds` sets other
    rounds by boosting type (a gate row then holds no gate)."""
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
            model = est(boosting_type=boosting, num_iterations=(rounds or {}).get(boosting, 30),
                        num_leaves=15,
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


# rounds of slice_boosting's Adult fits: 25 (100, then 50, until the smoke's
# time ran short on slower card hosts)
BOOSTING_ROUNDS = 25


def phase_slice_boosting() -> dict:
    """The Adult shape through GBDTClassifier on the card under each
    boosting type: BOOSTING_ROUNDS rounds of 31 leaves, so 775 K1
    launches a fit."""
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    n, n_valid, f, rounds, leaves = 32768, 8192, 14, BOOSTING_ROUNDS, 31
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


# rounds of the CPU-against-card fits of the categorical, high-cardinality,
# max_bin 16383, renewed-objective and tabular paths: 3 (10, then 5, until
# the smoke's time ran short on slower card hosts; a tree of round r
# depends on no later round)
PARITY_ROUNDS = 3


def cpu_card_parity(x, y, kw: dict, rounds: int = PARITY_ROUNDS,
                    ties: "dict | None" = None) -> dict:
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


# rounds of the Adult CPU-against-card fits under each boosting type: 3 (10,
# then 5, until the smoke's time ran short; a tree of round r depends on no
# later round, so 3 rounds check the first 3 of those trees)
BOOSTING_PARITY_ROUNDS = 3


def phase_slice_boosting_parity() -> dict:
    """The card's draws are the CPU's. `prng.uniform` for the bag, GOSS,
    feature and drop keys of several rounds at 32,768 and 1,048,576 rows,
    bit for bit. Then the Adult data fitted on "cpu" and on "cuda" for
    BOOSTING_PARITY_ROUNDS rounds under each boosting type, the random parts each tree grew from
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
    rounds = BOOSTING_PARITY_ROUNDS
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
    on airfoil_like, PARITY_ROUNDS rounds of 15 leaves each (cpu_card_parity); early
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


# the CPU comparison fits of slice_gates under gbdt and goss (30 until the
# smoke's time ran short on slower card hosts)
GATE_CPU_ROUNDS = 10


def phase_slice_gates() -> dict:
    """tests/benchmarks/test_gbdt_benchmarks.py:41-84 on the card: 16
    classifier and 12 regressor fits, each row within its precision; then
    the same fits on the CPU (gbdt and goss at GATE_CPU_ROUNDS rounds),
    whose trees the card's meet by compare_fits at 1e-4."""
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
    # gains are f32 noise (gain_floor). gbdt and goss fit GATE_CPU_ROUNDS
    # rounds there, against the card fits' first trees (a tree of their
    # round r depends on no later round; rf and dart rescale earlier trees,
    # so they fit all 30)
    cpu = {}
    t0 = time.perf_counter()
    cpu_rounds = {"gbdt": GATE_CPU_ROUNDS, "goss": GATE_CPU_ROUNDS}
    boosting_gate("classifier", "cpu", models=cpu, rounds=cpu_rounds)
    boosting_gate("regressor", "cpu", models=cpu, rounds=cpu_rounds)
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


# the counted card fits of slice_categorical, slice_high_cardinality and
# slice_max_bin_16383 (100 rounds until the smoke's time ran short on
# slower card hosts)
CARD_FIT_ROUNDS = 50


def _card_fit(x, y, xv, yv, params: dict, rounds: int = CARD_FIT_ROUNDS, leaves: int = 31):
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
    GBDTClassifier(categorical_slot_indexes=...): CARD_FIT_ROUNDS (50)
    rounds of 31 leaves at max_bin 255, so 1,550 K1 launches; held-out AUC > 0.75 and accuracy
    > 0.7 (bench.py's canaries); card scores equal to the host walk; at
    least one categorical node with a subset of more than one category;
    two rounds of each loop under sync debug mode "error"; and PARITY_ROUNDS rounds
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
           "features": x.shape[1], "categorical_slots": cats, "rounds": CARD_FIT_ROUNDS, "num_leaves": 31,
           "max_bin": 255, "sync_free_rounds": sync_free, **fit,
           "parity": {"rounds": PARITY_ROUNDS, **parity}}
    emit(doc)
    return {**doc, "booster": booster, "x_valid": xv}


def phase_slice_high_cardinality() -> dict:
    """The Amazon Employee Access Challenge's schema (make_amazon_access:
    9 categorical columns at train.csv's cardinalities, ~94% ACTION 1) on
    its 32,769 rows, 8,192 more held out, through GBDTClassifier with
    max_bin 1023 and bin_dtype "uint8" asked for: the reference's warning
    and int32 bins; the three widest columns keep their 1,023 most frequent
    categories, so K1 runs at B 1024 ("rows": one copy of 9 warps), 1,550
    launches; held-out AUC above a constant predictor's; card scores equal
    to the host walk; two rounds of each loop under sync debug mode
    "error"; PARITY_ROUNDS rounds on "cpu" and "cuda" (cpu_card_parity, K1 with
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
           "features": x.shape[1], "positive_share": float(y.mean()), "rounds": CARD_FIT_ROUNDS,
           "num_leaves": 31, "max_bin": 1023, "bin_dtype_asked": "uint8", "k1_plan": plan.branch,
           "sync_free_rounds": sync_free, **fit, "parity": {"rounds": PARITY_ROUNDS, **parity},
           "adult_numeric_max_bin_511_parity": {"rounds": PARITY_ROUNDS, **numeric}}
    emit(doc)
    return doc


def phase_slice_max_bin_16383() -> dict:
    """The numeric Adult shape (make_dataset: 32,768 rows fitted, 8,192 held
    out) through GBDTClassifier(max_bin=16383): its 12 continuous columns
    take 16,384 bins, past the ~14,000 of one feature a block that K1 held
    before bin ranges; CARD_FIT_ROUNDS (50) rounds of 31 leaves, so 1,550 launches, all at
    B 16,384 int32; held-out AUC > 0.75 and accuracy > 0.7 (bench.py's
    canaries); card scores equal to the host walk; PARITY_ROUNDS rounds on "cpu" and
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
           "rounds": CARD_FIT_ROUNDS, "num_leaves": 31, "max_bin": 16383, "k1_plan": plan._asdict(),
           "k1_branch": plan.branch, **{k: v for k, v in fit.items() if "categorical" not in k
                                        and k != "largest_subset"},
           "splits_past_bin_14376": int((booster.threshold_bin[split] > 14376).sum()),
           "splits": int(split.sum()), "parity": {"rounds": PARITY_ROUNDS, **parity}}
    emit(doc)
    return doc


# slice_checkpoint's fits: 50 rounds (100 until the smoke's time ran short
# on slower card hosts); the 5th snapshot of a chunked fit still lands at
# round 45
CHECKPOINT_ROUNDS = 50


def phase_slice_checkpoint() -> dict:
    """Checkpointed, preemptible fits on the card, at the Adult shape
    (32,768 x 14, CHECKPOINT_ROUNDS (50) rounds of 31 leaves, seed 3,
    bagging 0.8 every 3 rounds) through GBDTClassifier: (a) uninterrupted; (b) with
    checkpoint_every_n 10, which runs chunks of 9 rounds (aligned to the
    bag) with a snapshot after each; (c) the same under a guard that drains
    after the 5th snapshot (Preempted, exit code 75), then resumed to the
    end by a fresh estimator; (d) goss with checkpoint_every_n 7 against its
    own uninterrupted fit. (b), (c) and (d) give their uninterrupted fit's
    to_text() byte for byte, (c)'s card scores are (a)'s bit for bit, and
    every fit launches K1 exactly rounds x 31 times ((c): the preempted part
    plus the resumed part). Prints each fit's seconds, each snapshot write's
    seconds and bytes, and the resume's restore seconds."""
    from unittest import mock

    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt import booster as booster_mod
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
    from mmlspark_tpu_torch.resilience.elastic import (Preempted, PreemptionGuard,
                                                       TrainingCheckpointer, set_active_guard)

    class TripGuard(PreemptionGuard):
        """Drains at its 5th poll: the step boundary after the 5th snapshot."""

        polls = 0

        def should_checkpoint(self) -> bool:
            self.polls += 1
            if self.polls >= 5:
                self.request_drain("chip_smoke")
            return super().should_checkpoint()

    n, n_valid, f, rounds, leaves = 32768, 8192, 14, CHECKPOINT_ROUNDS, 31
    x_all, y_all = make_dataset(n + n_valid, f)
    x, y, xv = x_all[:n], y_all[:n], x_all[n:]
    root = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    bagged = dict(num_iterations=rounds, num_leaves=leaves, seed=3, bagging_fraction=0.8,
                  bagging_freq=3, device="cuda")
    goss = dict(num_iterations=rounds, num_leaves=leaves, seed=3, boosting_type="goss",
                device="cuda")
    writes, restores = [], []
    save, restore = TrainingCheckpointer.save, booster_mod._restore_snapshot

    def timed_save(self, payload, *args, **kw):
        t0 = time.perf_counter()
        path = save(self, payload, *args, **kw)
        writes.append({"seconds": time.perf_counter() - t0, "bytes": len(payload),
                       "file": Path(path).name})
        return path

    def timed_restore(*args, **kw):
        t0 = time.perf_counter()
        out = restore(*args, **kw)
        restores.append({"seconds": time.perf_counter() - t0,
                         "rounds_done": None if out is None else out[1]})
        return out

    def fit(params):
        """One counted fit: (the model or the Preempted it raised, seconds,
        K1 launches)."""
        torch.cuda.synchronize()
        histogram.launches = 0
        t0 = time.perf_counter()
        try:
            model = GBDTClassifier(**params).fit(_table(x, y))
        except Preempted as e:
            model = e
        return model, {"seconds": time.perf_counter() - t0,
                       "histogram_launches": histogram.launches}

    def taken():
        out = list(writes)
        writes.clear()
        return out

    fits, snaps = {}, {}
    c_params = {**bagged, "checkpoint_dir": str(root / "c"), "checkpoint_every_n": 10}
    with mock.patch.object(TrainingCheckpointer, "save", timed_save), \
            mock.patch.object(booster_mod, "_restore_snapshot", timed_restore):
        a, fits["a_uninterrupted"] = fit(bagged)
        b, fits["b_chunked"] = fit({**bagged, "checkpoint_dir": str(root / "b"),
                                    "checkpoint_every_n": 10})
        snaps["b"] = taken()
        set_active_guard(TripGuard(install=False))
        try:
            preempted, c_pre = fit(c_params)
        finally:
            set_active_guard(None)
        snaps["c_preempted"] = taken()
        c, fits["c_resumed"] = fit(c_params)
        snaps["c_resumed"] = taken()
        d_ref, fits["d_goss_uninterrupted"] = fit(goss)
        d, fits["d_goss_chunked"] = fit({**goss, "checkpoint_dir": str(root / "d"),
                                         "checkpoint_every_n": 7})
        snaps["d"] = taken()
    shutil.rmtree(root, ignore_errors=True)

    assert isinstance(preempted, Exception), "the guard drained, but the fit was not preempted"
    assert preempted.exit_code == 75, preempted.exit_code
    assert preempted.checkpoint_path and Path(preempted.checkpoint_path).name == \
        "ckpt-00000004-round-000045.bin", preempted.checkpoint_path
    assert snaps["c_preempted"][-1]["file"] == Path(preempted.checkpoint_path).name
    counts = {k: len(v) for k, v in snaps.items()}
    chunks_9, chunks_7 = -(-rounds // 9), -(-rounds // 7)     # a snapshot a chunk
    assert counts == {"b": chunks_9, "c_preempted": 5, "c_resumed": chunks_9 - 5,
                      "d": chunks_7}, counts
    assert [r["rounds_done"] for r in restores] == [None, None, 45, None], restores
    fits["c_resumed"].update(preempted_seconds=c_pre["seconds"],
                             preempted_launches=c_pre["histogram_launches"],
                             resumed_launches=fits["c_resumed"]["histogram_launches"])
    fits["c_resumed"]["histogram_launches"] += c_pre["histogram_launches"]
    for name, doc in fits.items():
        assert doc["histogram_launches"] == rounds * leaves, (name, doc)
    for model in (a, b, c, d_ref, d):
        assert model.booster.device.startswith("cuda"), model.booster.device
    a_text = a.booster.to_text()
    assert b.booster.to_text() == a_text, "the chunked fit differs from the uninterrupted one"
    assert c.booster.to_text() == a_text, "the resumed fit differs from the uninterrupted one"
    assert d.booster.to_text() == d_ref.booster.to_text(), "chunked goss differs"
    assert np.array_equal(c.booster.predict_raw(xv, device="device"),
                          a.booster.predict_raw(xv, device="device")), \
        "the resumed fit's card scores differ from the uninterrupted fit's"
    every_write = [w for v in snaps.values() for w in v]
    doc = {"phase": "slice_checkpoint", "rows": n, "features": f, "rounds": rounds,
           "num_leaves": leaves, "fits": fits, "b_chunk_rounds": 9, "d_chunk_rounds": 7,
           "snapshot_writes": snaps,
           "snapshot_write_seconds_median": float(np.median([w["seconds"] for w in every_write])),
           "snapshot_write_seconds_max": max(w["seconds"] for w in every_write),
           "snapshot_bytes_last_b": snaps["b"][-1]["bytes"],
           "restore_seconds": next(r["seconds"] for r in restores if r["rounds_done"]),
           "preempted_exit_code": preempted.exit_code,
           "preempted_checkpoint": Path(preempted.checkpoint_path).name,
           "to_text_equal": True, "resumed_scores_equal": True,
           "histogram_launches": sum(d["histogram_launches"] for d in fits.values())}
    emit(doc)
    return doc


def load_label_csv(name: str):
    """A vendored benchmark CSV (tests/benchmarks/data/<name>.csv: feature
    columns and 'Label') as (x, y) float64, as utils/datagen.py reads it."""
    with open(ROOT / "tests" / "benchmarks" / "data" / f"{name}.csv", newline="") as fh:
        rows = list(csv.reader(fh))
    header, body = rows[0], np.asarray(rows[1:], dtype=np.float64)
    label = header.index("Label")
    return np.delete(body, label, axis=1), body[:, label]


def holdout_split(n: int, seed: int = 0, frac: float = 0.8):
    """The stocked zoo's train/holdout split (copy of
    mmlspark_tpu/utils/datagen.py holdout_split)."""
    order = np.random.default_rng(seed).permutation(n)
    cut = int(frac * n)
    return order[:cut], order[cut:]


ZOO_ADULT_AUC = 0.91478     # model_zoo/index.json, gbdt_adult_census_synthetic


def phase_slice_lightgbm_import(adult: dict, categorical: dict) -> dict:
    """LightGBM model.txt on the card: the three model_zoo/gbdt_*.model
    files through the port's Booster.load_native_model (device "cuda").
    The adult-census model scores tools/build_zoo.py's held-out set
    (make_dataset(8,192, 28, seed=8), tools/build_zoo.py:99-100) at
    index.json's AUC 0.91478 (5 places); wdbc and diabetes on the zoo's
    split reach tests/test_zoo_content.py's gates (AUC > 0.97, RMSE < 62.0);
    the adult-census model's fused bin -> traverse program over
    make_dataset(1,048,576, 28) in f32 equals predict_raw on the same rows
    bit for bit (rows/s end to end and resident). Export: slice_adult's
    booster goes through to_lightgbm_text -> from_lightgbm_text on the card
    and scores within tests/test_external_truth.py:483-486's rtol 1e-6,
    atol 1e-7; slice_categorical's the same through the host walk (device
    predict refuses categorical models). Prints parse and export seconds."""
    from mmlspark_tpu_torch.automl.metrics import auc
    from mmlspark_tpu_torch.gbdt.booster import Booster

    zoo, parse_s = {}, {}
    for name in ("gbdt_adult_census_synthetic", "gbdt_wdbc", "gbdt_diabetes"):
        t0 = time.perf_counter()
        zoo[name] = Booster.load_native_model(str(ROOT / "model_zoo" / f"{name}.model"))
        parse_s[name] = time.perf_counter() - t0
        assert zoo[name].device.startswith("cuda"), zoo[name].device
    census = zoo["gbdt_adult_census_synthetic"]
    xh, yh = make_dataset(8192, 28, seed=8)
    census_auc = auc(yh, census.predict(xh, device="device"))
    assert round(census_auc, 5) == ZOO_ADULT_AUC, census_auc
    x, y = load_label_csv("breast_cancer_wdbc")
    _, te = holdout_split(len(y))
    wdbc_auc = auc(y[te], zoo["gbdt_wdbc"].predict(x[te], device="device"))
    assert wdbc_auc > 0.97, wdbc_auc
    x, y = load_label_csv("diabetes")
    _, te = holdout_split(len(y))
    rmse = float(np.sqrt(np.mean((zoo["gbdt_diabetes"].predict(x[te], device="device")
                                  - y[te]) ** 2)))
    assert rmse < 62.0, rmse

    # the fused program: its adjusted f32 keys give the host's f64 bins on
    # f32 values, so the rows are cast first; under 256 bins a feature
    assert int(census.bin_mapper.num_bins.max()) <= 256, census.bin_mapper.num_bins.max()
    x32 = np.ascontiguousarray(make_dataset(1_048_576, 28)[0], dtype=np.float32)
    params, fn = census.device_predict_fn()
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
    staged = census.predict_raw(x32, device="device")
    assert margins.shape == (len(x32),) and np.isfinite(margins).all()
    assert np.array_equal(margins, staged), "the fused program differs from predict_raw"

    export = {}
    for name, src, route in (("adult", adult, "device"), ("categorical", categorical, "host")):
        booster, xv = src["booster"], src["x_valid"]
        t0 = time.perf_counter()
        txt = booster.to_lightgbm_text()
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = Booster.from_lightgbm_text(txt)
        import_s = time.perf_counter() - t0
        assert again.device.startswith("cuda") and again.num_trees == booster.num_trees
        want, got = booster.predict(xv, device=route), again.predict(xv, device=route)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        export[name] = {"route": route, "trees": booster.num_trees, "text_bytes": len(txt),
                        "export_seconds": export_s, "import_seconds": import_s,
                        "max_abs_gap": float(np.abs(got - want).max())}
    doc = {"phase": "slice_lightgbm_import", "parse_seconds": parse_s,
           "adult_census_trees": census.num_trees,
           "adult_census_holdout_auc": census_auc, "wdbc_holdout_auc": wdbc_auc,
           "diabetes_holdout_rmse": rmse,
           "fused_rows": len(x32), "fused_end_to_end_seconds": e2e_s,
           "fused_end_to_end_rows_per_s": len(x32) / e2e_s,
           "fused_resident_seconds": resident_s,
           "fused_resident_rows_per_s": len(x32) / resident_s,
           "fused_equals_predict_raw": True, "export": export}
    emit(doc)
    return doc


# The serving transformer at bench.py's accelerator width (bench.py:632-645)
MESH_RANKS = 4
MESH_CPU_ROUNDS = 3       # the CPU ranks' fits, against the card fits' first trees (once 5)
# the card ranks' fits: 10 of slice_adult's 100 rounds, held against its first
# 10 trees (a tree of round r depends on no later round), so that the smoke
# stays well inside its time limit on slower card hosts (the four fits took
# 164 s at 100 rounds, 63 s at 40, 29–48 s at 20)
MESH_ROUNDS = 10
# compare_fits' tolerance of a card fit against the CPU ranks' fit. The
# fixed-point merge rounds each bin to 2**23 / 4 steps of its channel's
# largest value, so where K1's block-order sums and the CPU's row-order
# sums differ in a last bit a bin can round a whole step apart, and a
# small leaf moves by more than f32 rounding (the gap slice_mesh reports;
# PERF.md); the row-order witness holds the rest at 1e-5
MESH_CPU_TOL = {"data_parallel": 1e-4, "deterministic": 5e-4, "voting": 1e-4, "bagged": 1e-4}
# slice_mesh's four fits of the Adult stand-in over 4 ranks
MESH_CONFIGS = {
    "data_parallel": {},
    "deterministic": {"deterministic": True},
    "voting": {"tree_learner": "voting_parallel", "top_k": 5},
    "bagged": {"bagging_fraction": 0.8, "bagging_freq": 1},
}


def mesh_fit_job(x, y, params: dict, device: str, rounds: int = 100,
                 row_order: bool = False) -> dict:
    """Run on every rank of a RankPool: GBDTClassifier(use_mesh=True) on the
    pool's mesh (every rank of its group). Returns the rank's model text,
    its histogram launches, its fit seconds and its collectives (calls,
    bytes, host seconds). `row_order`: the CPU's row-order histogram in
    K1's place (`_row_order_histogram`)."""
    from unittest import mock

    from mmlspark_tpu_torch.gbdt import GBDTClassifier, engine
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
    from mmlspark_tpu_torch.parallel import collectives, get_mesh

    if device == "cuda":
        torch.cuda.synchronize()
    histogram.launches = 0
    collectives.reset_stats()
    t0 = time.perf_counter()
    with mock.patch.object(engine, "histogram",
                           _row_order_histogram if row_order else engine.histogram):
        model = GBDTClassifier(num_iterations=rounds, num_leaves=31, use_mesh=True,
                               device=device, **params).fit(_table(x, y))
    if device == "cuda":
        torch.cuda.synchronize()
    return {"text": model.booster.to_text(), "launches": histogram.launches,
            "seconds": time.perf_counter() - t0, "collectives": collectives.stats(),
            "shard": get_mesh().shard_index}


def nccl_one_rank_job(x, y) -> dict:
    """Run on a one-rank NCCL pool: the data-parallel fit on a one-shard
    mesh (no collective runs on one shard, as the reference's
    mesh.shape[DATA] == 1 branch), then an all_reduce through NCCL on the
    card, the backend a rank that owns its card runs."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
    from mmlspark_tpu_torch.parallel import get_mesh

    mesh = get_mesh()
    histogram.launches = 0
    model = GBDTClassifier(num_iterations=100, num_leaves=31, use_mesh=True,
                           device="cuda").fit(_table(x, y))
    launches = histogram.launches
    t = torch.arange(4, dtype=torch.float32, device=mesh.device)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return {"text": model.booster.to_text(), "backend": dist.get_backend(), "launches": launches,
            "mesh_device": str(mesh.device), "booster_device": model.booster.device,
            "all_reduce_ok": bool(torch.equal(t.cpu(), torch.arange(4, dtype=torch.float32)))}


def _mesh_pool_fits(pool, x, y, device: str, rounds: int, row_order: bool = False) -> dict:
    """The four MESH_CONFIGS fitted on every rank of `pool`: the ranks'
    models must be one text. Per config: the text, each rank's launches,
    the slowest rank's fit seconds, rank 0's collectives."""
    fits = {}
    for name, params in MESH_CONFIGS.items():
        out = pool.run(mesh_fit_job, x, y, params, device, rounds, row_order, deadline_s=600)
        texts = {o["text"] for o in out}
        assert len(texts) == 1, f"mesh {name} on {device}: the {len(out)} ranks hold " \
                                f"{len(texts)} different models"
        assert sorted(o["shard"] for o in out) == list(range(len(out)))
        fits[name] = {"text": out[0]["text"], "launches": [o["launches"] for o in out],
                      "seconds": max(o["seconds"] for o in out),
                      "collectives": out[0]["collectives"]}
    return fits


def phase_slice_mesh(adult: dict) -> dict:
    """Distributed GBDT: 4 ranks on the one card, joined over gloo (NCCL
    takes one rank a card), each fitting slice_adult's data (32,768 x 14,
    MESH_ROUNDS rounds of 31 leaves) through GBDTClassifier(use_mesh=True) on its
    block of 8,192 rows under MESH_CONFIGS: data_parallel, deterministic
    (the fixed-point merge), voting_parallel with top_k 5 (10 of the 14
    features merged a tree) and bagged gbdt (per-shard draws). Every
    rank's model is one text; each rank launches K1 31 times a round. The
    card fits run MESH_ROUNDS of the 100 rounds, against slice_adult's
    booster truncated to as many: data_parallel meets that one-device
    card fit by compare_fits at 1e-4 (the merge and K1 add in other
    orders); deterministic is held to it by quality. The same four fits on
    the same 4 ranks with device="cpu" (CPU ranks) meet the card's by
    compare_fits at MESH_CPU_TOL (below); the deterministic fit again on
    the card with the CPU's row-order histogram in K1's place meets the CPU
    ranks' at 1e-5, so only K1's order parts them. Held-out AUC > 0.75, and within 0.01 of the
    one-device fit for data_parallel and deterministic. The CPU ranks fit
    MESH_CPU_ROUNDS rounds, held against the card fits' first trees (a tree of round
    r depends on no later round; 100 rounds on 4 CPU ranks take ~21 s a
    config on an 8-core host). Last, a one-rank
    mesh on NCCL: the data-parallel fit equal to the fit without a mesh
    byte for byte, and an all_reduce through NCCL on the card. Per fit:
    seconds, collectives and bytes merged, and the host-timed share of the
    fit spent in collectives (gloo copies each merge to the host and back).
    The card ranks' pool is returned open ("pool") for slice_parallel."""
    from mmlspark_tpu_torch.automl.metrics import auc
    from mmlspark_tpu_torch.gbdt import Booster
    from mmlspark_tpu_torch.parallel import RankPool

    n, n_valid, f, rounds, leaves = 32768, 8192, 14, MESH_ROUNDS, 31
    x_all, y_all = make_dataset(n + n_valid, f)
    x, y, xv, yv = x_all[:n], y_all[:n], x_all[n:], y_all[n:]
    single = adult["booster"]
    single_cut = single.truncated(rounds)
    bins = single.bin_mapper.transform(x)
    auc_single = auc(yv, single_cut.predict(xv))
    workdir = ROOT / "build" / "chip_smoke_mesh"
    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # the card ranks stay up for slice_parallel, which closes them
    card_pool = RankPool(MESH_RANKS, backend="gloo", workdir=str(workdir), timeout_s=300)
    try:
        spawn_s = time.perf_counter() - t0
        card_pool.run(mesh_fit_job, x, y, {}, "cuda", 2, deadline_s=300)   # context, K1 load
        card = _mesh_pool_fits(card_pool, x, y, "cuda", rounds)
        witness = card_pool.run(mesh_fit_job, x, y, MESH_CONFIGS["deterministic"], "cuda",
                                MESH_CPU_ROUNDS, True, deadline_s=600)[0]["text"]
        # the CPU fits on the same ranks (device="cpu"): no second spawn
        cpu = _mesh_pool_fits(card_pool, x, y, "cpu", MESH_CPU_ROUNDS)
        with RankPool(1, backend="nccl", workdir=str(workdir), timeout_s=300) as pool:
            nccl = pool.run(nccl_one_rank_job, x, y, deadline_s=600)[0]
    except BaseException:
        card_pool.close(kill=True)
        raise

    doc = {"phase": "slice_mesh", "ranks": MESH_RANKS, "backend": "gloo", "rows": n,
           "rows_a_rank": n // MESH_RANKS, "features": f, "rounds": rounds, "num_leaves": leaves,
           "spawn_seconds": spawn_s, "single_device_fit_seconds": adult["fit_seconds"],
           "single_device_valid_auc": auc_single, "fits": {}}
    for name, fit in card.items():
        model = Booster.from_text(fit["text"], device="cuda")
        cpu_model = Booster.from_text(cpu[name]["text"], device="cuda")
        assert fit["launches"] == [rounds * leaves] * MESH_RANKS, \
            f"mesh {name}: K1 launches by rank {fit['launches']}, want {rounds * leaves} each"
        valid_auc = auc(yv, model.predict(xv))
        assert valid_auc > 0.75, f"mesh {name}: held-out AUC {valid_auc}"
        if name in ("data_parallel", "deterministic"):
            assert abs(valid_auc - auc_single) < 0.01, (name, valid_auc, auc_single)
        keys = ("trees_equal", "trees_compared", "near_ties", "max_value_err_over_tree_max")
        vs_cpu = compare_fits(cpu_model, model, bins, tol=MESH_CPU_TOL[name])
        assert vs_cpu["trees_compared"] > 0, f"mesh {name}: no tree compared with the CPU ranks'"
        col = fit["collectives"]
        entry = {"fit_seconds": fit["seconds"],
                 "cpu_ranks_rounds": MESH_CPU_ROUNDS, "cpu_ranks_fit_seconds": cpu[name]["seconds"],
                 "launches_by_rank": fit["launches"], "collectives": col["calls"],
                 "bytes_merged": col["bytes"], "collective_seconds": col["seconds"],
                 "collective_share": col["seconds"] / fit["seconds"],
                 "valid_auc": valid_auc, "vs_cpu_ranks_tol": MESH_CPU_TOL[name],
                 "vs_cpu_ranks": {k: vs_cpu[k] for k in keys}}
        if name == "data_parallel":
            vs_single = compare_fits(single_cut, model, bins, tol=1e-4)
            assert vs_single["trees_compared"] > 0, "no tree compared with the one-device fit"
            entry["vs_single_device"] = {k: vs_single[k] for k in keys}
        if name == "deterministic":
            rows = compare_fits(cpu_model, Booster.from_text(witness, device="cuda"), bins)
            assert rows["trees_compared"] > 0, "no witness tree compared with the CPU ranks'"
            entry["row_order_witness_vs_cpu_ranks"] = {k: rows[k] for k in keys}
        doc["fits"][name] = entry
    single_text = single.to_text()
    assert nccl["backend"] == "nccl" and nccl["all_reduce_ok"], nccl
    assert nccl["text"] == single_text, "the one-rank NCCL mesh fit differs from the fit " \
                                       "without a mesh"
    assert nccl["launches"] == single.num_trees * leaves, nccl["launches"]
    doc["nccl_one_rank"] = {"equal_to_no_mesh": True, "launches": nccl["launches"],
                            "mesh_device": nccl["mesh_device"],
                            "booster_device": nccl["booster_device"], "all_reduce_ok": True}
    emit(doc)
    return {**doc, "pool": card_pool, "histogram_launches_by_fit": {
        **{f"mesh_{name}": sum(fit["launches"]) for name, fit in card.items()},
        "mesh_nccl_one_rank": nccl["launches"]}}


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


def phase_slice_transformer(bundle=None) -> dict:
    """The DNN slice's main path: 1,024 rows x 512 token ids through
    DeepModelTransformer on the card, attention_impl="flash" in bf16, one
    K2 launch per layer and minibatch; the same tokens served in f32 (K2's
    3xTF32 path); then the outputs checked three ways, and a 4 x 4096
    long-sequence run. `bundle`: slice_parallel's (the same seed and
    config), or None to make it here."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import ModelBundle
    from mmlspark_tpu_torch.nn.attention import flash_attention

    t0 = time.perf_counter()
    if bundle is None:
        bundle = ModelBundle.init("transformer", (SLICE_TOKENS,), seed=0,
                                  attention_impl="flash", dtype="bfloat16", **SLICE_TRANSFORMER)
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
# spreads by ~20% between passes, while K2 is ~3% of it: 100 passes (~5 s)
# bring the rate's standard error to ~2% (400 took ~20 s a width and 200
# ~10 s, more than the smoke's time limit leaves it now).
SMALL_PASSES = 100


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
# its spread (5 until the smoke's time ran short on slower card hosts)
WIDE_BATCH, WIDE_PASSES = 4, 3


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
    """model_zoo/resnet20_digits through the port's ModelDownloader (which
    checks the sha256 that model_zoo/index.json records), the 1,797 digits
    images served on the card and on the CPU."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelDownloader

    bundle = ModelDownloader(str(ROOT / "model_zoo")).load_bundle("resnet20_digits")
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



# ---- slice_featurize: transfer learning on the card ---- #

FEATURIZE_IMAGES, FEATURIZE_SIZE, FEATURIZE_BATCH = 512, 256, 64
# BERT-base's published widths (Devlin et al. 2018; google-research/bert's
# bert_config.json for uncased_L-12_H-768_A-12): 12 layers, hidden 768, 12
# heads, intermediate 3,072, vocabulary 30,522, 512 positions; 2 outputs
BERT_BASE = {"num_layers": 12, "d_model": 768, "num_heads": 12, "d_ff": 3072,
             "vocab_size": 30522, "max_len": 512, "num_outputs": 2}
BERT_ROWS, BERT_TOKENS, BERT_BATCH = 1024, 512, 64


def reference_import_tests():
    """tests/test_import_weights.py, loaded by path for its manifests and
    seeded state dicts (it imports only json, os, numpy and pytest at
    module level, and nothing of the JAX package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "reference_import_weights_tests", ROOT / "tests" / "test_import_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    leaked = {"jax", "jaxlib", "flax", "mmlspark_tpu"} & set(sys.modules)
    assert not leaked, f"{spec.origin} imported {sorted(leaked)}: copy its builders here"
    return mod


def bert_base_state_dict(ref, seed: int = 12) -> dict:
    """An HF-style encoder state dict with `transformer_manifest`'s names
    and shapes, each of its tiny widths replaced by BERT-base's and its
    layer-0 tensors repeated for 12 layers: every tensor N(0, 0.02) (BERT's
    initializer range), LayerNorm weights 1 + N(0, 0.02)."""
    widths = {ref.T_VOCAB: BERT_BASE["vocab_size"], ref.T_DMODEL: BERT_BASE["d_model"],
              ref.T_DFF: BERT_BASE["d_ff"], ref.T_MAXLEN: BERT_BASE["max_len"],
              ref.T_OUT: BERT_BASE["num_outputs"]}
    assert len(widths) == 5, "the tiny manifest's widths must be distinct"
    manifest = {}
    for name, shape in ref.transformer_manifest().items():
        shape = tuple(widths[d] for d in shape)
        if name.startswith("encoder.layer.0."):
            for i in range(BERT_BASE["num_layers"]):
                manifest[name.replace("encoder.layer.0.", f"encoder.layer.{i}.")] = shape
        elif not name.startswith("encoder.layer."):
            manifest[name] = shape
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in manifest.items():
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if name.endswith("ln.weight") or name == "final_layer_norm.weight":
            w += np.float32(1.0)
        sd[name] = w
    return sd


def _featurize_chain(device: str):
    from mmlspark_tpu_torch.image import ImageTransformer

    return (ImageTransformer(device=device).resize(224, 224).crop(16, 16, 192, 192).flip(1)
            .gray(keep_channels=True).blur(3, 3).gaussian_kernel(5, 1.0))


def featurize_image_chain(images: np.ndarray) -> dict:
    """(a) The image chain over the 512 images on the card and the CPU: the
    continuous ops (everything before the threshold) within 1e-3 on 0-255;
    the threshold's output equal wherever its input lies more than 1e-3
    from the threshold (a pixel that close may fall on either side)."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.image import UnrollImage
    from mmlspark_tpu_torch.image.ops import resize_nhwc, threshold_image

    table = Table({"image": images})
    card_chain = _featurize_chain("cuda").threshold(100.0)
    seconds = []
    for _ in range(2):           # the first call, then a steady one
        t0 = time.perf_counter()
        card = card_chain.transform(table)
        seconds.append(time.perf_counter() - t0)
    card = np.asarray(card["image_out"])
    card_before = np.asarray(_featurize_chain("cuda").transform(table)["image_out"])
    t0 = time.perf_counter()
    cpu_before = np.asarray(_featurize_chain("cpu").transform(table)["image_out"])
    cpu_s = time.perf_counter() - t0
    # the chain's last op on the CPU's values: the CPU chain's output
    cpu = threshold_image(torch.from_numpy(cpu_before), 100.0).numpy()
    continuous_gap = float(np.abs(card_before - cpu_before).max())
    assert continuous_gap <= 1e-3, f"chain before the threshold: card - CPU {continuous_gap}"
    near = np.abs(cpu_before - 100.0) <= 1e-3
    assert card.shape == cpu.shape == (len(images), 192, 192, 3)
    assert np.array_equal(card[~near], cpu[~near]), "threshold output differs off its edge"

    x = torch.from_numpy(images).cuda().float()
    resize_ms = median_ms(lambda: resize_nhwc(x, 224, 224), reps=20, warmup=3)
    chain_ms = median_ms(lambda: card_chain.apply(x), reps=20, warmup=3)
    unrolled = UnrollImage(input_col="image_out").transform(Table({"image_out": card}))
    return {"chain_seconds_first_call": seconds[0], "chain_seconds": seconds[1],
            "chain_cpu_seconds_before_threshold": cpu_s, "chain_device_ms": chain_ms,
            "resize_ms": resize_ms, "resize_images_per_s": len(images) / (resize_ms / 1e3),
            "card_vs_cpu_before_threshold_max_abs": continuous_gap,
            "threshold_pixels_within_1e-3": int(near.sum()),
            "threshold_pixels_differing": int((card != cpu).sum()),
            "unroll_shape": list(np.asarray(unrolled["features"]).shape)}


def featurize_resnet50(ref, images: np.ndarray, repo: Path) -> dict:
    """(b) torchvision-named ResNet-50 weights imported through the zoo,
    held to the JAX package's committed logits on the card, then
    ImageFeaturizer over the 512 images (resized to 224 on the card)."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import (DeepModelTransformer, ImageFeaturizer, ModelDownloader,
                                       ModelSchema)

    src = repo / "src" / "resnet50.npz"
    src.parent.mkdir(parents=True, exist_ok=True)
    np.savez(src, **ref.synthetic_state_dict())
    zoo = ModelDownloader(str(repo / "zoo"))
    t0 = time.perf_counter()
    zoo.import_external(ModelSchema(name="resnet50_64", uri=str(src), architecture="resnet50",
                                    input_shape=(64, 64, 3), num_outputs=1000))
    bundle = zoo.load_bundle("resnet50_64")
    import_s = time.perf_counter() - t0

    # the committed activations: seed 42, 2 x 64 x 64 x 3 (the reference's gate)
    x = np.random.default_rng(42).integers(0, 256, size=(2, 64, 64, 3)).astype(np.float32)
    logits = np.asarray(DeepModelTransformer(
        input_col="x", mini_batch_size=2, device="cuda",
        fetch_dict={"l": "logits"}).set_model(bundle).transform(Table({"x": x}))["l"])
    with open(ROOT / "tests" / "fixtures" / "imported_resnet50_logits.json") as fh:
        want = np.asarray(json.load(fh)["logits_2x8"])
    np.testing.assert_allclose(logits[:, :8], want, rtol=2e-3, atol=2e-4)
    fixture_gap = float(np.abs(logits[:, :8] - want).max())

    zoo.import_external(ModelSchema(name="resnet50_224", uri=str(src),
                                    architecture="resnet50", input_shape=(224, 224, 3),
                                    num_outputs=1000))
    b224 = zoo.load_bundle("resnet50_224")
    table = Table({"image": images})
    stage = ImageFeaturizer(input_col="image", output_col="features",
                            layer_name="pooled_features", mini_batch_size=FEATURIZE_BATCH,
                            device="cuda").set_model(b224)
    seconds = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = np.asarray(stage.transform(table)["features"])
        seconds.append(time.perf_counter() - t0)
    assert feats.shape == (FEATURIZE_IMAGES, 2048) and feats.dtype == np.float64
    assert np.isfinite(feats).all()
    # 8 images on the CPU (f32, TF32 off on the card)
    cpu = np.asarray(ImageFeaturizer(input_col="image", output_col="features",
                                     layer_name="pooled_features", mini_batch_size=8,
                                     device="cpu").set_model(b224)
                     .transform(Table({"image": images[:8]}))["features"])
    gap = float(np.abs(feats[:8] - cpu).max())
    scale = float(np.abs(cpu).max())
    assert gap <= 1e-4 * scale, f"ResNet-50 features card - CPU {gap} of {scale}"
    return {"import_and_load_seconds_64": import_s, "fixture_max_abs": fixture_gap,
            "features_shape": list(feats.shape),
            "featurize_seconds_first_call": seconds[0], "featurize_seconds": seconds[1],
            "images_per_s_first_call": FEATURIZE_IMAGES / seconds[0],
            "images_per_s": FEATURIZE_IMAGES / seconds[1],
            "card_vs_cpu_8_images_max_abs": gap, "feature_max_abs": scale}


def featurize_encoder(ref, repo: Path) -> dict:
    """(c) The tiny imported encoder held to its committed logits on the
    card under both attention cores; then BERT-base's widths imported with
    12 heads, flash and bf16, serving 1,024 x 512 tokens (one K2 launch a
    layer and minibatch, on "wgmma"); the imported weights in f32 on 4 x
    128 tokens, card against CPU (K2 on "tf32x3")."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import ModelDownloader, ModelSchema
    from mmlspark_tpu_torch.nn.attention import flash_attention

    zoo = ModelDownloader(str(repo / "zoo"))
    tiny_src = repo / "src" / "tiny_encoder.npz"
    np.savez(tiny_src, **ref.synthetic_transformer_state_dict())
    zoo.import_external(ModelSchema(name="tiny_encoder", uri=str(tiny_src),
                                    architecture="transformer",
                                    extra={"config": {"num_heads": ref.T_HEADS}}))
    tiny = zoo.load_bundle("tiny_encoder")
    tokens = np.arange(2 * 12).reshape(2, 12) % ref.T_VOCAB
    with open(ROOT / "tests" / "fixtures" / "imported_transformer_logits.json") as fh:
        want = np.asarray(json.load(fh)["logits_2x3"])
    tiny_gaps = {}
    flash_attention.launches, flash_attention.launches_by_path = 0, {}
    for impl in ("dense", "flash"):
        _, out = _serve(_variant(tiny, attention_impl=impl), tokens, "cuda", 2)
        got = np.asarray(out["logits"])
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
        tiny_gaps[impl] = float(np.abs(got - want).max())
    # f32, head dim 4: one launch a layer on "tf32x3", none in the dense run
    tiny_by_path = dict(flash_attention.launches_by_path)
    assert tiny_by_path == {"tf32x3": 2}, tiny_by_path

    t0 = time.perf_counter()
    src = repo / "src" / "bert_base.npz"
    np.savez(src, **bert_base_state_dict(ref))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    zoo.import_external(ModelSchema(
        name="bert_base_width", uri=str(src), architecture="transformer",
        extra={"config": {"num_heads": BERT_BASE["num_heads"], "attention_impl": "flash",
                          "dtype": "bfloat16"}}))
    bundle = zoo.load_bundle("bert_base_width")
    import_s = time.perf_counter() - t0
    assert {k: bundle.config[k] for k in BERT_BASE} == BERT_BASE, bundle.config

    rows = np.random.default_rng(13).integers(0, BERT_BASE["vocab_size"],
                                              size=(BERT_ROWS, BERT_TOKENS))
    fetch = {"logits": "logits", "prob": "probability"}
    stage, _ = _serve(bundle, rows[:BERT_BATCH], "cuda", BERT_BATCH, fetch)  # warm-up
    torch.cuda.synchronize()
    flash_attention.launches, flash_attention.launches_by_path = 0, {}
    t0 = time.perf_counter()
    out = stage.transform(Table({"tokens": rows}))
    serve_s = time.perf_counter() - t0
    launches, by_path = flash_attention.launches, dict(flash_attention.launches_by_path)
    want_launches = BERT_ROWS // BERT_BATCH * BERT_BASE["num_layers"]
    assert launches == want_launches, f"K2 launched {launches} times, want {want_launches}"
    assert by_path == {"wgmma": want_launches}, by_path
    logits, prob = np.asarray(out["logits"]), np.asarray(out["prob"])
    assert logits.shape == prob.shape == (BERT_ROWS, BERT_BASE["num_outputs"])
    assert np.isfinite(logits).all() and np.isfinite(prob).all()
    assert np.allclose(prob.sum(-1), 1.0, atol=1e-5)
    # the served bf16 logits of 4 rows against the same bundle's dense core
    # in bf16 on the card: the attention core and the GEMMs' minibatch are
    # all that differ, so the two agree within a bf16 ulp at the top of the
    # logits (2**-7 of the largest), a small share of what bf16 itself moves
    # them from f32
    _, dense = _serve(_variant(bundle, attention_impl="dense"), rows[:4], "cuda", 4)
    dense = np.asarray(dense["logits"])
    bf16_gap = float(np.abs(logits[:4] - dense).max())
    bf16_tol = 2.0 ** -7 * float(np.abs(dense).max())
    assert bf16_gap <= bf16_tol, f"bf16 flash - dense logits {bf16_gap} > {bf16_tol}"

    # the imported weights in f32: card against CPU on 4 rows x 128 tokens
    f32 = _variant(bundle, dtype="float32")
    short = rows[:4, :128]
    flash_attention.launches, flash_attention.launches_by_path = 0, {}
    _, card = _serve(f32, short, "cuda", 4)
    f32_launches, f32_by_path = flash_attention.launches, dict(flash_attention.launches_by_path)
    assert f32_by_path == {"tf32x3": BERT_BASE["num_layers"]}, f32_by_path
    _, cpu = _serve(f32, short, "cpu", 4)
    card, cpu = np.asarray(card["logits"]), np.asarray(cpu["logits"])
    f32_gap = float(np.abs(card - cpu).max())
    np.testing.assert_allclose(card, cpu, atol=1e-4, rtol=1e-4)
    return {"tiny_fixture_max_abs": tiny_gaps, "tiny_flash_launches": tiny_by_path["tf32x3"],
            "config": BERT_BASE,
            "state_dict_write_seconds": write_s, "import_and_load_seconds": import_s,
            "rows": BERT_ROWS, "tokens_per_row": BERT_TOKENS, "mini_batch_size": BERT_BATCH,
            "serve_seconds": serve_s, "tokens_per_s": BERT_ROWS * BERT_TOKENS / serve_s,
            "flash_launches": launches, "flash_launches_by_path": by_path,
            "bf16_flash_vs_dense_max_abs_4_rows": bf16_gap, "bf16_flash_vs_dense_tol": bf16_tol,
            "f32_flash_launches": f32_launches, "f32_card_vs_cpu_max_abs_4x128": f32_gap}


def phase_slice_featurize() -> dict:
    """Transfer learning through the entry points a user calls: the image
    chain, ModelDownloader.import_external -> load_bundle ->
    ImageFeaturizer at ResNet-50 224, and DeepModelTransformer over an
    imported BERT-base-wide encoder (items a-c above). Writes and removes
    build/chip_smoke_featurize/."""
    t0 = time.perf_counter()
    ref = reference_import_tests()
    images = np.random.default_rng(16).integers(
        0, 256, size=(FEATURIZE_IMAGES, FEATURIZE_SIZE, FEATURIZE_SIZE, 3), dtype=np.uint8)
    repo = ROOT / "build" / "chip_smoke_featurize"
    shutil.rmtree(repo, ignore_errors=True)
    try:
        doc = {"phase": "slice_featurize", "images": list(images.shape),
               "image_chain": featurize_image_chain(images),
               "resnet50": featurize_resnet50(ref, images, repo),
               "encoder": featurize_encoder(ref, repo)}
    finally:
        shutil.rmtree(repo, ignore_errors=True)
    doc["seconds"] = time.perf_counter() - t0
    emit(doc)
    return doc

# ---- slice_tabular: tabular ingest, featurization and text on the card ---- #

# UCI Adult's six numeric columns (adult.names), the columns CleanMissingData
# fills; 32,768 rows fitted and 8,192 held out, as slice_categorical
ADULT_NUMERIC = ("age", "fnlwgt", "education-num", "capital-gain", "capital-loss",
                 "hours-per-week")
TABULAR_ROWS, TABULAR_HELD_OUT = 32768, 8192
# the text corpus: 8,192 documents (6,144 fitted) over a 20,000-word
# vocabulary, hashed into HashingTF's 4,096 buckets, the reference's default
# for tree learners (text/featurizer.py:115-124, after Featurize.scala:13-19)
TEXT_DOCS, TEXT_FIT_DOCS, TEXT_VOCAB, TEXT_FEATURES = 8192, 6144, 20000, 4096
# the CPU-against-card fits run on the first rows only, to keep the phase
# within ~45 s: on the card machine's host the CPU's plain histogram took
# ~95 ms a node at 8,192 x 108 (a 10-round CPU fit 29.5 s) and a 2-round
# fit at 1,024 x 4,096 9.7 s
TABULAR_PARITY_ROWS, TEXT_PARITY_DOCS = 3072, 512


def adult_csv_bytes(n: int, seed: int = 17) -> bytes:
    """make_adult_categorical(n) written as UCI Adult's adult.data is: cells
    separated by ", ", the six numeric columns as integers, the categorical
    ones as level strings ("workclass_3"), "?" where the generator has NaN
    (as the file has it) and the label income as ">50K" / "<=50K"; ~1% of
    hours-per-week cells are left blank (missing numbers). A first row
    names the 15 columns (adult.names; adult.data itself has no header)."""
    x, y = make_adult_categorical(n, seed)
    blank = np.random.default_rng(seed + 1).random(n) < 0.01
    cols = []
    for j, name in enumerate(ADULT_COLUMNS):
        v = x[:, j]
        if name in ADULT_CATEGORIES:
            codes = np.nan_to_num(v).astype(np.int64).astype(str)
            cols.append(np.where(np.isnan(v), "?", np.char.add(f"{name}_", codes)))
        else:
            cells = v.astype(np.int64).astype(str)
            cols.append(np.where(blank, "", cells) if name == "hours-per-week" else cells)
    cols.append(np.where(y > 0, ">50K", "<=50K"))
    lines = [", ".join(ADULT_COLUMNS + ("income",))] + [", ".join(row) for row in zip(*cols)]
    return ("\n".join(lines) + "\n").encode()


def text_corpus(n: int, seed: int = 23):
    """n seeded documents of 40 to 200 tokens over TEXT_VOCAB made-up
    lowercase words, and their classes (half each). Both classes draw
    their words Zipf-like (weight of rank r 1 / r**1.1, the ranks shuffled
    over the vocabulary); each class weights 300 words of its own 4 times."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = set()
    while len(words) < TEXT_VOCAB:
        words.add("".join(rng.choice(letters, size=int(rng.integers(3, 10)))))
    vocab = np.array(sorted(words))
    base = (1.0 / np.arange(1, TEXT_VOCAB + 1) ** 1.1)[rng.permutation(TEXT_VOCAB)]
    shifted = rng.choice(TEXT_VOCAB, size=600, replace=False).reshape(2, 300)
    y = (rng.random(n) < 0.5).astype(np.float64)
    lengths = rng.integers(40, 201, size=n)
    docs = [""] * n
    for c in (0, 1):
        p = base.copy()
        p[shifted[c]] *= 4.0
        rows = np.flatnonzero(y == c)
        drawn = rng.choice(TEXT_VOCAB, size=int(lengths[rows].sum()), p=p / p.sum())
        for r, ids in zip(rows, np.split(drawn, np.cumsum(lengths[rows])[:-1])):
            docs[r] = " ".join(vocab[ids])
    return docs, y


def _tabular_pipeline(rounds: int, device: str):
    """The tabular path a user builds: CleanMissingData (means of the six
    numeric columns), then TrainClassifier -> GBDTClassifier (31 leaves)."""
    from mmlspark_tpu_torch.automl import TrainClassifier
    from mmlspark_tpu_torch.core import Pipeline
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.ops import CleanMissingData

    return Pipeline([
        CleanMissingData(input_cols=list(ADULT_NUMERIC), output_cols=list(ADULT_NUMERIC),
                         cleaning_mode="Mean"),
        TrainClassifier(model=GBDTClassifier(num_iterations=rounds, num_leaves=31,
                                             device=device), label_col="income")])


def _featurized(fitted, table) -> np.ndarray:
    """The matrix a fitted _tabular_pipeline feeds its booster."""
    return fitted.stages[1].featurizer.transform(fitted.stages[0].transform(table))["features"]


def _income_metrics(scored) -> dict:
    """_metrics of a TrainClassifier-scored table: ComputeModelStatistics
    reads labels as numbers, so ">50K" counts as 1 in the label and the
    decoded prediction."""
    from mmlspark_tpu_torch.core import Table

    def ones(col):
        return np.asarray([v == ">50K" for v in col], np.float64)

    return _metrics(Table({"label": ones(scored["income"]),
                           "prediction": ones(scored["prediction"])}).with_column(
        "probability", scored["probability"], meta=scored.meta("probability")))


def _same_table(a, b) -> bool:
    """Equal columns in the same order and of the same kinds: numbers bit
    for bit with NaN in the same places, strings equal."""
    if a.columns != b.columns:
        return False
    for c in a.columns:
        x, y = a[c], b[c]
        if isinstance(x, np.ndarray) != isinstance(y, np.ndarray):
            return False
        if not isinstance(x, np.ndarray):
            if list(x) != list(y):
                return False
            continue
        nan = np.isnan(x)
        if (x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(nan, np.isnan(y))
                or not np.array_equal(x[~nan].view(np.uint64), y[~nan].view(np.uint64))):
            return False
    return True


def tabular_ingest(folder: Path) -> dict:
    """(a) The Adult CSV of TABULAR_ROWS + TABULAR_HELD_OUT rows through
    read_csv on the native parser, against the csv module's path."""
    from unittest import mock

    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.core import read_csv
    from mmlspark_tpu_torch.core.table_io import _read_csv_slow

    assert native.available(), "the native CSV parser did not build"
    data = adult_csv_bytes(TABULAR_ROWS + TABULAR_HELD_OUT)
    path = folder / "adult.csv"
    path.write_bytes(data)
    ran, parse = [], native.csv_parse

    def spy(*args, **kwargs):
        out = parse(*args, **kwargs)
        ran.append(out is not None)
        return out

    with mock.patch.object(native, "csv_parse", spy):
        t0 = time.perf_counter()
        table = read_csv(str(path))
        native_s = time.perf_counter() - t0
    assert ran == [True], f"read_csv did not take the native parser: {ran}"
    t0 = time.perf_counter()
    slow = _read_csv_slow(data, True, ",", None, "utf-8")
    slow_s = time.perf_counter() - t0
    assert _same_table(table, slow), "the native parser's table differs from the csv module's"
    numeric = [c for c in table.columns if isinstance(table[c], np.ndarray)]
    assert numeric == list(ADULT_NUMERIC), numeric
    blank = int(np.isnan(table["hours-per-week"]).sum())
    assert blank > 0
    return table, {"rows": len(table), "columns": len(table.columns), "bytes": len(data),
                   "native_seconds": native_s, "native_mb_per_s": len(data) / 1e6 / native_s,
                   "csv_module_seconds": slow_s, "csv_module_mb_per_s": len(data) / 1e6 / slow_s,
                   "numeric_columns": numeric, "blank_hours_per_week": blank,
                   "native_equals_csv_module": True}


def tabular_fit(table, folder: Path) -> dict:
    """(b) CleanMissingData -> TrainClassifier(GBDTClassifier) on the card:
    100 rounds of 31 leaves (3,100 K1 launches), held-out metrics, card
    scores = the host walk; PARITY_ROUNDS rounds on "cpu" and "cuda"; the fitted
    PipelineModel saved and loaded; a fit from Cacher'd columns."""
    from unittest import mock

    from mmlspark_tpu_torch.core import PipelineStage, Table
    from mmlspark_tpu_torch.gbdt import GBDTClassifier, engine
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
    from mmlspark_tpu_torch.ops import Cacher

    train = table.slice(0, TABULAR_ROWS)
    held = table.slice(TABULAR_ROWS, len(table))
    torch.cuda.synchronize()
    histogram.launches = 0
    t0 = time.perf_counter()
    fitted = _tabular_pipeline(100, "cuda").fit(train)
    fit_s = time.perf_counter() - t0
    launches = histogram.launches
    assert launches == 100 * 31, f"histogram launched {launches} times, want 3100"
    x = _featurized(fitted, train)
    assert x.shape == (TABULAR_ROWS, TABULAR_F), x.shape
    trained = fitted.stages[1]
    t0 = time.perf_counter()
    scored = fitted.transform(held)
    transform_s = time.perf_counter() - t0
    valid = _income_metrics(scored)
    assert valid["auc"] > 0.75 and valid["accuracy"] > 0.7, valid
    assert set(scored["prediction"]) <= {">50K", "<=50K"}
    booster = trained.inner_model.booster
    xh = _featurized(fitted, held)
    raw_card = booster.predict_raw(xh, device="device")
    assert raw_card.shape == (len(held),) and np.isfinite(raw_card).all()
    assert np.array_equal(raw_card, booster.predict_raw(xh, device="host")), \
        "card traversal differs from the host walk"

    # the saved and loaded PipelineModel scores the held-out rows alike
    path = folder / "pipeline"
    fitted.save(str(path))
    loaded = PipelineStage.load(str(path))
    again = loaded.transform(held)
    assert np.array_equal(again["probability"], scored["probability"]) and \
        list(again["prediction"]) == list(scored["prediction"]), "the loaded pipeline scores otherwise"

    # PARITY_ROUNDS rounds on the CPU and the card (the first TABULAR_PARITY_ROWS):
    # the same matrix, trees by compare_fits through K1 (1e-4) and through
    # the CPU's row-order histogram in K1's place (1e-5)
    sub = train.slice(0, TABULAR_PARITY_ROWS)
    fits, seconds = {}, {}
    for key, device, hist in (("cpu", "cpu", engine.histogram),
                              ("cuda", "cuda", engine.histogram),
                              ("row_order", "cuda", _row_order_histogram)):
        with mock.patch.object(engine, "histogram", hist):
            t0 = time.perf_counter()
            fits[key] = _tabular_pipeline(PARITY_ROUNDS, device).fit(sub)
            seconds[key] = time.perf_counter() - t0
    mats = [_featurized(f, sub) for f in fits.values()]
    assert all(np.array_equal(m.view(np.uint32), mats[0].view(np.uint32)) for m in mats), \
        "the featurized matrices differ between the devices"
    cpu, card, rows = (fits[k].stages[1].inner_model.booster for k in ("cpu", "cuda", "row_order"))
    bins = cpu.bin_mapper.transform(mats[0])
    keys = ("trees_equal", "trees_compared", "near_ties", "max_value_err_over_tree_max")
    witness = compare_fits(cpu, rows, bins)
    k1 = compare_fits(cpu, card, bins, tol=1e-4)

    # Cacher onto the card, then a fit from the cached columns: the fit of
    # the host matrix rounded to f32, byte for byte
    y01 = np.asarray([v == ">50K" for v in train["income"]], np.float64)
    cached = Cacher(device="cuda").transform(Table({"features": x, "label": y01}))
    assert cached["features"].is_cuda and cached["features"].dtype == torch.float32
    assert cached["label"].dtype == torch.float32
    from_cache = GBDTClassifier(num_iterations=10, num_leaves=31, device="cuda").fit(cached)
    from_host = GBDTClassifier(num_iterations=10, num_leaves=31, device="cuda").fit(
        Table({"features": x.astype(np.float32), "label": y01.astype(np.float32)}))
    assert from_cache.booster.to_text() == from_host.booster.to_text(), \
        "the fit from Cacher'd columns differs from the f32 host fit"
    return fitted, {
        "rows": TABULAR_ROWS, "held_out_rows": len(held), "features": x.shape[1],
        "feature_kinds": sorted({s["kind"] for s in trained.featurizer.stages[0].specs}),
        "rounds": 100, "num_leaves": 31, "fit_seconds": fit_s, "histogram_launches": launches,
        "transform_seconds": transform_s, "valid_auc": valid["auc"],
        "valid_accuracy": valid["accuracy"], "card_equals_host_walk": True,
        "num_bins": int(booster.bin_mapper.num_bins.max()), "loaded_scores_equal": True,
        "parity": {"rows": TABULAR_PARITY_ROWS, "rounds": PARITY_ROUNDS,
                   "k1": {k: k1[k] for k in keys},
                   "row_order": {k: witness[k] for k in keys},
                   **{f"{k}_fit_seconds": s for k, s in seconds.items()}},
        "cacher_fit_equals_f32_host_fit": True}


def tabular_text() -> dict:
    """(c) TextFeaturizer (4,096 hashed features, IDF) -> GBDTClassifier on
    the card: 20 rounds of 31 leaves (620 K1 launches at F 4,096)."""
    from unittest import mock

    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.gbdt import GBDTClassifier, engine
    from mmlspark_tpu_torch.gbdt.binning import BinMapper
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
    from mmlspark_tpu_torch.text import TextFeaturizer

    t0 = time.perf_counter()
    docs, y = text_corpus(TEXT_DOCS)
    corpus_s = time.perf_counter() - t0
    table = Table({"text": docs, "label": y})
    fit_docs, held_docs = table.slice(0, TEXT_FIT_DOCS), table.slice(TEXT_FIT_DOCS, TEXT_DOCS)
    t0 = time.perf_counter()
    featurizer = TextFeaturizer(input_col="text", num_features=TEXT_FEATURES,
                                use_idf=True).fit(fit_docs)
    train, held = featurizer.transform(fit_docs), featurizer.transform(held_docs)
    featurize_s = time.perf_counter() - t0
    x, xh = train["features"], held["features"]
    assert x.shape == (TEXT_FIT_DOCS, TEXT_FEATURES) and np.isfinite(x).all()
    t0 = time.perf_counter()
    BinMapper(max_bin=255).fit(x).transform(x)
    binning_s = time.perf_counter() - t0

    seen = set()

    def spy(bins, stats, num_bins):
        seen.add((str(bins.dtype).replace("torch.", ""), tuple(bins.shape), num_bins))
        return histogram(bins, stats, num_bins)

    torch.cuda.synchronize()
    histogram.launches = 0
    with mock.patch.object(engine, "histogram", spy):
        t0 = time.perf_counter()
        model = GBDTClassifier(num_iterations=20, num_leaves=31, device="cuda").fit(train)
        fit_s = time.perf_counter() - t0
    launches = histogram.launches
    assert launches == 20 * 31, f"histogram launched {launches} times, want 620"
    assert seen == {("int32", (TEXT_FIT_DOCS, TEXT_FEATURES), TEXT_BINS)}, seen
    valid = _metrics(model.transform(held))
    assert valid["auc"] > 0.75, valid
    booster = model.booster
    raw_card = booster.predict_raw(xh, device="device")
    assert raw_card.shape == (len(xh),) and np.isfinite(raw_card).all()
    assert np.array_equal(raw_card, booster.predict_raw(xh, device="host")), \
        "card traversal differs from the host walk"
    # 2 rounds on the CPU and the card (the first TEXT_PARITY_DOCS)
    sub, two = train.slice(0, TEXT_PARITY_DOCS), {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        two[device] = GBDTClassifier(num_iterations=2, num_leaves=31, device=device).fit(sub).booster
        two[device + "_seconds"] = time.perf_counter() - t0
    keys = ("trees_equal", "trees_compared", "near_ties", "max_value_err_over_tree_max")
    parity = compare_fits(two["cpu"], two["cuda"], two["cpu"].bin_mapper.transform(sub["features"]),
                          tol=1e-4)
    return {"documents": TEXT_DOCS, "fit_documents": TEXT_FIT_DOCS, "vocabulary": TEXT_VOCAB,
            "features": TEXT_FEATURES, "tokens": int(sum(len(d.split()) for d in docs)),
            "corpus_seconds": corpus_s, "featurize_seconds": featurize_s,
            "featurize_documents_per_s": TEXT_DOCS / featurize_s,
            "binning_seconds_alone": binning_s, "rounds": 20, "num_leaves": 31,
            "fit_seconds": fit_s, "histogram_launches": launches, "k1_bins": TEXT_BINS,
            "valid_auc": valid["auc"], "valid_accuracy": valid["accuracy"],
            "card_equals_host_walk": True,
            "parity_2_rounds": {"documents": TEXT_PARITY_DOCS, **{k: parity[k] for k in keys},
                                "cpu_fit_seconds": two["cpu_seconds"],
                                "cuda_fit_seconds": two["cuda_seconds"]}}


def phase_slice_tabular(card: str) -> dict:
    """Tabular ingest, featurization and text through the entry points a
    user calls (items a-c above); `card` (phase_env's nvidia-smi name and
    power limit) stands beside its times and rates. Writes and removes
    build/chip_smoke_tabular/."""
    t0 = time.perf_counter()
    folder = ROOT / "build" / "chip_smoke_tabular"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    try:
        table, ingest = tabular_ingest(folder)
        fitted, fit = tabular_fit(table, folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    doc = {"phase": "slice_tabular", "card": card, "ingest": ingest, "fit": fit,
           "text": tabular_text()}
    doc["seconds"] = time.perf_counter() - t0
    emit(doc)
    doc["model"] = fitted             # slice_streaming scores the Adult CSV with it
    return doc


# ---- slice_serving: pipeline fusion and the serving server ---- #

# (a) batch scoring at bench.py's Adult widths (bench.py:62-65): 1,048,576
# rows of 14 f32 columns, 1% NaN in one, through CleanMissingData ->
# AssembleFeatures -> the regressor -> DataConversion, in 65,536-row chunks
SERVE_ROWS, SERVE_CHUNK, SERVE_FEATURES = 1 << 20, 65536, 14
# (b) keep-alive clients at each concurrency, SERVE_REQUESTS requests a level
SERVE_CONCURRENCY, SERVE_REQUESTS, SERVE_WIRE_REQUESTS = (1, 32, 256), 512, 64
# (c) the serving transformer over HTTP: requests of 512 token ids, half
# JSON, half the binary wire, at concurrency 64 (its max batch)
TOKEN_REQUESTS, TOKEN_CONCURRENCY, TOKEN_STAGED_ROWS = 1024, 64, 256
# requests of the pass forced onto the resident route
TOKEN_FORCED = 128


def _serving_columns(x: np.ndarray) -> dict:
    return {f"f{j}": np.ascontiguousarray(x[:, j]) for j in range(x.shape[1])}


def _assert_identical(staged, fused) -> None:
    """tests/test_fusion.py's TestByteIdentity._assert_identical: the same
    columns, dtypes, bytes and metadata."""
    assert staged.columns == fused.columns, (staged.columns, fused.columns)
    for c in staged.columns:
        s, f = staged[c], fused[c]
        if isinstance(s, np.ndarray):
            assert s.dtype == f.dtype, (c, s.dtype, f.dtype)
            assert s.tobytes() == f.tobytes(), f"column {c!r}: fused bytes differ"
        else:
            assert list(s) == list(f), c
        assert staged.meta(c) == fused.meta(c), c


def _wait_ready(srv, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not srv.ready:
        if time.monotonic() > deadline:
            raise TimeoutError("the serving server never became ready")
        time.sleep(0.02)


def _drive(srv, bodies: list, clients: int, headers=None) -> dict:
    """`clients` keep-alive connections posting `bodies` concurrently (body
    i from client i % clients), connected before anyone posts. Returns the
    reply entities in body order, each client RTT and the wall seconds.
    The connections open one after another before the client threads
    start: opened all at once they overflow the server's accept backlog
    (128), the overflow waits out SYN retries, and the first ones sit idle
    past the handler's 5 s keep-alive timeout, which closes them."""
    import http.client
    import threading

    replies, rtt, errors = [None] * len(bodies), [], []
    barrier = threading.Barrier(clients + 1)
    hdrs = headers or {"Content-Type": "application/json"}
    conns = []
    try:
        for _ in range(clients):
            conns.append(http.client.HTTPConnection(srv.host, srv.port, timeout=120))
            conns[-1].connect()
    except OSError:
        for conn in conns:
            conn.close()
        raise

    def client(k: int) -> None:
        conn = conns[k]
        try:
            barrier.wait()
            for i in range(k, len(bodies), clients):
                t0 = time.perf_counter()
                conn.request("POST", srv.api_path, body=bodies[i], headers=hdrs)
                r = conn.getresponse()
                replies[i] = (r.status, r.getheader("Content-Type"), r.read())
                rtt.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for t in threads:
        t.start()
    barrier.wait(timeout=120)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
    seconds = time.perf_counter() - t0
    assert not errors, f"serving clients failed: {errors[:3]}"
    assert all(r is not None and r[0] == 200 for r in replies), \
        f"non-200 replies: {[r[0] for r in replies if r is not None and r[0] != 200][:5]}"
    ms = np.asarray(rtt) * 1e3
    return {"replies": [r[2] for r in replies], "content_types": [r[1] for r in replies],
            "seconds": seconds, "client_p50_ms": float(np.percentile(ms, 50)),
            "client_p99_ms": float(np.percentile(ms, 99))}


def _server_counters(srv) -> dict:
    counts = {"seen": srv.requests_seen, "accepted": srv.requests_accepted,
              "answered": srv.requests_answered, "failed": srv.requests_failed,
              "shed": srv.requests_shed, "expired": srv.requests_expired}
    assert counts["seen"] == counts["accepted"] == counts["answered"], counts
    assert counts["failed"] == counts["shed"] == counts["expired"] == 0, counts
    return counts


def serving_regressor() -> tuple:
    """GBDTRegressor fitted on the Adult shape (make_dataset(32768, 14),
    features rounded to f32-representable values, the 0/1 label as the
    target: bench.py's hot-path recipe, bench.py:1975-1979) on the card,
    K1 counted over the fit."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressor
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    x, y = make_dataset(32768, SERVE_FEATURES)
    x = x.astype(np.float32).astype(np.float64)
    histogram.launches = 0
    t0 = time.perf_counter()
    model = GBDTRegressor(num_iterations=100, num_leaves=31, device="cuda").fit(
        Table({"features": x, "label": y}))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = histogram.launches
    assert launches == 3100, f"the regressor fit launched K1 {launches} times, want 3,100"
    return model, x, {"fit_seconds": fit_s, "histogram_launches": launches}


def serving_batch(model) -> dict:
    """(a) fuse(pipeline_model(CleanMissingData, AssembleFeatures, the
    regressor, DataConversion)).transform over 1,048,576 rows on the card:
    one fused segment of 4 stages, equal to the staged transform byte for
    byte, a second transform with no capture."""
    from mmlspark_tpu_torch.core import Table, fuse, pipeline_model, plan_fusion
    from mmlspark_tpu_torch.ops.conversion import DataConversion
    from mmlspark_tpu_torch.ops.featurize import AssembleFeatures
    from mmlspark_tpu_torch.ops.missing import CleanMissingData

    x, _ = make_dataset(SERVE_ROWS, SERVE_FEATURES, seed=29)
    x = x.astype(np.float32)
    rng = np.random.default_rng(31)
    x[rng.random(SERVE_ROWS) < 0.01, 0] = np.nan
    table = Table(_serving_columns(x))
    cols = list(table.columns)
    clean = CleanMissingData(input_cols=["f0"], output_cols=["f0"],
                             cleaning_mode="Mean").fit(table)
    asm = AssembleFeatures(columns_to_featurize=cols).fit(table)
    staged_model = pipeline_model(clean, asm, model,
                                  DataConversion(cols=["prediction"], convert_to="float"))
    plan = plan_fusion([staged_model])
    assert len(plan.segments) == 1 and plan.segments[0].fused, plan.describe()
    assert plan.n_fused_stages == 4 and plan.fusion_ratio == 1.0, plan.describe()
    fm = fuse(staged_model, mini_batch_size=SERVE_CHUNK, prefetch_depth=2, device="cuda")
    t0 = time.perf_counter()
    staged = staged_model.transform(table)
    staged_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    first = fm.transform(table)
    first_s = time.perf_counter() - t0
    _assert_identical(staged, first)
    seg = fm._segments[0]
    warm = seg._exec_cache.stats()
    captures = seg.captures
    t0 = time.perf_counter()
    fused = fm.transform(table)
    fused_s = time.perf_counter() - t0
    _assert_identical(staged, fused)
    again = seg._exec_cache.stats()
    assert again["misses"] == warm["misses"] and again["recompiles"] == warm["recompiles"], \
        (warm, again)
    assert seg.captures == captures, "the second transform captured a graph"
    stats = fm.last_stats["segments"][0]
    assert stats["kind"] == "fused", stats
    out = np.asarray(fused["prediction"])
    assert out.shape == (SERVE_ROWS,) and np.isfinite(out).all()
    return {"rows": SERVE_ROWS, "chunk": SERVE_CHUNK, "plan": plan.describe(),
            "staged_seconds": staged_s, "first_fused_seconds": first_s,
            "fused_seconds": fused_s, "staged_rows_per_s": SERVE_ROWS / staged_s,
            "fused_rows_per_s": SERVE_ROWS / fused_s, "graph_captures": seg.captures,
            "segment_stats": {k: v for k, v in stats.items() if k != "stages"},
            "byte_identical": True}


def serving_gbdt(model, x: np.ndarray) -> dict:
    """(b) serve_model(the regressor) over HTTP on the card: keep-alive
    clients at each SERVE_CONCURRENCY, a pass forced onto the resident
    route, binary-wire requests; every reply's bytes equal make_reply of
    the staged transform's."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.io_http import wire
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData, make_reply
    from mmlspark_tpu_torch.io_http.serving import serve_model

    cols = [f"f{j}" for j in range(SERVE_FEATURES)]
    rows = x[:SERVE_REQUESTS]
    bodies = [json.dumps({c: float(v) for c, v in zip(cols, row)}).encode() for row in rows]
    expect = [r.entity for r in make_reply(model.transform(Table({"features": rows})),
                                           "prediction")["reply"]]
    warm = HTTPRequestData.from_json("/", {c: float(v) for c, v in zip(cols, x[0])})
    t0 = time.perf_counter()
    srv = serve_model(model, cols, max_batch_size=256, warmup_request=warm, device="cuda")
    try:
        _wait_ready(srv)
        warm_s = time.perf_counter() - t0
        hp = srv.hot_path
        assert hp is not None and hp.disabled is None, \
            f"hot path disabled: {None if hp is None else hp.disabled}"
        ladder = list(srv.bucketer.ladder)
        assert sorted(hp.crossover) == ladder, (hp.crossover, ladder)
        levels = {}
        for clients in SERVE_CONCURRENCY:
            paths0 = dict(hp.path_requests)
            srv.reset_latency_stats()
            run = _drive(srv, bodies, clients)
            assert run["replies"] == expect, f"concurrency {clients}: replies differ"
            server = srv.latency_stats()
            levels[str(clients)] = {
                "requests": len(bodies), "seconds": run["seconds"],
                "requests_per_s": len(bodies) / run["seconds"],
                "server_p50_ms": server["p50_ms"], "server_p99_ms": server["p99_ms"],
                "client_p50_ms": run["client_p50_ms"], "client_p99_ms": run["client_p99_ms"],
                "routes": {p: n - paths0.get(p, 0) for p, n in hp.path_requests.items()
                           if n != paths0.get(p, 0)}}
        res0, batches0 = hp.path_requests["resident"], hp.resident_batches
        hp.force_path = "resident"
        srv.reset_latency_stats()
        forced = _drive(srv, bodies, 32)
        hp.force_path = None
        assert forced["replies"] == expect, "the resident route's replies differ"
        assert hp.path_requests["resident"] > res0 and hp.resident_batches > batches0, \
            "the card served no resident batch"
        server = srv.latency_stats()
        levels["resident_forced_32"] = {
            "requests": len(bodies), "seconds": forced["seconds"],
            "requests_per_s": len(bodies) / forced["seconds"],
            "server_p50_ms": server["p50_ms"], "server_p99_ms": server["p99_ms"],
            "client_p50_ms": forced["client_p50_ms"], "client_p99_ms": forced["client_p99_ms"],
            "resident_batches": hp.resident_batches - batches0}
        wire_bodies = [wire.encode_features_request(row) for row in rows[:SERVE_WIRE_REQUESTS]]
        binary = _drive(srv, wire_bodies, 8, headers={"Content-Type": wire.WIRE_CONTENT_TYPE,
                                                      "Accept": wire.WIRE_CONTENT_TYPE})
        for entity, ct, want in zip(binary["replies"], binary["content_types"], expect):
            assert wire.is_wire_content_type(ct), ct
            col, vals = wire.decode_reply(entity)
            assert col == "prediction"
            assert float(np.asarray(vals).ravel()[0]) == json.loads(want)["prediction"]
        counters = _server_counters(srv)
        snap = hp.snapshot()
    finally:
        srv.stop()
    return {"warmup_seconds": warm_s, "ladder": ladder, "crossover": snap["crossover"],
            "crossover_timings_ms": snap["timings_ms"], "levels": levels,
            "binary_requests": SERVE_WIRE_REQUESTS, "counters": counters,
            "paths": snap["paths"], "resident_batches": snap["resident_batches"],
            "round_trips": snap["round_trips"]}


def serving_transformer(bundle=None) -> dict:
    """(c) the serving transformer (8 layers, d_model 512, bf16 bundle,
    attention_impl="flash") as DeepModelTransformer(bfloat16=False) in a
    fused pipeline served over HTTP: TOKEN_REQUESTS requests of 512 token
    ids, half JSON and half the binary wire, then a pass forced onto the
    resident route; K2's wgmma launches 8 a fused forward, replays
    included; then 256 rows fused against the staged transform."""
    from mmlspark_tpu_torch.core import Table, fuse, pipeline_model
    from mmlspark_tpu_torch.io_http import wire
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData
    from mmlspark_tpu_torch.io_http.serving import serve_model
    from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle
    from mmlspark_tpu_torch.nn.attention import flash_attention

    if bundle is None:
        bundle = ModelBundle.init("transformer", (SLICE_TOKENS,), seed=0,
                                  attention_impl="flash", dtype="bfloat16",
                                  **SLICE_TRANSFORMER)
    runner = DeepModelTransformer(input_col="features", bfloat16=False, device="cuda",
                                  fetch_dict={"probability": "probability"}).set_model(bundle)
    fm = fuse(pipeline_model(runner), device="cuda")
    rng = np.random.default_rng(37)
    tokens = rng.integers(0, SLICE_TRANSFORMER["vocab_size"],
                          size=(TOKEN_REQUESTS, SLICE_TOKENS))
    cols = [f"t{j}" for j in range(SLICE_TOKENS)]
    half = TOKEN_REQUESTS // 2
    json_bodies = [json.dumps({c: int(v) for c, v in zip(cols, row)}).encode()
                   for row in tokens[:half]]
    wire_bodies = [wire.encode_features_request(row) for row in tokens[half:]]
    warm = HTTPRequestData.from_json("/", {c: int(v) for c, v in zip(cols, tokens[0])})

    flash_attention.launches = 0
    flash_attention.launches_by_path = {}
    t0 = time.perf_counter()
    srv = serve_model(fm, cols, output_col="probability", max_batch_size=TOKEN_CONCURRENCY,
                      warmup_request=warm, device="cuda")
    try:
        _wait_ready(srv)
        warm_s = time.perf_counter() - t0
        hp = srv.hot_path
        assert hp is not None and hp.disabled is None, \
            f"hot path disabled: {None if hp is None else hp.disabled}"
        seg = hp.executor.segment
        srv.reset_latency_stats()
        run_json = _drive(srv, json_bodies, TOKEN_CONCURRENCY)
        run_wire = _drive(srv, wire_bodies, TOKEN_CONCURRENCY,
                          headers={"Content-Type": wire.WIRE_CONTENT_TYPE,
                                   "Accept": wire.WIRE_CONTENT_TYPE})
        server = srv.latency_stats()
        batches0 = hp.resident_batches
        hp.force_path = "resident"
        forced = _drive(srv, json_bodies[:TOKEN_FORCED], TOKEN_CONCURRENCY)
        hp.force_path = None
        assert hp.resident_batches > batches0 and hp.path_requests["resident"] > 0, \
            "the card served no resident batch"
        assert hp.disabled is None, f"hot path disabled: {hp.disabled}"
        torch.cuda.synchronize()
        launches = dict(flash_attention.launches_by_path)
        forwards, captures, replays = seg.forwards, seg.captures, seg.replays
        probs = [np.asarray(json.loads(e)["probability"], np.float64)
                 for e in run_json["replies"] + forced["replies"]]
        for entity, ct in zip(run_wire["replies"], run_wire["content_types"]):
            assert wire.is_wire_content_type(ct), ct
            col, vals = wire.decode_reply(entity)
            assert col == "probability"
            probs.append(np.asarray(vals, np.float64).ravel())
        probs = np.stack(probs)
        assert probs.shape == (TOKEN_REQUESTS + len(forced["replies"]), 8)
        assert np.isfinite(probs).all()
        assert np.allclose(probs.sum(-1), 1.0, atol=1e-5), float(np.abs(probs.sum(-1) - 1).max())
        layers = SLICE_TRANSFORMER["num_layers"]
        assert captures > 0 and replays > 0, (captures, replays)
        assert set(launches) == {"wgmma"}, launches
        assert launches["wgmma"] == layers * forwards, \
            f"K2 launched {launches['wgmma']} times on wgmma for {forwards} fused forwards"
        counters = _server_counters(srv)
        snap = hp.snapshot()
    finally:
        srv.stop()
    seconds = run_json["seconds"] + run_wire["seconds"]
    # 256 rows fused (one graph at that rung) against the staged transform
    sample = Table({"features": tokens[:TOKEN_STAGED_ROWS].astype(np.float64)})
    fused = np.asarray(fm.transform(sample)["probability"])
    staged = np.asarray(runner.transform(sample)["probability"])
    assert fused.dtype == staged.dtype == np.float32
    np.testing.assert_allclose(fused, staged, atol=1e-4, rtol=0)
    return {"requests": TOKEN_REQUESTS, "tokens_per_request": SLICE_TOKENS,
            "concurrency": TOKEN_CONCURRENCY, "warmup_seconds": warm_s,
            "seconds": seconds, "requests_per_s": TOKEN_REQUESTS / seconds,
            "tokens_per_s": TOKEN_REQUESTS * SLICE_TOKENS / seconds,
            "json_seconds": run_json["seconds"], "wire_seconds": run_wire["seconds"],
            "server_p50_ms": server["p50_ms"], "server_p99_ms": server["p99_ms"],
            "client_p50_ms": float(np.median([run_json["client_p50_ms"],
                                              run_wire["client_p50_ms"]])),
            "json_client_p50_ms": run_json["client_p50_ms"],
            "json_client_p99_ms": run_json["client_p99_ms"],
            "wire_client_p50_ms": run_wire["client_p50_ms"],
            "wire_client_p99_ms": run_wire["client_p99_ms"],
            "flash_launches": launches["wgmma"], "fused_forwards": forwards,
            "graph_captures": captures, "graph_replays": replays,
            "paths": snap["paths"], "resident_batches": snap["resident_batches"],
            "crossover": snap["crossover"], "counters": counters,
            "staged_rows": TOKEN_STAGED_ROWS,
            "fused_equals_staged_bytes": fused.tobytes() == staged.tobytes(),
            "fused_vs_staged_max_abs": float(np.abs(fused - staged).max())}


def phase_slice_serving(card: str, bundle=None, regressor=None) -> dict:
    """Pipeline fusion and the serving server on the card (items a-c
    above); `card` (phase_env's nvidia-smi name and power limit) stands
    beside every time and rate. `regressor`: serving_regressor()'s result
    when it was fitted earlier (slice_fusion_mesh scores it first)."""
    t0 = time.perf_counter()
    model, x, fit = regressor if regressor is not None else serving_regressor()
    doc = {"phase": "slice_serving", "card": card, "fit": fit,
           "batch": serving_batch(model), "gbdt_http": serving_gbdt(model, x),
           "transformer_http": serving_transformer(bundle)}
    doc["seconds"] = time.perf_counter() - t0
    emit(doc)
    doc["regressor"] = model          # slice_fleet serves it again
    b, g, t = doc["batch"], doc["gbdt_http"], doc["transformer_http"]
    print(f"slice_serving on {card}: fused {b['fused_rows_per_s']:.0f} rows/s, staged "
          f"{b['staged_rows_per_s']:.0f}; GBDT over HTTP "
          + ", ".join(f"c{k} p50 {v['server_p50_ms']:.3f}/{v['client_p50_ms']:.3f} ms p99 "
                      f"{v['server_p99_ms']:.3f}/{v['client_p99_ms']:.3f} ms"
                      for k, v in g["levels"].items())
          + f"; transformer {t['tokens_per_s']:.0f} tokens/s, p50 {t['server_p50_ms']:.2f} ms, "
          f"p99 {t['server_p99_ms']:.2f} ms, fused = staged bytes: "
          f"{t['fused_equals_staged_bytes']}", flush=True)
    return doc


# ---- slice_fleet: the serving fleet behind the gateway on the card ---- #

# (a) the Adult regressor: requests through the gateway and straight at one
# replica (bench.py's bench_fleet_gateway, bench.py:1878-1957, at the
# serving slice's concurrency), the kill window's sequential requests
FLEET_REQUESTS, FLEET_DIRECT, FLEET_CONCURRENCY = 1024, 256, 32
FLEET_KILL_BEFORE, FLEET_KILL_AFTER = 100, 200
# (b) the 8-layer transformer: requests of SLICE_TOKENS ids
FLEET_TOKEN_REQUESTS, FLEET_TOKEN_CONCURRENCY, FLEET_TOKEN_BATCH = 256, 16, 64
FLEET_STOP_TIMEOUT_S = 15.0
_SEEN = "mmlspark_tpu_serving_requests_seen_total"
_ANSWERED = "mmlspark_tpu_serving_requests_answered_total"
_FAILED = "mmlspark_tpu_serving_requests_failed_total"
_LATENCY = "mmlspark_tpu_serving_latency_seconds"


def _fleet_handler(model, cols: list, output_col: str, status_dir: str, started: float):
    """A replica's handler: the request fields stacked into the features
    matrix, the fused model's transform, make_reply. After each batch it
    writes the replica's own counters (K2's launches by path, the fused
    segment's forwards, captures and replays, the bytes its allocator
    holds on the card) and its clock (`started`: the factory's first line,
    after the replica's imports; `built`: the handler ready, before the
    warm-up) to status_dir/replica-<pid>.json: the parent reads them from
    there, never from its own counters."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.io_http.schema import make_reply, parse_request
    from mmlspark_tpu_torch.nn.attention import flash_attention

    status = Path(status_dir) / f"replica-{os.getpid()}.json"
    batches, built = [0], time.time()

    def handler(table):
        t = parse_request(table)
        feats = np.stack([np.asarray(t[c], np.float64) for c in cols], 1)
        out = make_reply(model.transform(Table({"request": list(table["request"]),
                                                "features": feats})), output_col)
        batches[0] += 1
        seg = model._segments[0]
        doc = {"pid": os.getpid(), "batches": batches[0], "started": started, "built": built,
               "launches_by_path": dict(flash_attention.launches_by_path),
               "forwards": seg.forwards, "captures": seg.captures, "replays": seg.replays,
               "memory_reserved": (torch.cuda.memory_reserved()
                                   if torch.cuda.is_initialized() else 0)}
        tmp = status.with_name(status.name + ".tmp")
        tmp.write_text(json.dumps(doc))
        os.replace(tmp, status)
        return out

    return handler


def fleet_regressor_factory(model_path: str, status_dir: str):
    """(a)'s replica: the regressor loaded from the file the parent saved,
    `fuse(pipeline_model(regressor))` on the card. Module-level, so that
    the spawned replica finds it by name."""
    started = time.time()
    from mmlspark_tpu_torch.core import fuse, pipeline_model
    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressionModel

    model = fuse(pipeline_model(GBDTRegressionModel.load_native_model(model_path,
                                                                      device="cuda")),
                 device="cuda")
    return _fleet_handler(model, [f"f{j}" for j in range(SERVE_FEATURES)], "prediction",
                          status_dir, started)


def fleet_transformer_factory(bundle_path: str, status_dir: str):
    """(b)'s replica: the bundle loaded from the parent's file, served as
    DeepModelTransformer(bfloat16=False) fused on the card."""
    started = time.time()
    from mmlspark_tpu_torch.core import fuse, pipeline_model
    from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle

    runner = DeepModelTransformer(input_col="features", bfloat16=False, device="cuda",
                                  fetch_dict={"probability": "probability"}).set_model(
        ModelBundle.load(bundle_path))
    return _fleet_handler(fuse(pipeline_model(runner), device="cuda"),
                          [f"t{j}" for j in range(SLICE_TOKENS)], "probability", status_dir,
                          started)


def _compute_apps() -> list:
    """nvidia-smi's compute processes as (pid, MiB), one a CUDA context.
    In a container every pid may read as the same number, so a context is
    counted, not matched by pid."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return [(int(p), float(m)) for p, m in
            (line.split(",") for line in out.strip().splitlines() if line.strip())]


def _await_apps(n: int, timeout_s: float = 15.0) -> list:
    """The compute-process listing once it holds `n` contexts: a killed or
    stopped process's context is released by the CUDA driver a moment after
    the process is gone."""
    deadline = time.monotonic() + timeout_s
    apps = _compute_apps()
    while len(apps) != n and time.monotonic() < deadline:
        time.sleep(0.1)
        apps = _compute_apps()
    assert len(apps) == n, f"nvidia-smi lists {len(apps)} contexts, want {n}: {apps}"
    return apps


def _context_mib(apps: list) -> float:
    """The card memory the listed contexts hold. Where one pid stands for
    several contexts nvidia-smi gives that pid's total on each line."""
    per_pid = {}
    for pid, mib in apps:
        per_pid[pid] = max(per_pid.get(pid, 0.0), mib)
    return sum(per_pid.values())


def _spawn_times(status: dict, spawned: float, ready: float) -> list:
    """A replica's startup split at its own clock: spawn to the factory's
    first line (the interpreter, torch, the main module), the factory
    (model load, fuse), and the warm-up over the ladder to ready."""
    return [{"imports_s": s["started"] - spawned, "factory_s": s["built"] - s["started"],
             "warmup_s": ready - s["built"]} for s in status]


def _replica_status(status_dir: str) -> dict:
    return {doc["pid"]: doc for doc in
            (json.loads(p.read_text()) for p in Path(status_dir).glob("replica-*.json"))}


def _sequential(url: str, bodies: list) -> tuple:
    """bench.py's timed_posts: one keep-alive connection, `bodies` posted
    in turn. A dropped socket is a client-visible error (status 0); the
    client reconnects and carries on."""
    import http.client
    import urllib.parse

    p = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(p.hostname, p.port, timeout=60)
    statuses, replies = [], []
    try:
        for body in bodies:
            try:
                conn.request("POST", p.path or "/", body=body,
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                replies.append(r.read())
                statuses.append(r.status)
            except OSError:
                statuses.append(0)
                replies.append(None)
                conn.close()
                conn = http.client.HTTPConnection(p.hostname, p.port, timeout=60)
    finally:
        conn.close()
    return statuses, replies


def _url_target(url: str):
    import types
    import urllib.parse

    p = urllib.parse.urlsplit(url)
    return types.SimpleNamespace(host=p.hostname, port=p.port, api_path=p.path or "/")


def _replica_info(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def fleet_regressor(model, tmp: Path) -> dict:
    """(a) and (c): the Adult regressor on two card replicas behind a
    ServingGateway, the fleet's SLOs, timeline and autoscaler over them,
    the kill window, a respawn, a rolling swap under load and the stop."""
    import functools
    import threading

    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.io_http.autoscale import FleetAutoscaler
    from mmlspark_tpu_torch.io_http.gateway import ServingGateway
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData, make_reply
    from mmlspark_tpu_torch.io_http.serving import ServingFleet
    from mmlspark_tpu_torch.observability.fleet import parse_prometheus
    from mmlspark_tpu_torch.observability.slo import (SLOEngine, availability_slo,
                                                      latency_slo)
    from mmlspark_tpu_torch.observability.timeline import TimelineRecorder, TimelineStore

    model_path, status_dir = str(tmp / "regressor.json"), tmp / "regressor_status"
    status_dir.mkdir()
    model.save_native_model(model_path)
    cols = [f"f{j}" for j in range(SERVE_FEATURES)]
    x, _ = make_dataset(FLEET_REQUESTS, SERVE_FEATURES, seed=41)
    x = x.astype(np.float32).astype(np.float64)
    bodies = [json.dumps({c: float(v) for c, v in zip(cols, row)}).encode() for row in x]
    expect = [r.entity for r in make_reply(model.transform(Table({"features": x})),
                                           "prediction")["reply"]]
    factory = functools.partial(fleet_regressor_factory, model_path, str(status_dir))
    warm = HTTPRequestData.from_json("/", {c: float(v) for c, v in zip(cols, x[0])})
    base_apps = _compute_apps()
    base = len(base_apps)
    doc = {"requests": FLEET_REQUESTS, "concurrency": FLEET_CONCURRENCY,
           "baseline_contexts": base}
    t0, spawned = time.perf_counter(), time.time()
    fleet = ServingFleet(factory, n_hosts=2, max_batch_size=256, bucket_batches=True,
                         warmup_request=warm, stop_timeout_s=FLEET_STOP_TIMEOUT_S).start()
    gw = rec = None
    try:
        doc["spawn_to_ready_s"] = time.perf_counter() - t0
        doc["spawn_split"] = _spawn_times(_replica_status(str(status_dir)).values(), spawned,
                                          time.time())
        apps = _await_apps(base + 2)
        assert all(m > 0 for _p, m in apps), apps
        doc["contexts_with_replicas"] = apps
        doc["replica_context_mib"] = (_context_mib(apps) - _context_mib(base_apps)) / 2
        rv = fleet.rendezvous
        engine = SLOEngine(rv.aggregator, slos=[
            availability_slo("availability", 0.99, total=_SEEN, bad=_FAILED),
            latency_slo("latency", 0.99, histogram=_LATENCY, threshold_s=0.25)])
        rv.attach_slo(engine)
        rv.aggregator.scrape()
        engine.evaluate()
        rec = TimelineRecorder(str(tmp / "timeline"), rv.aggregator, interval_s=1.0)
        rec.start()
        gw = ServingGateway().attach_fleet(fleet).start()

        run = _drive(_url_target(gw.url), bodies, FLEET_CONCURRENCY)
        assert run["replies"] == expect, "gateway replies differ from make_reply"
        direct = _drive(_url_target(fleet.urls[0]), bodies[:FLEET_DIRECT], FLEET_CONCURRENCY)
        assert direct["replies"] == expect[:FLEET_DIRECT], "direct replies differ"
        doc["gateway"] = {k: run[k] for k in ("seconds", "client_p50_ms", "client_p99_ms")}
        doc["gateway"]["requests_per_s"] = FLEET_REQUESTS / run["seconds"]
        doc["direct"] = {k: direct[k] for k in ("seconds", "client_p50_ms", "client_p99_ms")}
        doc["direct"]["requests_per_s"] = FLEET_DIRECT / direct["seconds"]

        # the rendezvous totals against the replicas' own counters
        info = fleet.info()
        own = [_replica_info(u) for u in fleet.urls]
        per_replica = sorted(r["answered"] for r in info["replicas"])
        assert all(n > 0 for n in per_replica), f"a replica answered nothing: {info}"
        assert sorted(o["answered"] for o in own) == per_replica, (own, info)
        assert info["totals"]["answered"] == sum(o["answered"] for o in own) \
            >= FLEET_REQUESTS + FLEET_DIRECT, (info, own)
        assert info["totals"]["seen"] == sum(o["seen"] for o in own), (info, own)
        text = rv.render_metrics()
        families = {f.name for f in parse_prometheus(text)}
        assert _ANSWERED in families, sorted(families)[:20]
        doc["replica_answered"] = per_replica
        doc["fleet_totals"] = info["totals"]

        # (c) the SLO gauges, the timeline reopened from disk, one tick
        assert {"mmlspark_tpu_slo_burn_rate",
                "mmlspark_tpu_slo_budget_remaining_ratio"} <= families, sorted(families)
        rec.sample()
        answered = fleet.info()["totals"]["answered"]
        store = TimelineStore(str(tmp / "timeline"))
        # the fleet-merged series, one a label set: each one's last value
        stored = sum(pts[-1][1] for pts in store.series(_ANSWERED).values())
        assert stored == answered, (stored, answered)
        slo = engine.evaluate()
        scaler = FleetAutoscaler(fleet, engine, min_replicas=2, max_replicas=2,
                                 timeline=rec)
        decision = scaler.tick()
        assert decision in ("none", "up", "down", "respawn"), decision
        doc["observability"] = {
            "slo": {k: {"burn_rates": v["burn_rates"], "alerting": v["alerting"],
                        "total": v["total"], "bad": v["bad"]} for k, v in slo.items()},
            "timeline_answered": stored, "timeline_samples": sum(1 for _ in store.samples()),
            "autoscaler_decision": decision,
            "autoscaler_signals": {k: v for k, v in scaler.state().items()
                                   if k in ("n_live", "pressure", "last_action")}}

        # the kill window: replica 1 dies without the fleet or gateway told
        statuses, replies = _sequential(gw.url, bodies[:FLEET_KILL_BEFORE])
        fleet._procs[1].kill()
        fleet._procs[1].join(timeout=10)
        after, replies_after = _sequential(
            gw.url, bodies[FLEET_KILL_BEFORE:FLEET_KILL_BEFORE + FLEET_KILL_AFTER])
        statuses += after
        replies += replies_after
        errors = sum(s != 200 for s in statuses)
        assert errors == 0, f"{errors} client-visible errors in the kill window"
        assert replies == expect[:FLEET_KILL_BEFORE + FLEET_KILL_AFTER]
        _await_apps(base + 1)
        doc["kill_window"] = {"requests": len(statuses), "errors": errors}

        t0 = time.perf_counter()
        url = fleet.respawn(1)
        doc["respawn_s"] = time.perf_counter() - t0
        assert _replica_info(url)["name"] == "mmlspark_tpu.serving"
        _await_apps(base + 2)

        # the rolling swap under a client's load: n + 1 replicas for a moment
        swap_statuses, swap_replies, stop_load = [], [], threading.Event()

        def load() -> None:
            i = 0
            while not stop_load.is_set():
                st, rep = _sequential(gw.url, [bodies[i % len(bodies)]])
                swap_statuses.append(st[0])
                swap_replies.append((i % len(bodies), rep[0]))
                i += 1

        loader = threading.Thread(target=load, daemon=True)
        loader.start()
        t0 = time.perf_counter()
        try:
            swapped = fleet.rolling_swap(factory)
        finally:
            stop_load.set()
            loader.join(timeout=60)
        doc["swap_s"] = time.perf_counter() - t0
        assert swapped == 2, swapped
        assert swap_statuses and all(s == 200 for s in swap_statuses), \
            f"{sum(s != 200 for s in swap_statuses)} errors in the swap: statuses " \
            f"{sorted({s for s in swap_statuses if s != 200})} of {len(swap_statuses)}"
        assert all(rep == expect[i] for i, rep in swap_replies), "swap replies differ"
        doc["swap"] = {"requests": len(swap_statuses), "errors": 0}
        doc["replica_allocator_bytes"] = {str(s["pid"]): s["memory_reserved"]
                                          for s in _replica_status(str(status_dir)).values()}
        doc["contexts_after_swap"] = _await_apps(base + 2)
    finally:
        if gw is not None:
            gw.stop()
        if rec is not None:
            rec.stop()
        procs = list(fleet._procs)
        t0 = time.perf_counter()
        fleet.stop()
        doc["stop_s"] = time.perf_counter() - t0
    assert all(p.exitcode is not None for p in procs), [p.exitcode for p in procs]
    assert doc["stop_s"] < FLEET_STOP_TIMEOUT_S + 10, doc["stop_s"]
    doc["contexts_after_stop"] = _await_apps(base)
    doc["replicas_spawned"] = len(procs)
    return doc


def fleet_transformer(bundle, tmp: Path) -> dict:
    """(b): the 8-layer transformer on two card replicas behind a gateway;
    each replica's K2 launches read back from that replica."""
    import functools

    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.io_http.gateway import ServingGateway
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData
    from mmlspark_tpu_torch.io_http.serving import ServingFleet
    from mmlspark_tpu_torch.nn import DeepModelTransformer

    bundle_path, status_dir = str(tmp / "transformer.bundle"), tmp / "transformer_status"
    status_dir.mkdir()
    bundle.save(bundle_path)
    rng = np.random.default_rng(43)
    tokens = rng.integers(0, SLICE_TRANSFORMER["vocab_size"],
                          size=(FLEET_TOKEN_REQUESTS, SLICE_TOKENS))
    cols = [f"t{j}" for j in range(SLICE_TOKENS)]
    bodies = [json.dumps({c: int(v) for c, v in zip(cols, row)}).encode() for row in tokens]
    runner = DeepModelTransformer(input_col="features", bfloat16=False, device="cuda",
                                  fetch_dict={"probability": "probability"}).set_model(bundle)
    staged = np.asarray(runner.transform(
        Table({"features": tokens.astype(np.float64)}))["probability"], np.float64)
    warm = HTTPRequestData.from_json("/", {c: int(v) for c, v in zip(cols, tokens[0])})
    base_apps = _compute_apps()
    base = len(base_apps)
    t0, spawned = time.perf_counter(), time.time()
    fleet = ServingFleet(functools.partial(fleet_transformer_factory, bundle_path,
                                           str(status_dir)),
                         n_hosts=2, max_batch_size=FLEET_TOKEN_BATCH, bucket_batches=True,
                         warmup_request=warm, stop_timeout_s=FLEET_STOP_TIMEOUT_S).start()
    gw = None
    try:
        doc = {"requests": FLEET_TOKEN_REQUESTS, "tokens_per_request": SLICE_TOKENS,
               "concurrency": FLEET_TOKEN_CONCURRENCY,
               "spawn_to_ready_s": time.perf_counter() - t0}
        doc["spawn_split"] = _spawn_times(_replica_status(str(status_dir)).values(), spawned,
                                          time.time())
        doc["contexts_with_replicas"] = _await_apps(base + 2)
        doc["replica_context_mib"] = (_context_mib(doc["contexts_with_replicas"])
                                      - _context_mib(base_apps)) / 2
        gw = ServingGateway().attach_fleet(fleet).start()
        run = _drive(_url_target(gw.url), bodies, FLEET_TOKEN_CONCURRENCY)
        info = fleet.info()
        assert all(r["answered"] > 0 for r in info["replicas"]), info
        doc["replica_answered"] = sorted(r["answered"] for r in info["replicas"])
    finally:
        if gw is not None:
            gw.stop()
        procs = list(fleet._procs)
        fleet.stop()
    assert all(p.exitcode is not None for p in procs), [p.exitcode for p in procs]
    doc["contexts_after_stop"] = _await_apps(base)
    probs = np.stack([np.asarray(json.loads(e)["probability"], np.float64)
                      for e in run["replies"]])
    assert probs.shape == (FLEET_TOKEN_REQUESTS, SLICE_TRANSFORMER["num_outputs"])
    assert np.isfinite(probs).all()
    assert np.allclose(probs.sum(-1), 1.0, atol=1e-5), float(np.abs(probs.sum(-1) - 1).max())
    np.testing.assert_allclose(probs, staged, atol=1e-4, rtol=0)
    doc["bytes_equal_staged"] = bool(probs.astype(np.float32).tobytes()
                                     == staged.astype(np.float32).tobytes())
    doc["max_abs_vs_staged"] = float(np.abs(probs - staged).max())
    layers = SLICE_TRANSFORMER["num_layers"]
    replicas = _replica_status(str(status_dir))
    assert len(replicas) == 2, replicas
    for rep in replicas.values():
        assert rep["forwards"] > 0 and rep["captures"] > 0 and rep["replays"] > 0, rep
        assert rep["launches_by_path"] == {"wgmma": layers * rep["forwards"]}, \
            f"replica {rep['pid']}: K2 {rep['launches_by_path']} for {rep['forwards']} forwards"
    doc["replicas"] = list(replicas.values())
    doc["flash_launches"] = sum(r["launches_by_path"]["wgmma"] for r in replicas.values())
    doc.update({k: run[k] for k in ("seconds", "client_p50_ms", "client_p99_ms")})
    doc["requests_per_s"] = FLEET_TOKEN_REQUESTS / run["seconds"]
    doc["tokens_per_s"] = FLEET_TOKEN_REQUESTS * SLICE_TOKENS / run["seconds"]
    return doc


def phase_slice_fleet(card: str, model, bundle) -> dict:
    """The serving fleet on the card ((a)-(c) above): replicas are spawned
    processes, each with its own CUDA context on the one card; `card`
    (phase_env's nvidia-smi name and power limit) stands beside every
    time and rate."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="slice_fleet_") as tmp:
        doc = {"phase": "slice_fleet", "card": card,
               "regressor": fleet_regressor(model, Path(tmp)),
               "transformer": fleet_transformer(bundle, Path(tmp))}
    doc["seconds"] = time.perf_counter() - t0
    emit(doc)
    a, b = doc["regressor"], doc["transformer"]
    print(f"slice_fleet on {card}: regressor through the gateway "
          f"{a['gateway']['requests_per_s']:.0f} requests/s, client p50 "
          f"{a['gateway']['client_p50_ms']:.2f} ms p99 {a['gateway']['client_p99_ms']:.2f} ms; "
          f"direct p50 {a['direct']['client_p50_ms']:.2f} ms p99 "
          f"{a['direct']['client_p99_ms']:.2f} ms; spawn-to-ready {a['spawn_to_ready_s']:.2f} s, "
          f"respawn {a['respawn_s']:.2f} s, swap {a['swap_s']:.2f} s, kill-window errors "
          f"{a['kill_window']['errors']} of {a['kill_window']['requests']}; "
          f"{a['replica_context_mib']:.0f} MiB a replica; transformer {b['tokens_per_s']:.0f} tokens/s, p50 "
          f"{b['client_p50_ms']:.2f} ms p99 {b['client_p99_ms']:.2f} ms, spawn-to-ready "
          f"{b['spawn_to_ready_s']:.2f} s, {b['replica_context_mib']:.0f} MiB a replica, "
          f"bytes equal staged: {b['bytes_equal_staged']}",
          flush=True)
    return doc


# ---- slice_train: DNN training through DNNLearner on the card ---- #

# bench.py's transformer at its training width (bench.py:632-634, :697-734):
# adamw at 1e-4, 32 rows x 512 tokens a step, the flash core in bf16
TRAIN_TRANSFORMER = dict(num_layers=8, d_model=512, num_heads=8, d_ff=2048, vocab_size=16384,
                         max_len=512, num_outputs=8, attention_impl="flash")
TRAIN_ROWS, TRAIN_TOKENS, TRAIN_BATCH, TRAIN_EPOCHS = 1024, 512, 32, 2   # once 3
# bench_trainer's ResNet-50 fine-tune (bench.py:770-800): 512 uint8 images
# of 224 x 224 x 3, 10 classes, batch 64, bf16 compute, f32 parameters
RESNET_ROWS, RESNET_SIDE, RESNET_BATCH, RESNET_EPOCHS = 512, 224, 64, 2
# items c-e: a 2-layer f32 flash transformer (d_model 64 over 4 heads, D 16)
SMALL_TRAIN = dict(num_layers=2, d_model=64, num_heads=4, d_ff=128, vocab_size=512, max_len=64,
                   num_outputs=4, attention_impl="flash")
SMALL_TRAIN_ROWS, SMALL_TRAIN_TOKENS, SMALL_TRAIN_BATCH = 256, 64, 32
# the reference's gate for flash gradients (tests/test_attention.py:86-88)
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4
# fits on two devices or two meshes after 2 epochs: every parameter leaf
# within this share of its largest magnitude
FIT_GAP = 1e-3
# K2 forward + backward rows: bench.py's training attention in both dtypes,
# and a causal one at a ragged length
TRAIN_FLASH_SHAPES = [
    ("train_bf16", 32, 512, 8, 64, torch.bfloat16, False),
    ("train_f32", 32, 512, 8, 64, torch.float32, False),
    ("train_causal_ragged_bf16", 2, 1000, 8, 64, torch.bfloat16, True),
]
# dq, dk, dv against the plain version's: f32 at the flash gradient gate;
# bf16 at the reference's bf16 gate between attention tiers
# (tests/test_attention.py:117): the gradients are rounded to bf16, and the
# output they are taken at may part from the plain one by a bf16 ulp or two
TRAIN_FLASH_TOL = {torch.float32: (GRAD_ATOL, GRAD_RTOL), torch.bfloat16: (3e-2, 3e-2)}


def banded_tokens(rows: int, tokens: int, vocab: int, classes: int, seed: int):
    """Token rows with a learnable label: row r's tokens come from its
    class's band of vocab // classes ids."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=rows)
    band = vocab // classes
    x = y[:, None] * band + rng.integers(0, band, size=(rows, tokens))
    return x, y.astype(np.float64)


def _learner(**params):
    from mmlspark_tpu_torch.nn import DNNLearner

    return DNNLearner(use_mesh=False, **params)


def _fit(est, x, y, init=None):
    from mmlspark_tpu_torch.core import Table

    est.init_bundle = init
    t0 = time.perf_counter()
    model = est.fit(Table({"features": x, "label": y}))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _leaf_gaps(a: dict, b: dict, prefix=()) -> dict:
    """Per leaf of two params trees: max |a - b| over max |a|. The attention
    key projection's bias is left out: its gradient is zero in exact
    arithmetic (a softmax row is unchanged by a shift common to its
    scores), so Adam turns rounding noise there into steps of either sign
    on any two devices; it changes no output."""
    out = {}
    for k, v in a.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(_leaf_gaps(v, b[k], path))
        elif path[-2:] != ("key", "bias"):
            w, g = np.asarray(v, np.float32), np.asarray(b[k], np.float32)
            out["/".join(path)] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    return out


def train_transformer() -> dict:
    """Item a: the transformer at bench.py's training width, TRAIN_EPOCHS (2)
    epochs of 32 steps; then one epoch under remat."""
    from mmlspark_tpu_torch.nn import ModelBundle
    from mmlspark_tpu_torch.nn.attention import flash_attention

    x, y = banded_tokens(TRAIN_ROWS, TRAIN_TOKENS, TRAIN_TRANSFORMER["vocab_size"],
                         TRAIN_TRANSFORMER["num_outputs"], seed=21)
    bundle = ModelBundle.init("transformer", (TRAIN_TOKENS,), seed=0, dtype="bfloat16",
                              **TRAIN_TRANSFORMER)
    steps = TRAIN_ROWS // TRAIN_BATCH
    layers = TRAIN_TRANSFORMER["num_layers"]
    out = {}
    for remat, epochs in ((False, TRAIN_EPOCHS), (True, 1)):
        est = _learner(architecture="transformer", optimizer="adamw", learning_rate=1e-4,
                       batch_size=TRAIN_BATCH, epochs=epochs, remat=remat)
        flash_attention.launches, flash_attention.launches_by_path = 0, {}
        _, seconds = _fit(est, x, y, bundle)
        launches, by_path = flash_attention.launches, dict(flash_attention.launches_by_path)
        want = (2 if remat else 1) * epochs * steps * layers
        assert launches == want and by_path == {"wgmma": want}, \
            f"remat={remat}: K2 launched {by_path}, want {want} on wgmma"
        losses = est.epoch_losses
        assert all(np.isfinite(losses)), losses
        tokens = epochs * steps * TRAIN_BATCH * TRAIN_TOKENS
        out["remat" if remat else "fit"] = {
            "epochs": epochs, "steps": epochs * steps, "seconds": seconds,
            "epoch_seconds": est.epoch_seconds, "epoch_losses": losses,
            "train_tokens_per_s": tokens / seconds,
            # the first epoch carries the cuBLAS and allocator warm-up
            "steady_tokens_per_s": (tokens - steps * TRAIN_BATCH * TRAIN_TOKENS)
            / sum(est.epoch_seconds[1:]) if epochs > 1 else None,
            "flash_launches": launches, "flash_launches_by_path": by_path}
        print(f"slice_train transformer remat={remat}: {tokens / seconds:.0f} train tokens/s, "
              f"epoch losses {losses}, K2 launches {launches}", flush=True)
    first, last = out["fit"]["epoch_losses"][0], out["fit"]["epoch_losses"][-1]
    assert last < first, f"the loss did not fall: {out['fit']['epoch_losses']}"
    out["profile"] = {name: profile_train_steps(bundle, x, y, TRAIN_BATCH, "adamw", 1e-4, remat)
                      for name, remat in (("step", False), ("remat_step", True))}
    return out


def profile_train_steps(bundle, x, y, batch: int, optimizer: str = "adam",
                        lr: float = 1e-3, remat: bool = False, steps: int = 3) -> dict:
    """Where a train step's time goes: DNNLearner's step (nn/trainer.py
    `loss_and_grads`, the optimizer, the new statistics) on `batch` rows of
    x, two warm-up steps, then `steps` under torch.profiler: wall and
    device kernel seconds a step, and the kernels that take most of it."""
    import copy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mmlspark_tpu_torch.core import prng
    from mmlspark_tpu_torch.nn.optim import Optimizer
    from mmlspark_tpu_torch.nn.runner import _to_device
    from mmlspark_tpu_torch.nn.trainer import TrainState, loss_and_grads

    dev = torch.device("cuda")
    ts = TrainState(copy.deepcopy(bundle.module).to(dev), Optimizer(optimizer, lr))
    bx, by = _to_device(x[:batch], dev), _to_device(y[:batch], dev)

    def step(k):
        _, grads, stats = loss_and_grads(ts, bx, by, prng.fold_in(prng.prng_key(1), k),
                                         "softmax_ce", remat=remat)
        ts.optimizer.step(ts.trained, grads, ts.opt_state)
        ts.install_stats(stats)

    for k in range(2):
        step(k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(steps):
            step(2 + k)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us, count = by_name.get(e.key, (0.0, 0))
            by_name[e.key] = (us + e.self_device_time_total, count + e.count)
    device_s = sum(us for us, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"steps": steps, "remat": remat, "wall_ms_per_step": wall_s / steps * 1e3,
            "device_ms_per_step": device_s / steps * 1e3 if by_name else None,
            "device_busy_share": device_s / wall_s if by_name else None,
            "kernels_per_step": sum(c for _, c in by_name.values()) / steps,
            "top_kernels": [{"name": k[:80], "ms_per_step": us / 1e3 / steps,
                             "count_per_step": c / steps} for k, (us, c) in top]}


def train_resnet50() -> dict:
    """Item b: bench_trainer's ResNet-50 fine-tune, 2 epochs of 8 steps."""
    from mmlspark_tpu_torch.nn import ModelBundle

    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, size=(RESNET_ROWS, RESNET_SIDE, RESNET_SIDE, 3), dtype=np.uint8)
    y = rng.integers(0, 10, size=RESNET_ROWS).astype(np.float64)
    bundle = ModelBundle.init("resnet50", x.shape[1:], seed=0, num_outputs=10,
                              dtype="bfloat16")
    est = _learner(architecture="resnet50", batch_size=RESNET_BATCH, epochs=RESNET_EPOCHS)
    model, seconds = _fit(est, x, y, bundle)
    assert all(np.isfinite(est.epoch_losses)), est.epoch_losses
    moved = _leaf_gaps(bundle.variables["batch_stats"], model.bundle.variables["batch_stats"])
    still = [k for k, v in moved.items() if v == 0.0]
    assert not still, f"BatchNorm statistics that did not move: {still[:5]}"
    images = RESNET_EPOCHS * (RESNET_ROWS // RESNET_BATCH) * RESNET_BATCH
    doc = {"rows": RESNET_ROWS, "side": RESNET_SIDE, "batch": RESNET_BATCH,
           "epochs": RESNET_EPOCHS, "seconds": seconds, "epoch_seconds": est.epoch_seconds,
           "epoch_losses": est.epoch_losses, "images_per_s": images / seconds,
           "steady_images_per_s": images / RESNET_EPOCHS / est.epoch_seconds[-1],
           "batch_stats_leaves_moved": len(moved),
           "profile": profile_train_steps(bundle, x, y, RESNET_BATCH, steps=2)}
    print(f"slice_train resnet50: {images / seconds:.1f} images/s, "
          f"epoch losses {est.epoch_losses}", flush=True)
    return doc


def small_train_data():
    return banded_tokens(SMALL_TRAIN_ROWS, SMALL_TRAIN_TOKENS, SMALL_TRAIN["vocab_size"],
                         SMALL_TRAIN["num_outputs"], seed=23)


def small_train_bundle():
    from mmlspark_tpu_torch.nn import ModelBundle

    return ModelBundle.init("transformer", (SMALL_TRAIN_TOKENS,), seed=1, **SMALL_TRAIN)


def _small_params(**over) -> dict:
    return {"architecture": "transformer", "batch_size": SMALL_TRAIN_BATCH, "epochs": 2,
            "bfloat16": False, "seed": 4, **over}


def first_step_grads(bundle, x, y, device: str) -> dict:
    """The first step's gradients of DNNLearner(_small_params()) on
    `device`: its first shuffled batch and step key."""
    import copy

    from mmlspark_tpu_torch.core import prng
    from mmlspark_tpu_torch.nn.optim import Optimizer
    from mmlspark_tpu_torch.nn.runner import _to_device
    from mmlspark_tpu_torch.nn.trainer import TrainState, loss_and_grads

    p = _small_params()
    rows = np.random.default_rng(p["seed"]).permutation(len(x))[:p["batch_size"]]
    ts = TrainState(copy.deepcopy(bundle.module).to(device), Optimizer("adam", 1e-3))
    key = prng.fold_in(prng.fold_in(prng.prng_key(p["seed"] + 1), 0), 0)
    _, grads, _ = loss_and_grads(ts, _to_device(x[rows], torch.device(device)),
                                 _to_device(y[rows], torch.device(device)), key, "softmax_ce")
    return {n: g.cpu() for n, g in zip(ts.trained_names, grads)}


def train_cpu_vs_card() -> dict:
    """Item c: the small f32 flash transformer from one bundle on "cpu" and
    "cuda": the first step's gradients at the flash gradient gate, and the
    parameters after 2 epochs within FIT_GAP of each leaf's largest."""
    x, y = small_train_data()
    bundle = small_train_bundle()
    g_cpu, g_card = (first_step_grads(bundle, x, y, d) for d in ("cpu", "cuda"))
    grad_gap = 0.0
    for name, g in g_cpu.items():
        torch.testing.assert_close(g_card[name], g, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   msg=lambda m: f"first-step gradient of {name}: {m}")
        grad_gap = max(grad_gap, float((g_card[name] - g).abs().max()))
    fits = {d: _fit(_learner(device=d, **_small_params()), x, y, bundle) for d in ("cpu", "cuda")}
    gaps = _leaf_gaps(fits["cpu"][0].bundle.variables["params"],
                      fits["cuda"][0].bundle.variables["params"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= FIT_GAP, f"card and CPU fits part at {worst}: {gaps[worst]}"
    print(f"slice_train cpu vs card: first-step gradients within {grad_gap:.3g}, "
          f"largest parameter gap {gaps[worst]:.3g} of its leaf ({worst})", flush=True)
    return {"first_step_grad_max_abs": grad_gap, "param_gap": gaps[worst],
            "param_gap_leaf": worst, "cpu_seconds": fits["cpu"][1],
            "card_seconds": fits["cuda"][1]}


def trip_guard(after: int):
    """A PreemptionGuard that drains after its `after`-th step-boundary poll."""
    from mmlspark_tpu_torch.resilience.elastic import PreemptionGuard

    class Trip(PreemptionGuard):
        polls = 0

        def should_checkpoint(self) -> bool:
            self.polls += 1
            if self.polls >= after:
                self.request_drain("chip-smoke-trip")
            return super().should_checkpoint()

    return Trip(install=False)


def train_fused_and_resumed() -> dict:
    """Item d: on the card, fused epochs equal streamed ones, and a fit
    preempted at an epoch boundary or mid-epoch and resumed equals the
    uninterrupted fit, byte for byte (flax_blob.to_bytes of the
    variables)."""
    from mmlspark_tpu_torch.nn import flax_blob
    from mmlspark_tpu_torch.resilience.elastic import Preempted, set_active_guard

    x, y = small_train_data()
    bundle = small_train_bundle()
    ck = ROOT / "build" / "chip_smoke_train"

    def fit(**over):
        model, _ = _fit(_learner(**_small_params(**over)), x, y, bundle)
        return flax_blob.to_bytes(model.bundle.variables)

    def preempted(trip, **over):
        shutil.rmtree(ck, ignore_errors=True)
        set_active_guard(trip_guard(trip))
        try:
            fit(checkpoint_dir=str(ck), **over)
            raise AssertionError(f"the fit was not preempted at poll {trip}")
        except Preempted:
            pass
        finally:
            set_active_guard(None)
        resumed = fit(checkpoint_dir=str(ck), **over)
        shutil.rmtree(ck, ignore_errors=True)
        return resumed

    fused, streamed = fit(), fit(fused_epochs=False)
    assert fused == streamed, "fused and streamed epochs gave different bytes"
    # the fused path polls once an epoch: trip 1 drains after epoch 1; the
    # streamed path polls after every step: trip 5 drains mid-epoch 1
    boundary = preempted(1)
    mid = preempted(5, fused_epochs=False)
    assert boundary == fused, "the epoch-boundary resume parted from the uninterrupted fit"
    assert mid == fused, "the mid-epoch resume parted from the uninterrupted fit"
    print("slice_train fused = streamed = resumed at an epoch boundary = resumed mid-epoch",
          flush=True)
    return {"fused_equals_streamed": True, "epoch_boundary_resume_equal": True,
            "mid_epoch_resume_equal": True, "variables_bytes": len(fused)}


def dnn_mesh_job(x, y, variables, ranks: int) -> dict:
    """Run on every rank of a RankPool: DNNLearner(use_mesh=True) on the
    card over the pool's mesh of `ranks` shards (one epoch of the small
    transformer); this rank's trained params."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import DNNLearner, ModelBundle
    from mmlspark_tpu_torch.parallel import get_mesh

    assert get_mesh().size == ranks
    est = DNNLearner(use_mesh=True, **_small_params(epochs=1))
    est.init_bundle = ModelBundle("transformer", dict(SMALL_TRAIN), variables,
                                  (SMALL_TRAIN_TOKENS,))
    return est.fit(Table({"features": x, "label": y})).bundle.variables["params"]


def train_data_parallel() -> dict:
    """Item e: 2 gloo ranks sharing the card, one epoch of the small
    transformer: both ranks hold the same bytes, within FIT_GAP of the
    one-device fit."""
    from mmlspark_tpu_torch.nn import flax_blob
    from mmlspark_tpu_torch.parallel import RankPool

    x, y = small_train_data()
    bundle = small_train_bundle()
    work = ROOT / "build" / "chip_smoke_train_mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    with RankPool(2, backend="gloo", workdir=str(work), timeout_s=600) as pool:
        spawn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = pool.run(dnn_mesh_job, x, y, bundle.variables, 2, deadline_s=600)
        mesh_s = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    assert flax_blob.to_bytes(ranks[0]) == flax_blob.to_bytes(ranks[1]), \
        "the two ranks hold different parameters"
    single, _ = _fit(_learner(**_small_params(epochs=1)), x, y, bundle)
    gaps = _leaf_gaps(single.bundle.variables["params"], ranks[0])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= FIT_GAP, f"the mesh fit parts from the one-device fit at {worst}"
    print(f"slice_train 2 gloo ranks: equal parameters, {gaps[worst]:.3g} of its leaf "
          f"from the one-device fit ({worst})", flush=True)
    return {"ranks": 2, "spawn_seconds": spawn_s, "mesh_fit_seconds": mesh_s,
            "ranks_equal": True, "param_gap_to_one_device": gaps[worst],
            "param_gap_leaf": worst}


def train_flash_rows() -> list:
    """Item f: K2 forward + the ported backward (FlashAttention) against the
    plain forward + the same backward, and SDPA's forward + backward as the
    library yardstick, at TRAIN_FLASH_SHAPES: dq, dk, dv errors and median
    ms of each. The bound: bytes of the forward (q, k, v read, out and lse
    written) and of the backward (q, k, v, out, do and lse read, dq, dk, dv
    written) at the card's memory rate; operations of the forward's two
    products and the backward's five (2.5 times the forward's) at the
    dtype's tensor-core rate (bf16 989 TFLOP/s; f32 as 3xTF32 at 495)."""
    import torch.nn.functional as F

    from mmlspark_tpu_torch.nn.attention import (FlashAttention, flash_attention,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_torch)

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            out, lse = flash_attention_torch(q, k, v, causal)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal = causal
            return out

        @staticmethod
        def backward(ctx, do):
            return (*flash_attention_bwd_torch(*ctx.saved_tensors, do, ctx.causal), None)

    rows = []
    for i, (name, b, t, h, d, dt, causal) in enumerate(TRAIN_FLASH_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        q, k, v, do = (torch.randn((b, t, h, d), generator=g, device="cuda").to(dt)
                       for _ in range(4))
        q, k, v = (a.requires_grad_(True) for a in (q, k, v))

        def fwd_bwd(fn):
            out = fn(q, k, v, causal)
            return torch.autograd.grad(out, (q, k, v), do)

        kern = fwd_bwd(lambda *a: FlashAttention.apply(*a, 128, 128))
        path = flash_attention.last_path
        plain = fwd_bwd(Plain.apply)
        atol, rtol = TRAIN_FLASH_TOL[dt]
        errs = {}
        for gname, a, p in zip(("dq", "dk", "dv"), kern, plain):
            torch.testing.assert_close(a.float(), p.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{name} {gname}: {m}")
            errs[gname] = float((a.float() - p.float()).abs().max())
        ms = median_ms(lambda: fwd_bwd(lambda *a: FlashAttention.apply(*a, 128, 128)),
                       reps=10, warmup=2)
        plain_ms = median_ms(lambda: fwd_bwd(Plain.apply), reps=5, warmup=1)
        qt, kt, vt = (a.detach().transpose(1, 2).contiguous().requires_grad_(True)
                      for a in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        library_ms = median_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), (qt, kt, vt), dot),
            reps=10, warmup=2)
        pairs = (sum(min(r + 1, t) for r in range(t)) if causal else t * t) * b * h
        ops = 4 * pairs * d * 3.5          # forward 4 * pairs * d, backward 2.5 times it
        item = q.element_size()
        qkv = 3 * b * t * h * d * item
        lse_bytes = b * h * t * 4
        bytes_moved = (qkv + b * t * h * d * item + lse_bytes                 # forward
                       + qkv + 2 * b * t * h * d * item + lse_bytes + qkv)    # backward
        bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
        ops_ms = (ops / H100_BF16_OPS_PER_S if dt == torch.bfloat16
                  else 3 * ops / H100_TF32_OPS_PER_S) * 1e3
        rows.append({"shape": name, "B": b, "T": t, "H": h, "D": d,
                     "dtype": str(dt).replace("torch.", ""), "causal": causal, "path": path,
                     "max_abs_err": max(errs.values()), "grad_max_abs_err": errs,
                     "atol": atol, "rtol": rtol, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bytes": bytes_moved, "ops": ops,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
        print(f"slice_train K2 fwd+bwd {name}: {ms:.3f} ms (plain {plain_ms:.3f}, "
              f"SDPA {library_ms:.3f}, bound {max(bytes_ms, ops_ms):.3f})", flush=True)
        del q, k, v, do, kern, plain, qt, kt, vt, dot
    return rows


def phase_slice_train() -> dict:
    """DNN training through DNNLearner on the card (items a-f above)."""
    t0 = time.perf_counter()
    doc = {"phase": "slice_train", "transformer": {"config": TRAIN_TRANSFORMER,
                                                   "rows": TRAIN_ROWS, "tokens": TRAIN_TOKENS,
                                                   "batch": TRAIN_BATCH, **train_transformer()},
           "resnet50": train_resnet50(), "cpu_vs_card": train_cpu_vs_card(),
           "fused_and_resumed": train_fused_and_resumed(),
           "data_parallel": train_data_parallel(), "flash_fwd_bwd": train_flash_rows()}
    doc["seconds"] = time.perf_counter() - t0
    emit(doc)
    return doc


# ---- slice_recsys_automl: recommendation and AutoML on the card ---- #

# MovieLens-1M's published shape (GroupLens ml-1m README): 6,040 users,
# 3,706 rated movies (ids up to 3,952), 1,000,209 ratings, each user at
# least 20; seeded here, no download
ML1M_USERS, ML1M_ITEMS, ML1M_MOVIE_IDS, ML1M_RATINGS = 6040, 3706, 3952, 1_000_209
RECS_K = 10
RECS_CPU_BLOCK = 1024           # the CPU's users when its full pass would take over ~15 s
RECS_TOL = 1e-5                 # of each row's largest rating
RECS_REQUESTS, RECS_CLIENTS = 2048, 32      # bench.py:2313-2400's driver
# TUNE_ROUNDS (once 20) and the sweep's SWEEP_ROUNDS (once 8, rungs of 4 and
# 8): cut to keep the smoke inside its limit on slower card hosts
TUNE_ROWS, TUNE_HELD_OUT, TUNE_ROUNDS, TUNE_PARITY_ROWS = 32768, 8192, 5, 3072
SWEEP_ROUNDS = 4
SWEEP_SPACE = [{"learning_rate": lr, "num_leaves": nl} for lr in (0.05, 0.1, 0.2)
               for nl in (4, 8)]                  # bench.py:2556-2625
LIME_IMAGES, LIME_SAMPLES, LIME_CELL, LIME_SIZE = 2, 300, 16, 224
LIME_SUPERPIXELS = (LIME_SIZE // LIME_CELL) ** 2


def movielens_1m(seed: int = 20) -> dict:
    """MovieLens-1M's shape, seeded: per-user counts heavy-tailed from 20
    (capped at half the movies), movies drawn without replacement under a
    Zipf-like popularity (rank weight 1/r^0.8, over a seeded order of the
    ids), ratings 1-5 leaning to 4, timestamps over three years."""
    rng = np.random.default_rng(seed)
    extra = rng.lognormal(0.0, 1.2, size=ML1M_USERS)
    counts = 20 + np.floor(extra / extra.sum() * (ML1M_RATINGS - 20 * ML1M_USERS)).astype(np.int64)
    cap = ML1M_ITEMS // 2
    counts = np.minimum(counts, cap)
    while counts.sum() < ML1M_RATINGS:
        room = np.flatnonzero(counts < cap)
        short = int(ML1M_RATINGS - counts.sum())
        counts[rng.choice(room, size=min(short, len(room)), replace=False)] += 1
    log_pop = (-0.8 * np.log(np.arange(1, ML1M_ITEMS + 1)))[rng.permutation(ML1M_ITEMS)]
    items = []
    for lo in range(0, ML1M_USERS, 512):
        hi = min(lo + 512, ML1M_USERS)
        # Gumbel top-k: a weighted draw without replacement, a block at a time
        keys = log_pop[None, :] + rng.gumbel(size=(hi - lo, ML1M_ITEMS))
        order = np.argsort(-keys, axis=1)
        items.extend(order[r, :counts[u]] for r, u in enumerate(range(lo, hi)))
    movie_ids = np.sort(rng.choice(np.arange(1, ML1M_MOVIE_IDS + 1), ML1M_ITEMS, replace=False))
    user = np.repeat(np.arange(1, ML1M_USERS + 1), counts)
    movie = movie_ids[np.concatenate(items)]
    assert len(user) == ML1M_RATINGS and len(np.unique(movie)) == ML1M_ITEMS
    rating = rng.choice(np.arange(1, 6), size=len(user), p=[0.06, 0.11, 0.26, 0.35, 0.22])
    time_s = 946_684_800.0 + rng.uniform(0.0, 3 * 365 * 86400.0, size=len(user))
    return {"user_id": user.astype(np.float64), "movie_id": movie.astype(np.float64),
            "rating": rating.astype(np.float64), "time": time_s}


def time_split(user: np.ndarray, time_s: np.ndarray, frac: float = 0.1) -> tuple:
    """Row indices of each user's interactions before and in its last `frac`
    by time (at least one of each)."""
    order = np.lexsort((time_s, user))
    u = user[order]
    starts = np.r_[0, np.flatnonzero(np.diff(u)) + 1]
    sizes = np.diff(np.r_[starts, len(u)])
    pos = np.arange(len(u)) - np.repeat(starts, sizes)
    n_test = np.maximum((sizes * frac).astype(np.int64), 1)
    test = pos >= np.repeat(sizes - n_test, sizes)
    return np.sort(order[~test]), np.sort(order[test])


def _recs_agree(card_ids, card_r, cpu_ids, cpu_r, tol: float = RECS_TOL) -> dict:
    """Ratings within `tol` of each row's largest; ids equal except at
    slots whose CPU rating lies within that of another in its row."""
    scale = np.maximum(np.abs(cpu_r).max(axis=1, keepdims=True), 1e-30)
    gap = float((np.abs(card_r - cpu_r) / scale).max())
    assert gap <= tol, f"ratings: card - CPU {gap} of the row's largest"
    near = np.abs(cpu_r[:, :, None] - cpu_r[:, None, :]) + np.eye(cpu_r.shape[1])[None] * 1e30
    clear = near.min(axis=2) > tol * scale
    assert np.array_equal(card_ids[clear], cpu_ids[clear]), "recommended ids differ off near-ties"
    return {"max_rating_err_over_row_max": gap, "slots": int(card_ids.size),
            "slots_near_ties": int((~clear).sum()),
            "ids_differing": int((card_ids != cpu_ids).sum())}


def _sub_model(model, lo: int, hi: int):
    """Users [lo, hi) of a fitted SARModel as a model of their own."""
    from mmlspark_tpu_torch.recommendation import SARModel

    sub = SARModel(user_col=model.get("user_col"), item_col=model.get("item_col"))
    sub.user_affinity = model.user_affinity[lo:hi]
    sub.item_similarity = model.item_similarity
    sub.seen = model.seen[lo:hi]
    return sub.to(model.device)


def _cpu_recs(cpu_model) -> tuple:
    """The CPU's top-k of every user if the first 1,024 users' pass says the
    whole would take at most ~15 s, else of those 1,024 only."""
    t0 = time.perf_counter()
    block = _sub_model(cpu_model, 0, RECS_CPU_BLOCK).recommend_for_all_users(k=RECS_K)
    block_s = time.perf_counter() - t0
    n = cpu_model.user_affinity.shape[0]
    if block_s * n / RECS_CPU_BLOCK <= 15.0:
        t0 = time.perf_counter()
        full = cpu_model.recommend_for_all_users(k=RECS_K)
        return full, n, time.perf_counter() - t0
    return block, RECS_CPU_BLOCK, block_s


def recsys_sar() -> dict:
    """(a) RecommendationIndexer -> SAR(jaccard, time decay) at MovieLens-1M's
    shape on the card and the CPU; recommend_for_all_users(k=10); then the
    ranking stages on a per-user time split."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.recommendation import (SAR, RankingAdapter, RankingEvaluator,
                                                   RankingTrainValidationSplit,
                                                   RecommendationIndexer, ranking_metrics)

    t0 = time.perf_counter()
    raw = Table(movielens_1m())
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    indexer = RecommendationIndexer(user_input_col="user_id", user_output_col="user",
                                    item_input_col="movie_id", item_output_col="item").fit(raw)
    table = indexer.transform(raw)
    index_s = time.perf_counter() - t0
    assert (indexer.n_users, indexer.n_items) == (ML1M_USERS, ML1M_ITEMS)
    sar_kw = dict(similarity_function="jaccard", rating_col="rating", time_col="time")

    def fit(device: str):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = SAR(device=device, **sar_kw).set_indexer_model(indexer).fit(table)
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    card, fit_s = fit("cuda")
    cpu, cpu_fit_s = fit("cpu")
    assert np.array_equal(card.item_similarity, cpu.item_similarity), \
        "the card's jaccard similarity differs from the CPU's"
    assert np.array_equal(card.user_affinity, cpu.user_affinity)
    seconds = []
    for _ in range(2):          # the first call uploads the model
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = card.recommend_for_all_users(k=RECS_K)
        seconds.append(time.perf_counter() - t0)
    dev = card._device_arrays()
    resident_mb = {name: t.numel() * t.element_size() / 1e6 for name, t in dev.items()}
    ids, ratings = np.asarray(recs["recommendations"]), np.asarray(recs["ratings"])
    assert ids.shape == (ML1M_USERS, RECS_K) and np.isfinite(ratings).all()
    again = card.recommend_for_all_users(k=RECS_K, user_block=1000)
    assert np.array_equal(np.asarray(again["recommendations"]), ids) and np.array_equal(
        np.asarray(again["ratings"]), ratings), "blocks of 1,000 differ from blocks of 4,096"
    cpu_recs, cpu_users, cpu_s = _cpu_recs(cpu)
    agree = _recs_agree(ids[:cpu_users], ratings[:cpu_users],
                        np.asarray(cpu_recs["recommendations"]), np.asarray(cpu_recs["ratings"]))

    # the ranking stages on each user's last 10% by time
    train_idx, test_idx = time_split(np.asarray(table["user"]), np.asarray(table["time"]))
    train, test = table.gather(train_idx), table.gather(test_idx)
    t0 = time.perf_counter()
    adapter = RankingAdapter(recommender=SAR(device="cuda", **sar_kw).set_indexer_model(indexer),
                             k=RECS_K).fit(train)
    scored = adapter.transform(test)
    rank_fit_s = time.perf_counter() - t0
    metrics = {name: RankingEvaluator(k=RECS_K, metric_name=name).evaluate(scored)
               for name in ("ndcgAt", "map", "precisionAtk", "recallAtK")}
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in metrics.values()), metrics

    class TimeSplitTVS(RankingTrainValidationSplit):
        def split(self, _table):
            return train, test

    tvs = TimeSplitTVS(recommender=SAR(device="cuda", **sar_kw).set_indexer_model(indexer),
                       k=RECS_K, param_maps=[{}]).fit(table)
    assert tvs.validation_metrics == [metrics["ndcgAt"]], (tvs.validation_metrics, metrics)
    cpu_adapter = RankingAdapter(recommender=SAR(device="cpu", **sar_kw).set_indexer_model(
        indexer), k=RECS_K).fit(train)
    card_train = adapter.recommender_model
    cpu_train = cpu_adapter.recommender_model
    assert np.array_equal(card_train.item_similarity, cpu_train.item_similarity)
    card_block = _sub_model(card_train, 0, RECS_CPU_BLOCK).recommend_for_all_users(k=RECS_K)
    cpu_block = _sub_model(cpu_train, 0, RECS_CPU_BLOCK).recommend_for_all_users(k=RECS_K)
    c_ids, p_ids = (np.asarray(r["recommendations"]) for r in (card_block, cpu_block))
    rank_agree = _recs_agree(c_ids, np.asarray(card_block["ratings"]), p_ids,
                             np.asarray(cpu_block["ratings"]))
    users = np.asarray(scored["user"]).astype(np.int64)
    mine = users < RECS_CPU_BLOCK
    labels = [scored["label"][i] for i in np.flatnonzero(mine)]
    card_m = ranking_metrics([list(c_ids[u]) for u in users[mine]], labels, RECS_K)
    cpu_m = ranking_metrics([list(p_ids[u]) for u in users[mine]], labels, RECS_K)
    same_lists = bool(np.array_equal(c_ids, p_ids))
    if same_lists:
        assert card_m == cpu_m, (card_m, cpu_m)
    return {"users": ML1M_USERS, "items": ML1M_ITEMS, "ratings": ML1M_RATINGS,
            "data_seconds": data_s, "index_seconds": index_s, "fit_seconds": fit_s,
            "cpu_fit_seconds": cpu_fit_s, "resident_mb": resident_mb,
            "similarity_bit_equal": True,
            "recommend_seconds_first_call": seconds[0], "recommend_seconds": seconds[1],
            "scored_users_per_s": ML1M_USERS / seconds[1],
            "cpu_users_compared": cpu_users, "cpu_recommend_seconds": cpu_s,
            "card_vs_cpu": agree, "blocked_1000_equal_4096": True,
            "ranking": {"train_rows": len(train_idx), "test_rows": len(test_idx),
                        "fit_and_score_seconds": rank_fit_s, "metrics": metrics,
                        "tvs_validation_ndcg": tvs.validation_metrics[0],
                        "card_vs_cpu_first_1024": rank_agree,
                        "first_1024_lists_equal": same_lists,
                        "card_metrics_first_1024": card_m, "cpu_metrics_first_1024": cpu_m},
            "model": card, "recs": recs}


def recsys_serving(model, recs) -> dict:
    """(b) serve_model(SARModel) -> serve_recommender twice: forced onto
    sar_resident, and with hot_path=False; 2,048 requests from 32 clients."""
    from mmlspark_tpu_torch.io_http.serving import serve_model
    from mmlspark_tpu_torch.recommendation.resident import SARHotPath

    rng = np.random.default_rng(23)
    users = rng.integers(0, ML1M_USERS, size=RECS_REQUESTS)
    bodies = [json.dumps({"user": int(u)}).encode() for u in users]
    ids = np.asarray(recs["recommendations"]).tolist()
    ratings = np.asarray(recs["ratings"]).tolist()
    oracle = [json.dumps({"recommendations": i, "ratings": r}).encode()
              for i, r in zip(ids, ratings)]
    servers = {}
    out = {"requests": RECS_REQUESTS, "clients": RECS_CLIENTS}
    try:
        for name, hot in (("resident", True), ("handler", False)):
            t0 = time.perf_counter()
            servers[name] = serve_model(model, hot_path=hot, max_batch_size=256,
                                        device="cuda")
            _wait_ready(servers[name])
            out[f"{name}_ready_seconds"] = time.perf_counter() - t0
        hp = servers["resident"].hot_path
        assert isinstance(hp, SARHotPath) and hp.disabled is None, hp and hp.snapshot()
        assert servers["handler"].hot_path is None
        hp.force_path = "sar_resident"
        replies = {}
        for name, srv in servers.items():
            got = _drive(srv, bodies, RECS_CLIENTS)
            replies[name] = got.pop("replies")
            got.pop("content_types")
            out[name] = {**got, "requests_per_s": RECS_REQUESTS / got["seconds"],
                         "counters": _server_counters(srv)}
        assert replies["resident"] == replies["handler"], "the two servers' replies differ"
        assert replies["resident"] == [oracle[u] for u in users], \
            "served replies differ from recommend_for_all_users"
        snap = hp.snapshot()
        assert hp.disabled is None and snap["enabled"], snap
        assert snap["paths"]["sar_resident"] == RECS_REQUESTS, snap["paths"]
        out["resident"]["warmup_ms_by_rung"] = {
            rung: t["sar_resident"] for rung, t in snap["timings_ms"].items()}
        out["resident"]["route_enabled"] = True
        out["replies_equal"] = True
    finally:
        for srv in servers.values():
            srv.stop()
    return out


def recsys_tune() -> dict:
    """(c) TuneHyperparameters over GBDTClassifier on the Adult shape, then
    FindBestModel against a default model on 8,192 held-out rows; a second
    run from the same checkpoint directory; one fold's fit card vs CPU."""
    from mmlspark_tpu_torch.automl import (DiscreteHyperParam, FindBestModel, GridSpace,
                                           TuneHyperparameters)
    from mmlspark_tpu_torch.automl.tune import _kfold_indices
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
    from mmlspark_tpu_torch.observability.recorder import get_recorder

    x_all, y_all = make_dataset(TUNE_ROWS + TUNE_HELD_OUT, 14)
    x, y, xv, yv = x_all[:TUNE_ROWS], y_all[:TUNE_ROWS], x_all[TUNE_ROWS:], y_all[TUNE_ROWS:]
    ck = ROOT / "build" / "chip_smoke_tune"
    shutil.rmtree(ck, ignore_errors=True)

    def tuner():
        return TuneHyperparameters(
            # one snapshot a fold fit, at its end: the template's own
            # cadence wins over the tuner's every-round default
            models=GBDTClassifier(num_iterations=TUNE_ROUNDS, checkpoint_every_n=TUNE_ROUNDS,
                                  device="cuda"),
            param_space=GridSpace({"learning_rate": DiscreteHyperParam([0.05, 0.1, 0.2]),
                                   "num_leaves": DiscreteHyperParam([15, 31])}),
            num_folds=2, parallelism=2, evaluation_metric="AUC", refit=True,
            checkpoint_dir=str(ck))

    try:
        torch.cuda.synchronize()
        histogram.launches = 0
        t0 = time.perf_counter()
        tuned = tuner().fit(_table(x, y))
        tune_s = time.perf_counter() - t0
        launches = histogram.launches
        trials = [r["params"] for r in tuned.all_results]
        want = (2 * sum(TUNE_ROUNDS * p["num_leaves"] for p in trials)
                + TUNE_ROUNDS * tuned.best_params["num_leaves"])
        assert launches == want, f"tuning launched K1 {launches} times, want {want}"
        default = GBDTClassifier(num_iterations=TUNE_ROUNDS, device="cuda").fit(_table(x, y))
        default_launches = histogram.launches - launches
        assert default_launches == TUNE_ROUNDS * 31, default_launches
        best = FindBestModel(models=[tuned, default], evaluation_metric="AUC").fit(
            _table(xv, yv))
        auc = float(best.best_model_metrics["AUC"])
        assert auc > 0.75, f"held-out AUC {auc}"

        seq0 = max((e["seq"] for e in get_recorder().events()), default=0)
        before = histogram.launches
        t0 = time.perf_counter()
        again = tuner().fit(_table(x, y))
        resume_s = time.perf_counter() - t0
        resume_launches = histogram.launches - before
        skipped = [e for e in get_recorder().events()
                   if e["seq"] > seq0 and e["kind"] == "tune.trial_skipped"]
        assert len(skipped) == len(trials), f"{len(skipped)} of {len(trials)} trials skipped"
        assert again.best_params == tuned.best_params
        assert again.best_model.booster.to_text() == tuned.best_model.booster.to_text()
    finally:
        shutil.rmtree(ck, ignore_errors=True)

    rows = _kfold_indices(len(y), 2, 0)[0][0][:TUNE_PARITY_ROWS]
    opts = dict(objective="binary", num_iterations=TUNE_ROUNDS, **tuned.best_params)
    before = histogram.launches
    fits = {d: Booster.train(x[rows], y[rows], TrainOptions(device=d, **opts))
            for d in ("cpu", "cuda")}
    parity_launches = histogram.launches - before
    assert parity_launches == TUNE_ROUNDS * tuned.best_params["num_leaves"], parity_launches
    parity = compare_fits(fits["cpu"], fits["cuda"], fits["cpu"].bin_mapper.transform(x[rows]),
                          tol=1e-4)
    return {"rows": len(y), "held_out_rows": len(yv), "trials": len(trials), "folds": 2,
            "rounds": TUNE_ROUNDS, "parallelism": 2, "tune_seconds": tune_s,
            "trials_per_min": 60.0 * len(trials) / tune_s,
            "best_params": tuned.best_params, "best_cv_auc": tuned.best_metric,
            "histogram_launches": histogram.launches,
            "tune_histogram_launches": launches, "default_histogram_launches": default_launches,
            "find_best_pick": "tuned" if best.best_model is tuned else "default",
            "held_out_auc": auc,
            "all_model_auc": [float(m["AUC"]) for m in best.all_model_metrics],
            "resume_seconds": resume_s, "resume_trials_skipped": len(skipped),
            "resume_histogram_launches": resume_launches,
            "parity_histogram_launches": parity_launches,
            "fold_parity": {"rows": TUNE_PARITY_ROWS, "trees_equal": parity["trees_equal"],
                            "trees_compared": parity["trees_compared"],
                            "near_ties": len(parity["near_ties"]),
                            "max_value_err_over_tree_max":
                                parity["max_value_err_over_tree_max"]}}


def recsys_sweep() -> dict:
    """(d) bench.py:2556-2625's sweep on the Adult shape: P=1 (one worker
    process), P=2 (two ServingFleet workers sharing the card) and P=2 with
    a SIGKILL before the 3rd sub-checkpoint save; equal digests."""
    from mmlspark_tpu_torch.automl import HyperbandPruner, SweepScheduler
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    x, y = make_dataset(TUNE_ROWS, 14)
    # a sub-checkpoint every SWEEP_ROUNDS // 2 rounds (a rung's budget), not every round
    est = GBDTClassifier(features_col="features", label_col="label",
                         num_iterations=SWEEP_ROUNDS, num_leaves=15, seed=7,
                         checkpoint_every_n=SWEEP_ROUNDS // 2, device="cuda")
    base = ROOT / "build" / "chip_smoke_sweep"
    shutil.rmtree(base, ignore_errors=True)
    runs = {}
    try:
        for name, workers, chaos in (("p1", 1, None), ("p2", 2, None),
                                     ("p2_chaos", 2, {"nth": 3, "mode": "before_save"})):
            sched = SweepScheduler(
                [est], trials=[(0, p) for p in SWEEP_SPACE], evaluation_metric="accuracy",
                label_col="label", num_folds=2, seed=0, checkpoint_dir=str(base / name),
                workers=workers, pruner=HyperbandPruner(
                    min_resource=SWEEP_ROUNDS // 2, max_resource=SWEEP_ROUNDS, eta=2),
                rung_timeout_s=240.0, chaos=chaos)
            before = histogram.launches
            t0 = time.perf_counter()
            res = sched.run(_table(x, y))
            seconds = time.perf_counter() - t0
            launches = histogram.launches - before
            # the driver refits the survivors on the full table (SWEEP_ROUNDS each)
            want = sum(SWEEP_ROUNDS * SWEEP_SPACE[ti]["num_leaves"] for ti in res.survivors)
            assert launches == want, (name, launches, want)
            builds = [c["builds"] for c in res.worker_counters]
            assert builds and all(b == 1.0 for b in builds), (name, res.worker_counters)
            if chaos:
                assert (base / name / "_chaos_fired").exists() and res.resumed_trials >= 1
            runs[name] = {"workers": workers, "seconds": seconds, "fits": len(res.results),
                          "trials_per_min": 60.0 * len(res.results) / seconds,
                          "digest": res.digest, "best_trial": res.best_trial,
                          "best_params": res.best_params, "best_metric": res.best_metric,
                          "pruned": res.pruned, "survivors": res.survivors,
                          "resumed_trials": res.resumed_trials, "worker_bin_builds": builds,
                          "worker_bin_hits": [c["hits"] for c in res.worker_counters],
                          "histogram_launches": launches}
    finally:
        shutil.rmtree(base, ignore_errors=True)
    digests = {r["digest"] for r in runs.values()}
    assert len(digests) == 1, f"sweep digests diverged: {runs}"
    return {"rows": len(y), "trials": len(SWEEP_SPACE), "runs": runs,
            "recovery_overhead": runs["p2_chaos"]["seconds"] / runs["p2"]["seconds"],
            "speedup_p2": runs["p1"]["seconds"] / runs["p2"]["seconds"],
            "histogram_launches": sum(r["histogram_launches"] for r in runs.values())}


def recsys_lime() -> dict:
    """(e) ImageLIME over the imported ResNet-50 at 224 (slice_featurize's
    weights) with its class head through DeepModelTransformer: 2 seeded
    images, 300 samples, 16-pixel cells (196 superpixels)."""
    from mmlspark_tpu_torch.automl import ImageLIME, superpixels
    from mmlspark_tpu_torch.automl.lime import slic_distances
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelDownloader, ModelSchema

    ref = reference_import_tests()
    repo = ROOT / "build" / "chip_smoke_lime"
    shutil.rmtree(repo, ignore_errors=True)
    try:
        src = repo / "src" / "resnet50.npz"
        src.parent.mkdir(parents=True, exist_ok=True)
        np.savez(src, **ref.synthetic_state_dict())
        zoo = ModelDownloader(str(repo / "zoo"))
        zoo.import_external(ModelSchema(name="resnet50_224", uri=str(src),
                                        architecture="resnet50",
                                        input_shape=(LIME_SIZE, LIME_SIZE, 3),
                                        num_outputs=1000))
        bundle = zoo.load_bundle("resnet50_224")
    finally:
        shutil.rmtree(repo, ignore_errors=True)
    model = DeepModelTransformer(input_col="image", fetch_dict={"probability": "probability"},
                                 mini_batch_size=64, device="cuda").set_model(bundle)
    images = np.random.default_rng(31).integers(
        0, 256, size=(LIME_IMAGES, LIME_SIZE, LIME_SIZE, 3)).astype(np.float32)
    lime = ImageLIME(model=model, num_samples=LIME_SAMPLES, cell_size=LIME_CELL, seed=0,
                     device="cuda")
    outs, seconds = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(lime.transform(Table({"image": images})))
        seconds.append(time.perf_counter() - t0)
    weights = [np.asarray(w) for w in outs[0]["weights"]]
    assert all(w.shape == (LIME_SUPERPIXELS,) and np.isfinite(w).all() for w in weights)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(weights, outs[1]["weights"])), \
        "two LIME runs differ"
    labels = np.asarray(outs[0]["superpixels"])
    flipped, near_total = 0, 0
    for i, img in enumerate(images):
        cpu, k = superpixels(img, LIME_CELL, device="cpu")
        d = np.sort(slic_distances(img, LIME_CELL, device="cpu"), axis=-1)
        near = (d[..., 1] - d[..., 0]) <= 1e-5 * np.maximum(d[..., 0], 1e-30)
        differ = labels[i] != cpu
        assert k == LIME_SUPERPIXELS and not (differ & ~near).any(), \
            "superpixels differ off near-ties"
        flipped += int(differ.sum())
        near_total += int(near.sum())
    return {"images": LIME_IMAGES, "samples": LIME_SAMPLES, "superpixels": LIME_SUPERPIXELS,
            "seconds_first_call": seconds[0], "seconds": seconds[1],
            "images_scored_per_s": LIME_IMAGES * LIME_SAMPLES / seconds[1],
            "weights_bit_equal_two_runs": True, "near_tie_pixels": near_total,
            "labels_differing_from_cpu": flipped,
            "max_abs_weight": float(max(np.abs(w).max() for w in weights))}


def phase_slice_recsys_automl(card: str) -> dict:
    """Recommendation and AutoML through the entry points a user calls
    (items a-e above)."""
    t0 = time.perf_counter()
    doc = {"phase": "slice_recsys_automl", "card": card}
    marks = {}
    sar = recsys_sar()
    marks["sar"] = time.perf_counter() - t0
    model, recs = sar.pop("model"), sar.pop("recs")
    doc["sar"] = sar
    doc["serving"] = recsys_serving(model, recs)
    marks["serving"] = time.perf_counter() - t0
    del model, recs
    doc["tune"] = recsys_tune()
    marks["tune"] = time.perf_counter() - t0
    doc["sweep"] = recsys_sweep()
    marks["sweep"] = time.perf_counter() - t0
    doc["lime"] = recsys_lime()
    marks["lime"] = time.perf_counter() - t0
    doc["seconds_at"] = marks
    doc["seconds"] = time.perf_counter() - t0
    emit(doc)
    return doc


# ---- slice_streaming: the phase profiler and streaming on the card ---- #

# (a) the serving transformer behind a batch-mode ServingServer streamed by
# a checkpointed StreamingQuery: requests of SLICE_TOKENS ids from
# STREAM_CLIENTS keep-alive clients (half JSON, half the binary wire), micro-
# batches of up to STREAM_MAX_ROWS; then STREAM_RESTART_REQUESTS parked
# requests, STREAM_RESTART_BATCHES micro-batches of STREAM_RESTART_ROWS
# answered before the query and its server stop, the rest answered by a
# restarted query from the journal
STREAM_REQUESTS, STREAM_CLIENTS, STREAM_MAX_ROWS = 256, 32, 64
STREAM_RESTART_REQUESTS, STREAM_RESTART_ROWS, STREAM_RESTART_BATCHES = 64, 16, 2
# (b) slice_tabular's Adult CSV in STREAM_CHUNKS files, STREAM_FIRST_BATCHES
# of them before the first query stops
STREAM_CHUNKS, STREAM_FIRST_BATCHES = 8, 2
# (c)/(d) the partition-parallel queries: P thread partitions, the fleet's
# partitions over its worker processes, event time STREAM_ROW_SECONDS a row
STREAM_PARTITIONS, STREAM_FLEET_WORKERS, STREAM_KILL_AFTER = 4, 2, 3
STREAM_ROW_SECONDS, STREAM_WINDOW_S, STREAM_WATERMARK_S = 0.01, 60.0, 5.0
# (e) the armed profiler on serve_model's transformer: requests a run,
# clients, and fused forwards under the device trace
PROFILE_REQUESTS, PROFILE_CLIENTS, PROFILE_TRACE_FORWARDS = 128, 16, 4
PROFILE_COVERAGE = (0.85, 1.15)
STREAM_TOKEN_COLS = [f"t{j}" for j in range(SLICE_TOKENS)]


def _stream_stages():
    """The host stages around the transformer in (a), and the one after
    the Adult scorer in (c)/(d): requests -> a token matrix, probabilities
    -> replies (binary to a client that accepts it, JSON otherwise), and
    P(>50K) as a column of its own."""
    from mmlspark_tpu_torch.core import Transformer
    from mmlspark_tpu_torch.io_http import wire
    from mmlspark_tpu_torch.io_http.schema import HTTPResponseData, RequestDecoder

    class DecodeTokens(Transformer):
        def _transform(self, table):
            reqs = list(table["request"])
            feats = RequestDecoder(STREAM_TOKEN_COLS).decode(reqs)
            assert feats is not None, "a request fell outside the token schema"
            return (table.with_column("features", feats)
                    .with_column("wire", [wire.accepts_wire(r.headers) for r in reqs]))

    class ReplyProbabilities(Transformer):
        def _transform(self, table):
            replies = []
            for p, binary in zip(np.asarray(table["probability"]), table["wire"]):
                if binary:
                    replies.append(HTTPResponseData(
                        200, "OK", {"Content-Type": wire.WIRE_CONTENT_TYPE},
                        wire.encode_reply("probability", p)))
                else:
                    replies.append(HTTPResponseData(
                        200, "OK", {"Content-Type": "application/json"},
                        json.dumps({"probability": p.tolist()}).encode()))
            return table.with_column("reply", replies)

    class HighIncomeProbability(Transformer):
        def _transform(self, table):
            p = np.asarray(table["probability"])[:, 1]
            return table.with_column("p_high", np.ascontiguousarray(p))

    return DecodeTokens, ReplyProbabilities, HighIncomeProbability


def _recording_reply_sink(srv, batches: list):
    """ReplySink that keeps each micro-batch's ids, token rows and
    probabilities before it answers them."""
    from mmlspark_tpu_torch.streaming import ReplySink

    class Recording(ReplySink):
        def add_batch(self, batch_id, table):
            batches.append((batch_id, [str(i) for i in table["id"]],
                            np.asarray(table["features"]), np.asarray(table["probability"])))
            super().add_batch(batch_id, table)

    return Recording(srv)


def _count_journal_replies(srv, counts) -> None:
    """Count each id's durable replies: the journal's record_reply returns
    False, and writes nothing, for an id it already answered."""
    record = srv.journal.record_reply

    def counted(ex_id, resp):
        ok = record(ex_id, resp)
        if ok:
            counts[str(ex_id)] += 1
        return ok

    srv.journal.record_reply = counted


def _k2_wgmma() -> int:
    from mmlspark_tpu_torch.nn.attention import flash_attention

    paths = dict(flash_attention.launches_by_path)
    assert set(paths) <= {"wgmma"}, paths
    return paths.get("wgmma", 0)


def streaming_serving(bundle, tmp: Path) -> dict:
    """(a) ServingSource -> the auto-fused serving transformer -> ReplySink
    in a checkpointed StreamingQuery; then a stop mid-stream and a restart
    on the same checkpoint and journal."""
    import collections
    import threading
    import urllib.request

    from mmlspark_tpu_torch.core import FusedPipelineModel, Table, pipeline_model
    from mmlspark_tpu_torch.io_http import ServingServer, wire
    from mmlspark_tpu_torch.nn import DeepModelTransformer
    from mmlspark_tpu_torch.streaming import ServingSource, StreamingQuery

    decode, reply, _ = _stream_stages()
    runner = DeepModelTransformer(input_col="features", bfloat16=False, device="cuda",
                                  mini_batch_size=STREAM_MAX_ROWS,
                                  fetch_dict={"probability": "probability"}).set_model(bundle)
    rng = np.random.default_rng(43)
    tokens = rng.integers(0, SLICE_TRANSFORMER["vocab_size"],
                          size=(STREAM_REQUESTS + STREAM_RESTART_REQUESTS, SLICE_TOKENS))
    json_bodies = [json.dumps({c: int(v) for c, v in zip(STREAM_TOKEN_COLS, row)}).encode()
                   for row in tokens]
    half = STREAM_REQUESTS // 2
    wire_bodies = [wire.encode_features_request(row) for row in tokens[half:STREAM_REQUESTS]]
    replied = collections.Counter()
    k2_before = _k2_wgmma()

    srv = ServingServer(mode="batch", checkpoint_dir=str(tmp / "journal"),
                        reply_timeout_s=120.0).start()
    _count_journal_replies(srv, replied)
    batches: list = []
    q = StreamingQuery(ServingSource(srv, max_rows=STREAM_MAX_ROWS),
                       pipeline_model(decode(), runner, reply()),
                       _recording_reply_sink(srv, batches), checkpoint_dir=str(tmp / "ckpt"),
                       trigger_interval_s=0.002, name="tokens", device="cuda")
    fm = q.transform
    assert isinstance(fm, FusedPipelineModel) and fm.plan().n_fused_stages == 1, fm.plan()
    q.start()
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            fj = pool.submit(_drive, srv, json_bodies[:half], STREAM_CLIENTS // 2)
            fw = pool.submit(_drive, srv, wire_bodies, STREAM_CLIENTS // 2,
                             {"Content-Type": wire.WIRE_CONTENT_TYPE,
                              "Accept": wire.WIRE_CONTENT_TYPE})
            run_json, run_wire = fj.result(), fw.result()
        seconds = time.perf_counter() - t0
        assert q.exception is None, q.exception
    finally:
        q.stop()
        srv.stop()
    seg = next(s for s in fm._ensure_segments() if hasattr(s, "forwards"))
    layers = SLICE_TRANSFORMER["num_layers"]
    k2_main = _k2_wgmma() - k2_before
    assert k2_main == layers * seg.forwards, \
        f"K2 launched {k2_main} times on wgmma for {seg.forwards} fused forwards"
    k2_before = _k2_wgmma()
    # every request answered once, each reply the probabilities its
    # micro-batch produced, each micro-batch against the staged transform
    assert len(replied) == STREAM_REQUESTS and set(replied.values()) == {1}, replied
    by_tokens = {}
    worst = 0.0
    sizes = []
    for _bid, ids, feats, probs in batches:
        sizes.append(len(ids))
        staged = np.asarray(runner.transform(Table({"features": feats}))["probability"])
        assert staged.dtype == probs.dtype == np.float32
        worst = max(worst, float(np.abs(staged - probs).max()))
        for row, p in zip(feats, probs):
            by_tokens[row.astype(np.int64).tobytes()] = p
    assert worst <= 1e-4, f"streamed vs staged micro-batch max abs {worst}"
    assert sum(sizes) == STREAM_REQUESTS, sizes
    # the staged transforms: one unfused forward a micro-batch (<= 64 rows)
    k2_staged = _k2_wgmma() - k2_before
    assert k2_staged == layers * len(batches), (k2_staged, len(batches))
    for i, entity in enumerate(run_json["replies"]):
        got = np.asarray(json.loads(entity)["probability"], np.float32)
        assert np.array_equal(got, by_tokens[tokens[i].tobytes()]), i
    for i, (entity, ct) in enumerate(zip(run_wire["replies"], run_wire["content_types"])):
        assert wire.is_wire_content_type(ct), ct
        col, vals = wire.decode_reply(entity)
        assert col == "probability"
        want = by_tokens[tokens[half + i].tobytes()].astype(np.float64)
        assert np.array_equal(np.asarray(vals).ravel(), want), half + i
    main = {"requests": STREAM_REQUESTS, "clients": STREAM_CLIENTS, "seconds": seconds,
            "requests_per_s": STREAM_REQUESTS / seconds,
            "tokens_per_s": STREAM_REQUESTS * SLICE_TOKENS / seconds,
            "micro_batches": len(batches), "micro_batch_rows": sizes,
            "json_client_p50_ms": run_json["client_p50_ms"],
            "json_client_p99_ms": run_json["client_p99_ms"],
            "wire_client_p50_ms": run_wire["client_p50_ms"],
            "wire_client_p99_ms": run_wire["client_p99_ms"],
            "streamed_vs_staged_max_abs": worst, "fused_forwards": seg.forwards,
            "graph_captures": seg.captures, "graph_replays": seg.replays,
            "flash_launches": k2_main, "staged_flash_launches": k2_staged}

    # restart: park STREAM_RESTART_REQUESTS, answer STREAM_RESTART_BATCHES
    # micro-batches, stop the query and its server mid-stream; a new server
    # re-parks the rest from the journal and a new query on the same
    # checkpoint answers each once
    forwards0 = seg.forwards
    k2_before = _k2_wgmma()
    journal, ckpt = str(tmp / "journal_restart"), str(tmp / "ckpt_restart")
    restart_ids = collections.Counter()
    srv1 = ServingServer(mode="batch", checkpoint_dir=journal, reply_timeout_s=120.0).start()
    _count_journal_replies(srv1, restart_ids)
    live = []

    def post(body: bytes) -> None:
        req = urllib.request.Request(srv1.url, data=body,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                live.append((r.status, r.read()))
        except Exception:  # noqa: BLE001 — the unanswered ones outlive their server
            pass

    posters = [threading.Thread(target=post, args=(b,), daemon=True)
               for b in json_bodies[STREAM_REQUESTS:]]
    for th in posters:
        th.start()
    deadline = time.monotonic() + 60
    while len(srv1.get_batch()) < STREAM_RESTART_REQUESTS:
        assert time.monotonic() < deadline, "the restart requests were never all parked"
        time.sleep(0.01)
    first: list = []
    q1 = StreamingQuery(ServingSource(srv1, max_rows=STREAM_RESTART_ROWS), fm,
                        _recording_reply_sink(srv1, first), checkpoint_dir=ckpt,
                        name="tokens-restart", device="cuda")
    for _ in range(STREAM_RESTART_BATCHES):
        assert q1.process_next()
    q1.stop()
    answered_first = STREAM_RESTART_BATCHES * STREAM_RESTART_ROWS
    deadline = time.monotonic() + 30
    while len(live) < answered_first and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(live) == answered_first and all(s == 200 for s, _ in live), live[:3]
    srv1.stop()
    srv2 = ServingServer(mode="batch", checkpoint_dir=journal).start()
    _count_journal_replies(srv2, restart_ids)
    reparked = len(srv2.get_batch())
    second: list = []
    q2 = StreamingQuery(ServingSource(srv2, max_rows=STREAM_RESTART_ROWS), fm,
                        _recording_reply_sink(srv2, second), checkpoint_dir=ckpt,
                        name="tokens-restart", device="cuda")
    try:
        resumed = q2.process_all_available()
    finally:
        q2.stop()
        srv2.stop()
    assert reparked == STREAM_RESTART_REQUESTS - answered_first, reparked
    assert len(restart_ids) == STREAM_RESTART_REQUESTS and set(restart_ids.values()) == {1}, \
        restart_ids
    assert [b[0] for b in first] == list(range(STREAM_RESTART_BATCHES))
    assert [b[0] for b in second] == list(range(STREAM_RESTART_BATCHES,
                                                STREAM_RESTART_BATCHES + resumed))
    k2_restart = _k2_wgmma() - k2_before
    assert k2_restart == layers * (seg.forwards - forwards0), (k2_restart, seg.forwards)
    k2_before = _k2_wgmma()
    worst_restart = 0.0
    for _bid, _ids, feats, probs in first + second:
        staged = np.asarray(runner.transform(Table({"features": feats}))["probability"])
        worst_restart = max(worst_restart, float(np.abs(staged - probs).max()))
    assert worst_restart <= 1e-4, worst_restart
    k2_staged_restart = _k2_wgmma() - k2_before
    assert k2_staged_restart == layers * len(first + second), k2_staged_restart
    main["restart"] = {"requests": STREAM_RESTART_REQUESTS, "answered_before_stop": answered_first,
                       "reparked": reparked, "batches_after_restart": resumed,
                       "each_answered_once": True, "streamed_vs_staged_max_abs": worst_restart,
                       "flash_launches": k2_restart,
                       "staged_flash_launches": k2_staged_restart}
    main["flash_launches_total"] = k2_main + k2_staged + k2_restart + k2_staged_restart
    return main


def _stream_same(a, b) -> None:
    """Byte equality of two tables, column order aside (as the reference's
    partition tests compare)."""
    assert sorted(a.columns) == sorted(b.columns), (a.columns, b.columns)
    assert a.num_rows == b.num_rows, (a.num_rows, b.num_rows)
    for c in a.columns:
        x, y = a[c], b[c]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (c, x.dtype, y.dtype)
            assert x.tobytes() == y.tobytes(), f"column {c!r} differs"
        else:
            assert list(x) == list(y), f"column {c!r} differs"


def streaming_adult(model, tmp: Path) -> tuple:
    """(b) DirectorySource over slice_tabular's Adult CSV in STREAM_CHUNKS
    files -> the fused Adult scorer -> ForeachBatchSink: a first query
    stopped after STREAM_FIRST_BATCHES, a second on the same checkpoint the
    rest; the concatenated output = one transform of the whole table, byte
    for byte. Returns the chunks as read, for (c)/(d)."""
    from mmlspark_tpu_torch.core import FusedPipelineModel, read_csv
    from mmlspark_tpu_torch.streaming import DirectorySource, ForeachBatchSink, StreamingQuery

    data = adult_csv_bytes(TABULAR_ROWS + TABULAR_HELD_OUT)
    (tmp / "adult.csv").write_bytes(data)
    lines = data.decode().splitlines(keepends=True)
    header, body = lines[0], lines[1:]
    per = len(body) // STREAM_CHUNKS
    folder = tmp / "adult_in"
    folder.mkdir()
    for i in range(STREAM_CHUNKS):
        part = body[i * per:] if i == STREAM_CHUNKS - 1 else body[i * per:(i + 1) * per]
        (folder / f"part-{i:03d}.csv").write_text(header + "".join(part))
    whole = read_csv(str(tmp / "adult.csv"))
    t0 = time.perf_counter()
    expected = model.transform(whole)
    whole_s = time.perf_counter() - t0

    collected = {}
    ck = str(tmp / "adult_ckpt")

    def query():
        return StreamingQuery(DirectorySource(str(folder), "*.csv", max_files_per_trigger=1),
                              model, ForeachBatchSink(lambda t, bid: collected.setdefault(bid, t)),
                              checkpoint_dir=ck, name="adult", device="cuda")

    t0 = time.perf_counter()
    q1 = query()
    assert isinstance(q1.transform, FusedPipelineModel)
    for _ in range(STREAM_FIRST_BATCHES):
        assert q1.process_next()
    q1.stop()
    q2 = query()
    rest = q2.process_all_available()
    q2.stop()
    stream_s = time.perf_counter() - t0
    assert rest == STREAM_CHUNKS - STREAM_FIRST_BATCHES, rest
    assert sorted(collected) == list(range(STREAM_CHUNKS)), sorted(collected)
    got = collected[0]
    for bid in range(1, STREAM_CHUNKS):
        got = got.concat(collected[bid])
    _assert_identical(expected, got)
    chunks = [read_csv(str(folder / f"part-{i:03d}.csv")) for i in range(STREAM_CHUNKS)]
    return chunks, {"rows": whole.num_rows, "files": STREAM_CHUNKS,
                    "batches_first_query": STREAM_FIRST_BATCHES,
                    "batches_second_query": rest, "stream_seconds": stream_s,
                    "rows_per_s": whole.num_rows / stream_s,
                    "whole_transform_seconds": whole_s, "bytes_equal_one_transform": True,
                    "segments": [s["kind"] for s in q2.transform.last_stats["segments"]]}


def _timed_chunks(chunks: list) -> list:
    """The Adult chunks with an event time `t`, STREAM_ROW_SECONDS a row
    in file order."""
    out, start = [], 0
    for c in chunks:
        out.append(c.with_column("t", (np.arange(c.num_rows) + start) * STREAM_ROW_SECONDS))
        start += c.num_rows
    return out


def _run_stream(source_batches, transform, parallel: bool, **kw):
    from mmlspark_tpu_torch.streaming import (MemorySink, MemorySource,
                                              ParallelStreamingQuery, StreamingQuery)

    src, sink = MemorySource(), MemorySink()
    cls = ParallelStreamingQuery if parallel else StreamingQuery
    q = cls(src, transform, sink, device="cuda", **kw)
    t0 = time.perf_counter()
    try:
        for b in source_batches:
            src.add_rows(b)
            q.process_all_available()
        seconds = time.perf_counter() - t0
    finally:
        q.stop()
    return q, sink.table(), seconds


def streaming_parallel(model, chunks: list) -> dict:
    """(c) The fused Adult scorer, then KeyedShuffle on occupation, then a
    GroupedAggregator and (apart) a WindowedAggregator keyed by it, at P =
    STREAM_PARTITIONS thread partitions against the P = 1 query."""
    from mmlspark_tpu_torch.core import pipeline_model
    from mmlspark_tpu_torch.streaming import (GroupedAggregator, KeyedShuffle,
                                              WindowedAggregator)

    _, _, high = _stream_stages()
    prefix = list(model.get("stages")) + [high()]
    batches = _timed_chunks(chunks)
    ops = {"grouped": lambda: GroupedAggregator(group_col="occupation", value_col="p_high",
                                                agg="mean"),
           "windowed": lambda: WindowedAggregator(time_col="t", window_s=STREAM_WINDOW_S,
                                                  group_col="occupation", value_col="p_high",
                                                  agg="mean",
                                                  watermark_delay_s=STREAM_WATERMARK_S)}
    out = {}
    for name, op in ops.items():
        _, p1, s1 = _run_stream(batches, pipeline_model(*prefix, op()), parallel=False)
        q, pn, sn = _run_stream(
            batches, pipeline_model(*prefix, KeyedShuffle(key_col="occupation",
                                                          num_partitions=STREAM_PARTITIONS), op()),
            parallel=True, workers="thread")
        _stream_same(pn, p1)
        assert p1.num_rows > 0
        out[name] = {"rows_out": p1.num_rows, "p1_seconds": s1, "p_seconds": sn,
                     "p1_rows_per_s": sum(b.num_rows for b in batches) / s1,
                     "p_rows_per_s": sum(b.num_rows for b in batches) / sn,
                     "shuffle_seconds": q.shuffle_seconds,
                     "partition_seconds": q.partition_seconds, "bytes_equal_p1": True,
                     "result": p1 if name == "grouped" else None}
    out["partitions"] = STREAM_PARTITIONS
    return out


def streaming_fleet(model, chunks: list, expected, tmp: Path) -> dict:
    """(d) (c)'s grouped query on workers="fleet": STREAM_FLEET_WORKERS
    ServingFleet worker processes on the binary wire, one SIGKILLed after
    STREAM_KILL_AFTER batches and respawned by a PartitionSupervisor; the
    result = the P = 1 query's, byte for byte. The workers run only the
    host chain: nvidia-smi's context count never grows."""
    from mmlspark_tpu_torch.core import pipeline_model
    from mmlspark_tpu_torch.resilience import PartitionSupervisor, RestartPolicy
    from mmlspark_tpu_torch.streaming import (GroupedAggregator, KeyedShuffle, MemorySink,
                                              MemorySource, ParallelStreamingQuery)

    _, _, high = _stream_stages()
    batches = _timed_chunks(chunks)
    pm = pipeline_model(*model.get("stages"), high(),
                        KeyedShuffle(key_col="occupation", num_partitions=STREAM_PARTITIONS),
                        GroupedAggregator(group_col="occupation", value_col="p_high", agg="mean"))
    contexts = len(_compute_apps())
    src, sink = MemorySource(), MemorySink()
    q = ParallelStreamingQuery(src, pm, sink, workers="fleet", num_workers=STREAM_FLEET_WORKERS,
                               binary_wire=True, checkpoint_dir=str(tmp / "fleet_ckpt"),
                               name="adult-fleet", device="cuda")
    sup = None
    t0 = time.perf_counter()
    try:
        src.add_rows(batches[0])
        q.process_all_available()
        spawn_s = time.perf_counter() - t0
        assert q._fleet.n_live == STREAM_FLEET_WORKERS
        with_workers = len(_compute_apps())
        procs = list(q._fleet._procs)
        sup = PartitionSupervisor(q._fleet, RestartPolicy(max_restarts=3, window_s=300.0),
                                  poll_interval_s=0.05).start()
        for b in batches[1:STREAM_KILL_AFTER]:
            src.add_rows(b)
            q.process_all_available()
        q._fleet.kill(0)
        t_kill = time.perf_counter()
        deadline = time.monotonic() + 60
        while q._fleet.dead_slots() or q._fleet.n_live < STREAM_FLEET_WORKERS:
            assert time.monotonic() < deadline, "the killed worker was never respawned"
            time.sleep(0.05)
        respawn_s = time.perf_counter() - t_kill
        for b in batches[STREAM_KILL_AFTER:]:
            src.add_rows(b)
            q.process_all_available()
        seconds = time.perf_counter() - t0
        respawned = [i for i, (a, b) in enumerate(zip(procs, q._fleet._procs)) if a is not b]
        respawns = sup.respawns
    finally:
        if sup is not None:
            sup.stop()
        q.stop()
    assert respawned == [0] and respawns == 1, (respawned, respawns)
    assert with_workers == contexts, f"fleet workers made CUDA contexts: {with_workers} vs {contexts}"
    _stream_same(sink.table(), expected)
    return {"workers": STREAM_FLEET_WORKERS, "partitions": STREAM_PARTITIONS,
            "binary_wire": True, "seconds": seconds, "spawn_and_first_batch_s": spawn_s,
            "respawn_s": respawn_s, "respawns": respawns, "cuda_contexts": with_workers,
            "bytes_equal_p1": True}


def _wgmma_in_trace(path: str) -> dict:
    """Whether the exported Chrome trace names K2's wgmma kernel, and inside
    the record_function range (the range's GPU-side annotation where the
    trace has one, else its CPU span widened to the kernels it launched)."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = [e for e in events if "flash_fwd_wgmma_kernel" in str(e.get("name", ""))
               and e.get("ph") == "X"]
    ranges = [e for e in events if e.get("name") == "slice_streaming.fused_forwards"
              and e.get("ph") == "X"]
    inside = 0
    for k in kernels:
        for r in ranges:
            if r["ts"] <= k["ts"] <= r["ts"] + r.get("dur", 0):
                inside += 1
                break
    return {"wgmma_kernels": len(kernels), "ranges": len(ranges),
            "range_kinds": sorted({r.get("cat", "") for r in ranges}),
            "wgmma_inside_range": inside}


def streaming_profiler(bundle, tmp: Path) -> dict:
    """(e) The phase profiler armed on one serve_model server of the
    transformer: PROFILE_REQUESTS forced onto the resident route disarmed,
    then armed; resident request ledgers' coverage of their RTT, the compute
    phase, K2 = 8 x fused forwards in both runs; the attribution table, and
    a device trace of PROFILE_TRACE_FORWARDS fused forwards."""
    from mmlspark_tpu_torch.core import Table, fuse, pipeline_model
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData
    from mmlspark_tpu_torch.io_http.serving import serve_model
    from mmlspark_tpu_torch.nn import DeepModelTransformer
    from mmlspark_tpu_torch.observability import (Profiler, render_attribution,
                                                  set_default_profiler)
    from mmlspark_tpu_torch.utils.profiling import annotate, device_trace

    runner = DeepModelTransformer(input_col="features", bfloat16=False, device="cuda",
                                  fetch_dict={"probability": "probability"}).set_model(bundle)
    fm = fuse(pipeline_model(runner), device="cuda")
    rng = np.random.default_rng(47)
    tokens = rng.integers(0, SLICE_TRANSFORMER["vocab_size"], size=(PROFILE_REQUESTS, SLICE_TOKENS))
    bodies = [json.dumps({c: int(v) for c, v in zip(STREAM_TOKEN_COLS, row)}).encode()
              for row in tokens]
    warm = HTTPRequestData.from_json("/", {c: int(v) for c, v in zip(STREAM_TOKEN_COLS, tokens[0])})
    layers = SLICE_TRANSFORMER["num_layers"]
    k2_start = _k2_wgmma()
    srv = serve_model(fm, STREAM_TOKEN_COLS, output_col="probability",
                      max_batch_size=PROFILE_CLIENTS, warmup_request=warm, device="cuda")
    prof = Profiler(enabled=True)
    prev, armed_here = None, False
    runs = {}
    try:
        _wait_ready(srv)
        hp = srv.hot_path
        assert hp is not None and hp.disabled is None, hp and hp.disabled
        seg = hp.executor.segment
        hp.force_path = "resident"
        _drive(srv, bodies[:PROFILE_CLIENTS], PROFILE_CLIENTS)       # warm the sockets
        for armed in (False, True):
            if armed:
                prev, armed_here = set_default_profiler(prof), True
            forwards0, k2_0 = seg.forwards, _k2_wgmma()
            run = _drive(srv, bodies, PROFILE_CLIENTS)
            torch.cuda.current_stream().synchronize()
            k2 = _k2_wgmma() - k2_0
            assert k2 == layers * (seg.forwards - forwards0), (armed, k2, seg.forwards - forwards0)
            runs["armed" if armed else "disarmed"] = {
                "client_p50_ms": run["client_p50_ms"], "client_p99_ms": run["client_p99_ms"],
                "seconds": run["seconds"], "flash_launches": k2,
                "fused_forwards": seg.forwards - forwards0}
        hp.force_path = None
        assert hp.disabled is None, hp.disabled
        # PROFILE_TRACE_FORWARDS fused forwards, still armed, under a device
        # trace: one `fused` ledger each, K2 named in the exported trace
        sample = Table({"features": tokens[:PROFILE_CLIENTS].astype(np.float64)})
        fm.transform(sample)                                # the rung's graph, before the trace
        forwards0, k2_0 = seg.forwards, _k2_wgmma()
        with device_trace(str(tmp / "trace")):
            with annotate("slice_streaming.fused_forwards"):
                for _ in range(PROFILE_TRACE_FORWARDS):
                    fm.transform(sample)
                torch.cuda.current_stream().synchronize()
        k2_trace = _k2_wgmma() - k2_0
        assert seg.forwards - forwards0 == PROFILE_TRACE_FORWARDS, seg.forwards - forwards0
        assert k2_trace == layers * PROFILE_TRACE_FORWARDS, k2_trace
        trace = _wgmma_in_trace(device_trace.last_path)
        trace["bytes"] = os.path.getsize(device_trace.last_path)
        # every launch of the server's life, warm-up captures included
        k2_all = _k2_wgmma() - k2_start
        assert k2_all == layers * seg.forwards, (k2_all, seg.forwards)
    finally:
        if armed_here:
            set_default_profiler(prev)
        srv.stop()
    rows = prof.attribution()
    resident = [r for r in rows if r["kind"] == "request" and r["segment"] == hp.resident_label]
    assert len(resident) == 1, [(r["kind"], r["segment"]) for r in rows]
    res = resident[0]
    lo, hi = PROFILE_COVERAGE
    assert res["coverage"] is not None and lo <= res["coverage"] <= hi, res["coverage"]
    assert res["phase_us"].get("compute", 0.0) > 0.0, res["phase_us"]
    fused = [r for r in rows if r["kind"] == "fused"]
    assert fused and all(r["phase_us"].get("compute", 0.0) > 0.0 for r in fused), fused
    table = render_attribution([r for r in rows if r["kind"] in ("request", "fused")],
                               title="slice_streaming phase attribution")
    return {"requests_a_run": PROFILE_REQUESTS, "clients": PROFILE_CLIENTS, "runs": runs,
            "armed_over_disarmed_p50": runs["armed"]["client_p50_ms"]
            / runs["disarmed"]["client_p50_ms"],
            "resident": {k: res[k] for k in ("count", "phase_us", "phase_sum_us", "rtt_us",
                                             "coverage", "pad_waste", "gflops")},
            "fused": [{k: r[k] for k in ("segment", "count", "phase_us", "phase_sum_us",
                                         "rtt_us", "coverage")} for r in fused],
            "cost_analysis": [r["gflops"] for r in rows],
            "attribution_table": table, "trace": trace, "fused_forwards": seg.forwards,
            "flash_launches": k2_all}


def phase_slice_streaming(card: str, bundle, adult_model) -> dict:
    """The phase profiler and streaming on the card ((a)-(e) above);
    `card` (phase_env's nvidia-smi name and power limit) stands beside
    every time and rate. Fits nothing: K1 is not launched."""
    import tempfile

    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
    from mmlspark_tpu_torch.nn.attention import flash_attention

    t0 = time.perf_counter()
    histogram.launches = 0
    flash_attention.launches = 0
    flash_attention.launches_by_path = {}
    marks = {}
    doc = {"phase": "slice_streaming", "card": card}
    with tempfile.TemporaryDirectory(prefix="slice_streaming_") as tmp:
        tmp = Path(tmp)
        doc["serving"] = streaming_serving(bundle, tmp)
        marks["serving"] = time.perf_counter() - t0
        chunks, doc["adult"] = streaming_adult(adult_model, tmp)
        marks["adult"] = time.perf_counter() - t0
        doc["parallel"] = streaming_parallel(adult_model, chunks)
        marks["parallel"] = time.perf_counter() - t0
        expected = doc["parallel"]["grouped"].pop("result")
        doc["parallel"]["windowed"].pop("result")
        doc["fleet"] = streaming_fleet(adult_model, chunks, expected, tmp)
        marks["fleet"] = time.perf_counter() - t0
        doc["profiler"] = streaming_profiler(bundle, tmp)
        marks["profiler"] = time.perf_counter() - t0
    launches = dict(flash_attention.launches_by_path)
    k2 = doc["serving"]["flash_launches_total"] + doc["profiler"]["flash_launches"]
    assert launches == {"wgmma": k2} and flash_attention.launches == k2, (launches, k2)
    assert histogram.launches == 0, f"slice_streaming launched K1 {histogram.launches} times"
    doc["flash_launches"] = k2
    doc["seconds_at"] = marks
    doc["seconds"] = time.perf_counter() - t0
    table = doc["profiler"].pop("attribution_table")
    emit(doc)
    s, a, f, p = doc["serving"], doc["adult"], doc["fleet"], doc["profiler"]
    print(f"slice_streaming on {card}: tokens {s['requests_per_s']:.1f} requests/s in "
          f"{s['micro_batches']} micro-batches, restart re-parked {s['restart']['reparked']}; "
          f"Adult {a['rows_per_s']:.0f} rows/s over {a['files']} files; P={STREAM_PARTITIONS} "
          f"threads {doc['parallel']['grouped']['p_rows_per_s']:.0f} rows/s vs P=1 "
          f"{doc['parallel']['grouped']['p1_rows_per_s']:.0f}; fleet respawn "
          f"{f['respawn_s']:.2f} s; resident coverage {p['resident']['coverage']:.3f}, armed/"
          f"disarmed p50 {p['armed_over_disarmed_p50']:.3f}; trace wgmma kernels "
          f"{p['trace']['wgmma_kernels']} ({p['trace']['wgmma_inside_range']} inside the range)",
          flush=True)
    print(table, flush=True)
    return doc


# slice_parallel: the P4 layers on slice_mesh's 4 gloo ranks sharing the card
P4_ATTN = dict(b=1, t=8192, h=8, d=64, chunk=512)
P4_TP = dict(rows=4096, d=1024, hidden=4096)
P4_PIPE = dict(stages=4, d=1024, batch=256, n_micro=8)
P4_MOE = dict(experts=8, tokens=4096, d=512, h=2048, cf=1.25)
P4_SERVE_ROWS, P4_SERVE_BATCH = 256, 64
P4_ATTN_TOL, P4_TP_TOL, P4_PIPE_TOL, P4_MOE_TOL = (2e-4, 2e-5), (2e-4, 2e-4), (2e-5, 1e-6), \
    (1e-4, 1e-5)


def p4_inputs(name: str) -> dict:
    """A layer's inputs, seeded numpy: the same arrays in every process."""
    if name == "attention":
        rng = np.random.default_rng(31)
        shape = (P4_ATTN["b"], P4_ATTN["t"], P4_ATTN["h"], P4_ATTN["d"])
        return {k: rng.normal(size=shape).astype(np.float32) for k in ("q", "k", "v")}
    if name == "tp":
        rng = np.random.default_rng(32)
        n, d, h = P4_TP["rows"], P4_TP["d"], P4_TP["hidden"]
        return {"x": rng.normal(size=(n, d)).astype(np.float32),
                "w1": (rng.normal(size=(d, h)) / np.sqrt(d)).astype(np.float32),
                "b1": (0.1 * rng.normal(size=h)).astype(np.float32),
                "w2": (rng.normal(size=(h, d)) / np.sqrt(h)).astype(np.float32),
                "b2": (0.1 * rng.normal(size=d)).astype(np.float32)}
    if name == "pipe":
        rng = np.random.default_rng(33)
        s, d = P4_PIPE["stages"], P4_PIPE["d"]
        return {"ws": (rng.normal(size=(s, d, d)) / np.sqrt(d)).astype(np.float32),
                "bs": (0.1 * rng.normal(size=(s, d))).astype(np.float32),
                "x": rng.normal(size=(P4_PIPE["batch"], d)).astype(np.float32)}
    if name == "moe":
        rng = np.random.default_rng(34)
        e, d, h = P4_MOE["experts"], P4_MOE["d"], P4_MOE["h"]
        return {"w_gate": (rng.normal(size=(d, e)) * np.sqrt(2.0 / d)).astype(np.float32),
                "w1": (rng.normal(size=(e, d, h)) * np.sqrt(2.0 / d)).astype(np.float32),
                "b1": np.zeros((e, h), np.float32),
                "w2": (rng.normal(size=(e, h, d)) * np.sqrt(2.0 / h)).astype(np.float32),
                "b2": np.zeros((e, d), np.float32),
                "x": rng.normal(size=(P4_MOE["tokens"], d)).astype(np.float32)}
    rng = np.random.default_rng(35)
    return {"tokens": rng.integers(0, SLICE_TRANSFORMER["vocab_size"],
                                   size=(P4_SERVE_ROWS, SLICE_TOKENS)).astype(np.int32)}


def _p4_stage(params, x):
    w, b = params
    return x + torch.tanh(x @ w + b)


def _p4_digest(a: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(a).tobytes(), digest_size=16).hexdigest()


def p4_rank_job(bundle_path: str) -> dict:
    """Run on every rank of slice_mesh's pool (4 gloo ranks on the card):
    each P4 layer on this rank's block, once to warm up and once timed
    (CUDA-synchronized host seconds, and the bytes its collectives moved).
    Returns this rank's output blocks (the replicated outputs as shard 0's
    array and every rank's digest) and its K2 launches serving."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle
    from mmlspark_tpu_torch.nn.attention import flash_attention
    from mmlspark_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, collectives,
                                             make_mesh, make_pipe_mesh, make_ring_attention,
                                             make_tp_mlp, make_ulysses_attention,
                                             pipeline_forward, use_mesh)
    from mmlspark_tpu_torch.parallel.moe import MoEParams, moe_ffn_sharded

    dev = torch.device("cuda")
    rank, n = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "layers": {}, "blocks": {}, "digests": {}}

    def timed(name, fn):
        fn()
        torch.cuda.synchronize()
        collectives.reset_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        st = collectives.stats()
        out["layers"][name] = {"ms": (time.perf_counter() - t0) * 1e3, "bytes": st["bytes"],
                               "collective_calls": st["calls"],
                               "collective_ms": st["seconds"] * 1e3}
        return res

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    # ring and Ulysses attention: this rank's block of the sequence
    seq_mesh = make_mesh(n_data=1, n_seq=n, device="cuda")
    i = seq_mesh.axis(SEQ_AXIS).shard_index
    att = p4_inputs("attention")
    tl = P4_ATTN["t"] // n
    q, k, v = (on(att[key][:, i * tl:(i + 1) * tl]) for key in ("q", "k", "v"))
    for impl, make in (("ring", make_ring_attention), ("ulysses", make_ulysses_attention)):
        for causal in (False, True):
            name = f"{impl}{'_causal' if causal else ''}"
            fn = make(seq_mesh, SEQ_AXIS, causal=causal, local_chunk=P4_ATTN["chunk"])
            out["blocks"][name] = (i, timed(name, lambda: fn(q, k, v)).cpu().numpy())
    del q, k, v

    # the tensor-parallel MLP over the model axis
    tp_mesh = make_mesh(n_data=1, n_model=n, device="cuda")
    tp = {key: on(a) for key, a in p4_inputs("tp").items()}
    mlp = make_tp_mlp(tp_mesh, MODEL_AXIS)
    y = timed("tp_mlp", lambda: mlp(tp["x"], tp["w1"], tp["b1"], tp["w2"], tp["b2"])).cpu().numpy()
    out["digests"]["tp_mlp"] = _p4_digest(y)
    if rank == 0:
        out["blocks"]["tp_mlp"] = (0, y)
    del tp

    # the GPipe pipeline: stage `rank`
    pipe_mesh = make_pipe_mesh(n, device="cuda")
    pipe = p4_inputs("pipe")
    params = (on(pipe["ws"]), on(pipe["bs"]))
    y = timed("pipeline", lambda: pipeline_forward(_p4_stage, params, on(pipe["x"]),
                                                   P4_PIPE["n_micro"], pipe_mesh)).cpu().numpy()
    out["digests"]["pipeline"] = _p4_digest(y)
    if rank == 0:
        out["blocks"]["pipeline"] = (0, y)

    # MoE: this rank's tokens and its E / n experts
    ep_mesh = make_mesh(n_data=n, device="cuda")
    s = ep_mesh.shard_index
    moe = p4_inputs("moe")
    el, tl = P4_MOE["experts"] // n, P4_MOE["tokens"] // n
    local = MoEParams(w_gate=on(moe["w_gate"]),
                      **{key: on(moe[key][s * el:(s + 1) * el]) for key in ("w1", "b1", "w2", "b2")})
    xb = on(moe["x"][s * tl:(s + 1) * tl])
    out["blocks"]["moe"] = (s, timed("moe", lambda: moe_ffn_sharded(
        local, xb, ep_mesh, capacity_factor=P4_MOE["cf"])).cpu().numpy())
    del local, xb

    # DeepModelTransformer(use_mesh=True) on the data axis: K2 in every rank
    bundle = ModelBundle.load(bundle_path)
    tokens = p4_inputs("serve")["tokens"]
    data_mesh = make_mesh(n_data=n, device="cuda")
    stage = DeepModelTransformer(input_col="tokens", mini_batch_size=P4_SERVE_BATCH,
                                 use_mesh=True, device="cuda",
                                 fetch_dict={"logits": "logits"}).set_model(bundle)
    with use_mesh(data_mesh):
        stage.transform(Table({"tokens": tokens[:P4_SERVE_BATCH]}))     # weights to the card
        torch.cuda.synchronize()
        flash_attention.launches, flash_attention.launches_by_path = 0, {}
        collectives.reset_stats()
        t0 = time.perf_counter()
        logits = np.asarray(stage.transform(Table({"tokens": tokens}))["logits"])
        torch.cuda.synchronize()
    st = collectives.stats()
    out["layers"]["use_mesh_serving"] = {"ms": (time.perf_counter() - t0) * 1e3,
                                         "bytes": st["bytes"], "collective_calls": st["calls"],
                                         "collective_ms": st["seconds"] * 1e3}
    out["k2_launches"] = flash_attention.launches
    out["k2_by_path"] = dict(flash_attention.launches_by_path)
    out["axis"] = {"seq": seq_mesh.axis(SEQ_AXIS).size, "model": tp_mesh.axis(MODEL_AXIS).size,
                   "data": data_mesh.axis(DATA_AXIS).size}
    out["digests"]["serving"] = _p4_digest(logits)
    if rank == 0:
        out["blocks"]["serving"] = (0, logits)
    return out


def _p4_check(name: str, got: np.ndarray, want: np.ndarray, tol: tuple) -> float:
    rtol, atol = tol
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.allclose(got, want, rtol=rtol, atol=atol), \
        f"slice_parallel {name}: max |err| {err} outside rtol {rtol}, atol {atol}"
    return err


def _cuda_ms(fn) -> tuple:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def phase_slice_parallel(pool, card: str, bundle=None) -> dict:
    """The P4 layers on slice_mesh's pool of 4 gloo ranks sharing the card
    (no rank spawned again), each held against its one-rank counterpart
    on the card in this process: ring and Ulysses attention on a seq
    axis of 4 (B 1, T 8,192, H 8, D 64, f32, causal and not, local_chunk
    512) against `chunked_attention`; the tensor-parallel MLP on a model
    axis of 4 (x 4,096 x 1,024, hidden 4,096) against the local MLP; the
    GPipe pipeline (4 stages of d 1,024, batch 256, 8 microbatches)
    against the stages applied in turn; MoE (8 experts on an expert axis
    of 4, 4,096 tokens, d 512, h 2,048, capacity factor 1.25) against
    `moe_ffn_local` of each rank's tokens (the same capacity a shard);
    and DeepModelTransformer(use_mesh=True) serving the slice transformer
    (bf16, flash) on a data axis of 4, 256 rows of 512 tokens, against
    the single-process transform at the ranks' minibatch, within 1e-4;
    every rank launches K2 (on wgmma) for its block of every minibatch.
    Each layer's ms and the bytes its collectives moved; the pool is
    closed at the end."""
    from mmlspark_tpu_torch.core import Table
    from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle
    from mmlspark_tpu_torch.nn.attention import chunked_attention, flash_attention
    from mmlspark_tpu_torch.parallel.moe import MoEParams, moe_ffn_local

    t_start = time.perf_counter()
    workdir = ROOT / "build" / "chip_smoke_mesh"
    try:
        if bundle is None:
            bundle = ModelBundle.init("transformer", (SLICE_TOKENS,), seed=0,
                                      attention_impl="flash", dtype="bfloat16",
                                      **SLICE_TRANSFORMER)
        workdir.mkdir(parents=True, exist_ok=True)
        path = workdir / "slice_transformer.bundle"
        bundle.save(str(path))
        ranks = pool.run(p4_rank_job, str(path), deadline_s=300)
    finally:
        pool.close()
        shutil.rmtree(workdir, ignore_errors=True)
    n = len(ranks)
    doc = {"phase": "slice_parallel", "card": card, "ranks": n, "backend": "gloo",
           "layers": {}, "one_rank_ms": {}}

    def blocks(name):
        got = sorted((r["blocks"][name] for r in ranks if name in r["blocks"]),
                     key=lambda ib: ib[0])
        return [b for _, b in got]

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device="cuda")

    errs = {}
    att = {key: on(a) for key, a in p4_inputs("attention").items()}
    for causal in (False, True):
        want, ms = _cuda_ms(lambda: chunked_attention(
            att["q"], att["k"], att["v"], causal=causal, q_chunk=P4_ATTN["chunk"],
            k_chunk=P4_ATTN["chunk"]))
        want = want.cpu().numpy()
        doc["one_rank_ms"][f"chunked{'_causal' if causal else ''}"] = ms
        for impl in ("ring", "ulysses"):
            name = f"{impl}{'_causal' if causal else ''}"
            errs[name] = _p4_check(name, np.concatenate(blocks(name), axis=1), want,
                                   P4_ATTN_TOL)
    del att

    tp = {key: on(a) for key, a in p4_inputs("tp").items()}
    want, doc["one_rank_ms"]["tp_mlp"] = _cuda_ms(lambda: torch.nn.functional.gelu(
        tp["x"] @ tp["w1"] + tp["b1"], approximate="tanh") @ tp["w2"] + tp["b2"])
    errs["tp_mlp"] = _p4_check("tp_mlp", blocks("tp_mlp")[0], want.cpu().numpy(), P4_TP_TOL)
    del tp, want

    pipe = p4_inputs("pipe")
    ws, bs_, x = on(pipe["ws"]), on(pipe["bs"]), on(pipe["x"])
    mb = P4_PIPE["batch"] // P4_PIPE["n_micro"]

    def sequential():
        outs = []
        for m in range(P4_PIPE["n_micro"]):
            h = x[m * mb:(m + 1) * mb]
            for st in range(P4_PIPE["stages"]):
                h = _p4_stage((ws[st], bs_[st]), h)
            outs.append(h)
        return torch.cat(outs)

    want, doc["one_rank_ms"]["pipeline"] = _cuda_ms(sequential)
    errs["pipeline"] = _p4_check("pipeline", blocks("pipeline")[0], want.cpu().numpy(),
                                 P4_PIPE_TOL)

    moe = p4_inputs("moe")
    params = MoEParams(**{key: on(moe[key]) for key in MoEParams._fields})
    xs = on(moe["x"]).chunk(n)
    want, doc["one_rank_ms"]["moe"] = _cuda_ms(lambda: torch.cat(
        [moe_ffn_local(params, xb, capacity_factor=P4_MOE["cf"]) for xb in xs]))
    want = want.cpu().numpy()
    errs["moe"] = _p4_check("moe", np.concatenate(blocks("moe")), want, P4_MOE_TOL)
    cap = int(P4_MOE["cf"] * (P4_MOE["tokens"] // n) / P4_MOE["experts"])
    dropped = int(np.all(want == 0.0, axis=1).sum())
    del params, xs

    tokens = p4_inputs("serve")["tokens"]
    per_rank = P4_SERVE_BATCH // n
    single = DeepModelTransformer(input_col="tokens", mini_batch_size=per_rank, device="cuda",
                                  fetch_dict={"logits": "logits"}).set_model(bundle)
    single.transform(Table({"tokens": tokens[:per_rank]}))
    torch.cuda.synchronize()
    flash_attention.launches, flash_attention.launches_by_path = 0, {}
    t0 = time.perf_counter()
    want = np.asarray(single.transform(Table({"tokens": tokens}))["logits"])
    doc["one_rank_ms"]["serving"] = (time.perf_counter() - t0) * 1e3
    errs["serving"] = _p4_check("serving", blocks("serving")[0], want, (0.0, 1e-4))
    assert np.isfinite(want).all()

    for name in ("tp_mlp", "pipeline", "serving"):
        digests = {r["digests"][name] for r in ranks}
        assert len(digests) == 1, f"slice_parallel {name}: the ranks hold different outputs"
    want_k2 = SLICE_TRANSFORMER["num_layers"] * (P4_SERVE_ROWS // P4_SERVE_BATCH)
    for r in ranks:
        assert r["k2_launches"] == want_k2 and r["k2_by_path"] == {"wgmma": want_k2}, \
            f"rank {r['rank']}: K2 {r['k2_by_path']} serving, want {want_k2} on wgmma"
        assert r["axis"] == {"seq": n, "model": n, "data": n}, r["axis"]
    for name in ranks[0]["layers"]:
        doc["layers"][name] = {
            "ms_slowest_rank": max(r["layers"][name]["ms"] for r in ranks),
            "bytes_a_rank": [r["layers"][name]["bytes"] for r in ranks],
            "collective_calls": ranks[0]["layers"][name]["collective_calls"],
            "collective_ms_rank0": ranks[0]["layers"][name]["collective_ms"],
            "max_abs_err": errs[name if name != "use_mesh_serving" else "serving"]}
    doc["tolerances"] = {"attention": P4_ATTN_TOL, "tp_mlp": P4_TP_TOL,
                         "pipeline": P4_PIPE_TOL, "moe": P4_MOE_TOL, "serving": (0.0, 1e-4)}
    doc["moe"] = {"capacity_a_shard": cap, "dropped_tokens": dropped}
    doc["k2_launches_by_rank"] = [r["k2_launches"] for r in ranks]
    doc["seconds"] = time.perf_counter() - t_start
    emit(doc)
    print(f"slice_parallel on {card}: " + ", ".join(
        f"{name} {d['ms_slowest_rank']:.1f} ms / {sum(d['bytes_a_rank']) / 2**20:.1f} MiB"
        for name, d in doc["layers"].items()), flush=True)
    return {**doc, "bundle": bundle,
            "flash_launches_by_rank": {f"mesh_serving_rank{r['rank']}": r["k2_launches"]
                                       for r in ranks}}


# slice_fusion_mesh: fused pipelines under a mesh of several ranks, on
# slice_mesh's pool of 4 gloo ranks sharing the card
FMESH_ROWS, FMESH_CHUNK = 1 << 20, 65536                  # (a) slice_serving's scoring rows
FMESH_TOKEN_ROWS, FMESH_TOKEN_BATCH = 256, 64             # (b) bench.py's serving transformer
FMESH_TP = dict(inputs=1024, features=(4096, 4096), outputs=8, rows=4096, batch=1024)   # (c)
FMESH_REQUESTS, FMESH_CLIENTS, FMESH_MAX_BATCH = 128, 16, 16                            # (d)
FMESH_STREAM_BATCHES, FMESH_STREAM_ROWS = 8, 8192                                       # (e)
FMESH_TP_TOL, FMESH_DP_TOL = 2e-4, 1e-4


def _fmesh_inputs(part: str):
    """A part's inputs, seeded numpy: the same arrays in every process."""
    if part == "gbdt":
        return make_dataset(FMESH_ROWS, SERVE_FEATURES, seed=29)[0].astype(np.float32)
    if part == "tokens":
        return p4_inputs("serve")["tokens"].astype(np.float64)
    if part == "requests":
        rng = np.random.default_rng(41)
        return rng.integers(0, SLICE_TRANSFORMER["vocab_size"],
                            size=(FMESH_REQUESTS, SLICE_TOKENS)).astype(np.float64)
    rng = np.random.default_rng(43)
    return rng.normal(size=(FMESH_TP["rows"], FMESH_TP["inputs"])).astype(np.float32)


def _fmesh_token_bodies() -> list:
    return [json.dumps({c: int(v) for c, v in zip(STREAM_TOKEN_COLS, row)}).encode()
            for row in _fmesh_inputs("requests")]


def fusion_mesh_rank_job(regressor_path: str, bundle_path: str, mlp_path: str) -> dict:
    """Run on every rank of slice_mesh's pool: parts (a)-(e) of
    slice_fusion_mesh, each on this rank. Returns per part this rank's
    digest of its output (shard 0 also the arrays this process compares), its
    ms and the bytes its collectives moved, the segment's stats, and the
    K2 launches (by path) and fused forwards of the transformer parts."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.core import Table, fuse, pipeline_model
    from mmlspark_tpu_torch.gbdt.estimators import GBDTRegressionModel
    from mmlspark_tpu_torch.io_http.schema import HTTPRequestData
    from mmlspark_tpu_torch.io_http.serving import serve_model
    from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle
    from mmlspark_tpu_torch.nn.attention import flash_attention
    from mmlspark_tpu_torch.parallel import collectives, make_mesh
    from mmlspark_tpu_torch.streaming.query import StreamingQuery
    from mmlspark_tpu_torch.streaming.sources import MemorySource

    rank, n = dist.get_rank(), dist.get_world_size()
    data = make_mesh(n_data=n, device="cuda")
    grid = make_mesh(n_data=2, n_model=2, device="cuda")
    out = {"rank": rank, "shard": data.shard_index, "parts": {}}

    def timed(part, fn):
        torch.cuda.synchronize()
        collectives.reset_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        st = collectives.stats()
        out["parts"].setdefault(part, {}).update(
            ms=(time.perf_counter() - t0) * 1e3, bytes=st["bytes"], collective_calls=st["calls"])
        return res

    def seg_doc(fm) -> dict:
        st = fm.last_stats["segments"][0]
        return {k: st.get(k) for k in ("mesh_shape", "param_placements", "shard_skew_ratio",
                                        "eager", "graph_captures", "graph_replays", "misses",
                                        "recompiles", "rows_real", "rows_padded")}

    # (a) the Adult regressor's fused traversal, 1,048,576 rows, data mesh of 4
    model = GBDTRegressionModel.load_native_model(regressor_path, device="cuda")
    x = _fmesh_inputs("gbdt")
    fm = fuse(pipeline_model(model), mesh=data, mini_batch_size=FMESH_CHUNK, device="cuda")
    fm.transform(Table({"features": x}))
    seg = fm._ensure_segments()[0]
    warm, captures = seg._exec_cache.stats(), seg.captures
    pred = np.asarray(timed("a_gbdt", lambda: fm.transform(Table({"features": x})))["prediction"])
    again = seg._exec_cache.stats()
    out["parts"]["a_gbdt"].update(
        digest=_p4_digest(pred), rows=len(pred), segment=seg_doc(fm),
        second_run={"captures": seg.captures - captures,
                    "misses": again["misses"] - warm["misses"],
                    "recompiles": again["recompiles"] - warm["recompiles"]})

    # (b) the serving transformer fused on the data mesh, 256 x 512 tokens
    bundle = ModelBundle.load(bundle_path)
    runner = DeepModelTransformer(input_col="features", bfloat16=False, device="cuda",
                                  fetch_dict={"probability": "probability"}).set_model(bundle)
    fm_t = fuse(pipeline_model(runner), mesh=data, mini_batch_size=FMESH_TOKEN_BATCH,
                device="cuda")
    tokens = _fmesh_inputs("tokens")
    seg_t = fm_t._ensure_segments()[0]
    k2 = {}
    forwards0 = seg_t.forwards
    flash_attention.launches, flash_attention.launches_by_path = 0, {}
    fm_t.transform(Table({"features": tokens}))
    prob = np.asarray(timed("b_transformer",
                            lambda: fm_t.transform(Table({"features": tokens})))["probability"])
    k2["b_transformer"] = (dict(flash_attention.launches_by_path), seg_t.forwards - forwards0)
    out["parts"]["b_transformer"].update(digest=_p4_digest(prob), segment=seg_doc(fm_t))
    if data.shard_index == 0:
        out["parts"]["b_transformer"]["probability"] = prob

    # (c) the tensor-parallel MLP on a 2 x 2 data x model mesh
    mlp = DeepModelTransformer(input_col="x", device="cuda", mini_batch_size=FMESH_TP["batch"],
                               fetch_dict={"logits": "logits"}).set_model(
        ModelBundle.load(mlp_path))
    fm_c = fuse(pipeline_model(mlp), mesh=grid, mini_batch_size=FMESH_TP["batch"], device="cuda")
    xc = _fmesh_inputs("tp")
    fm_c.transform(Table({"x": xc}))
    logits = np.asarray(timed("c_tensor_parallel",
                              lambda: fm_c.transform(Table({"x": xc})))["logits"])
    out["parts"]["c_tensor_parallel"].update(digest=_p4_digest(logits), segment=seg_doc(fm_c),
                                             describe=fm_c.describe())
    if data.shard_index == 0:
        out["parts"]["c_tensor_parallel"]["logits"] = logits

    # (d) serve_model of (b)'s fused transformer: shard 0 serves, the others follow
    warm_req = HTTPRequestData.from_json("/", json.loads(_fmesh_token_bodies()[0]))
    forwards0 = seg_t.forwards
    flash_attention.launches, flash_attention.launches_by_path = 0, {}

    def serve():
        srv = serve_model(fm_t, STREAM_TOKEN_COLS, output_col="probability", mesh=data,
                          device="cuda", max_batch_size=FMESH_MAX_BATCH,
                          warmup_request=warm_req)
        if isinstance(srv, dict):
            return {"followed": srv}
        try:
            _wait_ready(srv)
            hp = srv.hot_path
            assert hp is not None and hp.disabled is None, hp and hp.disabled
            run = _drive(srv, _fmesh_token_bodies(), FMESH_CLIENTS)
            return {"replies": np.stack([np.asarray(json.loads(e)["probability"], np.float64)
                                         for e in run["replies"]]),
                    "ladder": list(srv.bucketer.ladder), "resident_batches": hp.resident_batches,
                    "paths": dict(hp.path_requests), "client_p50_ms": run["client_p50_ms"],
                    "client_p99_ms": run["client_p99_ms"], "seconds": run["seconds"]}
        finally:
            srv.stop()

    out["parts"]["d_serving"] = {}
    out["parts"]["d_serving"].update(timed("d_serving", serve))
    torch.cuda.synchronize()
    # serve_model re-attached the mesh: the segment may be a fresh one
    seg_d = fm_t._ensure_segments()[0]
    k2["d_serving"] = (dict(flash_attention.launches_by_path),
                       seg_d.forwards - (forwards0 if seg_d is seg_t else 0))

    # (e) a StreamingQuery of (a)'s model over 8 micro-batches of 8,192 rows
    def stream():
        source = MemorySource()
        q = StreamingQuery(source=source, transform=pipeline_model(model), mesh=data,
                           device="cuda", source_lookahead=0)
        if q.following:
            runs = q.process_all_available()
            q.stop()
            return {"followed_runs": runs}
        for b in range(FMESH_STREAM_BATCHES):
            source.add_rows(Table({"features": x[b * FMESH_STREAM_ROWS:
                                                 (b + 1) * FMESH_STREAM_ROWS]}))
            q.process_all_available()
        sink = np.asarray(q.sink.table()["prediction"])
        batches = q.batches_processed
        q.stop()
        return {"digest": _p4_digest(sink), "rows": len(sink), "batches": batches}

    out["parts"]["e_streaming"] = {}
    out["parts"]["e_streaming"].update(timed("e_streaming", stream))
    out["k2"] = k2
    return out


def phase_slice_fusion_mesh(pool, card: str, regressor) -> dict:
    """Fused pipelines under a mesh of several ranks, on slice_mesh's pool
    of 4 gloo ranks sharing the card (no rank spawned again), each part
    held against the same model's one-process fused transform on the card
    in this process: (a) the Adult regressor (slice_serving's, fitted on
    the Adult shape; a classification model is not fusable in either
    package: its probabilities are float64 on the host) as a fused
    pipeline on a data mesh of 4 over slice_serving's 1,048,576 f32
    scoring rows in chunks of 65,536 (16,384 a rank): every rank's output
    byte-equal to the one-process transform, mesh shape "4x1", no capture,
    miss or recompile on the second transform; (b) the serving transformer
    (8 layers, d_model 512, bf16 bundle, flash) fused on the data mesh,
    256 rows x 512 tokens at minibatch 64: within 1e-4 of the one-process
    transform at the ranks' block size, K2 exactly 8 x each rank's fused
    forwards, all on "wgmma"; (c) an f32 "mlp" bundle at slice_parallel's
    TP width (input 1,024, features 4,096 and 4,096, 8 outputs) fused on a
    2 x 2 data x model mesh, 4,096 rows at minibatch 1,024: within 2e-4,
    placements ["custom"], eager; (d) serve_model of (b)'s fused
    transformer with the mesh: shard 0 serves 128 requests of 512 seeded
    ids from 16 keep-alive clients, every reply within 1e-4 of the
    one-process transform, every rung divisible by 4, the followers stop;
    (e) a StreamingQuery of (a)'s model over 8 micro-batches of 8,192 of
    (a)'s rows on the mesh: the sink byte-equal to the one-rank query's.
    Per part: ms at the slowest rank, the bytes the ranks' collectives
    moved, shard_skew_ratio. Returns the transformer bundle for
    slice_parallel, which closes the pool."""
    from mmlspark_tpu_torch.core import Table, fuse, pipeline_model
    from mmlspark_tpu_torch.nn import DeepModelTransformer, ModelBundle
    from mmlspark_tpu_torch.streaming.query import StreamingQuery
    from mmlspark_tpu_torch.streaming.sources import MemorySource

    t_start = time.perf_counter()
    workdir = ROOT / "build" / "chip_smoke_fusion_mesh"
    workdir.mkdir(parents=True, exist_ok=True)
    try:
        bundle = ModelBundle.init("transformer", (SLICE_TOKENS,), seed=0, attention_impl="flash",
                                  dtype="bfloat16", **SLICE_TRANSFORMER)
        mlp = ModelBundle.init("mlp", (FMESH_TP["inputs"],), seed=0,
                               num_outputs=FMESH_TP["outputs"], features=FMESH_TP["features"])
        paths = {"regressor": workdir / "regressor.model", "bundle": workdir / "transformer.bundle",
                 "mlp": workdir / "mlp.bundle"}
        regressor.save_native_model(str(paths["regressor"]))
        bundle.save(str(paths["bundle"]))
        mlp.save(str(paths["mlp"]))
        ranks = pool.run(fusion_mesh_rank_job, str(paths["regressor"]), str(paths["bundle"]),
                         str(paths["mlp"]), deadline_s=300)
    except BaseException:
        pool.close(kill=True)
        raise
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    ranks = sorted(ranks, key=lambda r: r["shard"])
    n = len(ranks)
    lead = ranks[0]["parts"]
    doc = {"phase": "slice_fusion_mesh", "card": card, "ranks": n, "backend": "gloo",
           "parts": {}}
    layers = SLICE_TRANSFORMER["num_layers"]

    # the one-process references, fused on the card in this process
    x = _fmesh_inputs("gbdt")
    one = fuse(pipeline_model(regressor), mini_batch_size=FMESH_CHUNK, device="cuda")
    one.transform(Table({"features": x}))
    t0 = time.perf_counter()
    want_a = np.asarray(one.transform(Table({"features": x}))["prediction"])
    one_ms = {"a_gbdt": (time.perf_counter() - t0) * 1e3}
    runner = DeepModelTransformer(input_col="features", bfloat16=False, device="cuda",
                                  fetch_dict={"probability": "probability"}).set_model(bundle)
    one_t = fuse(pipeline_model(runner), mini_batch_size=FMESH_TOKEN_BATCH // n, device="cuda")
    tokens = _fmesh_inputs("tokens")
    one_t.transform(Table({"features": tokens}))
    t0 = time.perf_counter()
    want_b = np.asarray(one_t.transform(Table({"features": tokens}))["probability"])
    one_ms["b_transformer"] = (time.perf_counter() - t0) * 1e3
    want_d = np.asarray(one_t.transform(Table({"features": _fmesh_inputs("requests")}))
                        ["probability"])
    mlp_stage = DeepModelTransformer(input_col="x", device="cuda", fetch_dict={"logits": "logits"},
                                     mini_batch_size=FMESH_TP["batch"]).set_model(mlp)
    one_c = fuse(pipeline_model(mlp_stage), mini_batch_size=FMESH_TP["batch"], device="cuda")
    xc = _fmesh_inputs("tp")
    one_c.transform(Table({"x": xc}))
    t0 = time.perf_counter()
    want_c = np.asarray(one_c.transform(Table({"x": xc}))["logits"])
    one_ms["c_tensor_parallel"] = (time.perf_counter() - t0) * 1e3
    source = MemorySource()
    q = StreamingQuery(source=source, transform=pipeline_model(regressor), device="cuda",
                       source_lookahead=0)
    for b in range(FMESH_STREAM_BATCHES):
        source.add_rows(Table({"features": x[b * FMESH_STREAM_ROWS:(b + 1) * FMESH_STREAM_ROWS]}))
        q.process_all_available()
    want_e = _p4_digest(np.asarray(q.sink.table()["prediction"]))
    q.stop()

    def same_digest(part):
        digests = {r["parts"][part]["digest"] for r in ranks}
        assert len(digests) == 1, f"slice_fusion_mesh {part}: the ranks hold different outputs"
        return digests.pop()

    assert same_digest("a_gbdt") == _p4_digest(want_a), \
        "slice_fusion_mesh (a): the mesh's predictions differ from the one-process transform"
    for r in ranks:
        a = r["parts"]["a_gbdt"]
        assert a["rows"] == FMESH_ROWS and a["segment"]["mesh_shape"] == f"{n}x1", a
        assert a["second_run"] == {"captures": 0, "misses": 0, "recompiles": 0}, a["second_run"]
    same_digest("b_transformer")
    err_b = float(np.abs(lead["b_transformer"]["probability"] - want_b).max())
    assert err_b <= FMESH_DP_TOL, f"slice_fusion_mesh (b): max |err| {err_b}"
    same_digest("c_tensor_parallel")
    err_c = _p4_check("fusion_mesh_tp", lead["c_tensor_parallel"]["logits"], want_c,
                      (FMESH_TP_TOL, FMESH_TP_TOL))
    for r in ranks:
        c = r["parts"]["c_tensor_parallel"]["segment"]
        assert c["mesh_shape"] == "2x2" and c["param_placements"] == ["custom"] and c["eager"], c
    d = lead["d_serving"]
    err_d = float(np.abs(d["replies"] - want_d).max())
    assert d["replies"].shape == want_d.shape and err_d <= FMESH_DP_TOL, \
        f"slice_fusion_mesh (d): max |err| {err_d}"
    assert all(rung % n == 0 for rung in d["ladder"]), d["ladder"]
    for r in ranks[1:]:
        followed = r["parts"]["d_serving"]["followed"]
        assert followed["dispatches"] == followed["fetches"], followed
    e = lead["e_streaming"]
    assert e["batches"] == FMESH_STREAM_BATCHES and e["digest"] == want_e, \
        "slice_fusion_mesh (e): the mesh query's sink differs from the one-rank query's"
    for r in ranks[1:]:
        assert r["parts"]["e_streaming"]["followed_runs"] == FMESH_STREAM_BATCHES, r["parts"]
    for r in ranks:
        for part, (by_path, forwards) in r["k2"].items():
            assert forwards > 0 and by_path == {"wgmma": layers * forwards}, \
                f"rank {r['rank']} {part}: K2 {by_path} for {forwards} fused forwards"

    for part in ("a_gbdt", "b_transformer", "c_tensor_parallel", "d_serving", "e_streaming"):
        entry = {"ms_slowest_rank": max(r["parts"][part]["ms"] for r in ranks),
                 "bytes_a_rank": [r["parts"][part]["bytes"] for r in ranks],
                 "collective_calls_rank0": lead[part]["collective_calls"]}
        seg = lead[part].get("segment")
        if seg is not None:
            entry["segment"] = seg
            entry["shard_skew_ratio"] = seg["shard_skew_ratio"]
        if part in one_ms:
            entry["one_process_ms"] = one_ms[part]
        doc["parts"][part] = entry
    doc["parts"]["b_transformer"]["max_abs_err"] = err_b
    doc["parts"]["c_tensor_parallel"]["max_abs_err"] = err_c
    doc["parts"]["c_tensor_parallel"]["describe"] = lead["c_tensor_parallel"]["describe"]
    doc["parts"]["d_serving"].update(
        max_abs_err=err_d, requests=FMESH_REQUESTS, clients=FMESH_CLIENTS, ladder=d["ladder"],
        resident_batches=d["resident_batches"], paths=d["paths"],
        client_p50_ms=d["client_p50_ms"], client_p99_ms=d["client_p99_ms"],
        followed=[r["parts"]["d_serving"]["followed"] for r in ranks[1:]])
    doc["parts"]["e_streaming"].update(batches=e["batches"], rows=e["rows"],
                                       sink_equals_one_rank_query=True)
    k2_by_rank = {f"fusion_mesh_rank{r['rank']}": sum(by_path["wgmma"]
                                                        for by_path, _ in r["k2"].values())
                  for r in ranks}
    doc["k2_launches_by_rank"] = k2_by_rank
    doc["tolerances"] = {"a_gbdt": "bytes", "b_transformer": FMESH_DP_TOL,
                         "c_tensor_parallel": FMESH_TP_TOL, "d_serving": FMESH_DP_TOL,
                         "e_streaming": "bytes"}
    doc["seconds"] = time.perf_counter() - t_start
    emit(doc)
    print(f"slice_fusion_mesh on {card}: " + ", ".join(
        f"{part} {p['ms_slowest_rank']:.1f} ms / {sum(p['bytes_a_rank']) / 2**20:.1f} MiB"
        + (f" skew {p['shard_skew_ratio']:.3f}" if p.get("shard_skew_ratio") else "")
        for part, p in doc["parts"].items()), flush=True)
    return {**doc, "bundle": bundle, "flash_launches_by_rank": k2_by_rank}


# slice_elastic: elastic GBDT and DNN fits on real worker processes
# once 10 rounds and 8,192 rows (32 steps): 68.5 s for the phase on an H100;
# cut to keep the phase near its budget, both spawns and the respawn kept
ELASTIC_GBDT = dict(rows=32768, held_out=8192, features=14, rounds=7, leaves=31, max_bin=255,
                    virtual=8, workers=2, kill_at=3, respawn_at=6)
ELASTIC_DNN = dict(rows=6144, features=TABULAR_F, hidden=[256, 256], classes=2, batch=256,
                   epochs=1, virtual=8, workers=2, kill_at=8, respawn_at=16, lr=1e-3)
ELASTIC_DEADLINE_S = 180.0       # each fit: past it the fleet is killed and the phase fails
ELASTIC_GRAD_TOL = (2e-4, 2e-5)  # the trainer gate (tests/test_torch_trainer_common.py:13)


class _LocalFleet:
    """In-process stand-in for ServingFleet: one elastic worker handler a
    URL, driven through the same protocol with no process (the reference
    tests' `_LocalFleet`, tests/test_elastic_fleet.py:44-79)."""

    def __init__(self, checkpoint_dir: str, n: int):
        from mmlspark_tpu_torch.resilience import ElasticWorkerFactory

        self.handlers = {f"http://local/{i:03d}": ElasticWorkerFactory(checkpoint_dir,
                                                                       guard=False)()
                         for i in range(n)}

    urls = property(lambda self: list(self.handlers))

    def watch(self, cb):
        pass

    def dump_all(self, trigger=""):
        return 0

    def stop(self):
        pass

    def post(self, url: str, body: dict) -> dict:
        from mmlspark_tpu_torch.core import Table
        from mmlspark_tpu_torch.io_http.schema import HTTPRequestData

        rep = self.handlers[url](Table({"request": [HTTPRequestData.from_json("/", body)]}))
        rep = rep["reply"][0]
        doc = json.loads(bytes(rep.entity).decode("utf-8"))
        if rep.status_code != 200:
            raise RuntimeError(doc.get("error", "handler error"))
        return doc


def _chaos(kill_at: int, respawn_at: int, times: dict):
    """The reference's chaos hook (tests/test_elastic_fleet.py:629-641) at
    two steps: SIGKILL worker 0 at `kill_at`, respawn it at `respawn_at`
    (timed). Before the kill it counts the card's contexts."""
    def hook(fit):
        if fit.step == kill_at and "killed_at" not in times:
            times["killed_at"] = fit.step
            times["contexts"] = len(_compute_apps())
            fit.fleet.kill(0)
        elif fit.step == respawn_at and "respawn_s" not in times:
            t0 = time.perf_counter()
            fit.fleet.respawn(fit.fleet.dead_slots()[0])
            times["respawn_s"] = time.perf_counter() - t0
    return hook


def _bounded_fit(fit, *args, deadline_s: float = ELASTIC_DEADLINE_S):
    """fit.fit(*args) under a deadline: past it a timer kills every worker
    of the fleet (the fit then fails), and this raises."""
    import threading

    fired = threading.Event()

    def kill_fleet():
        fired.set()
        fleet = fit.fleet
        for slot in list(getattr(fleet, "live_slots", lambda: [])()):
            try:
                fleet.kill(slot)
            except Exception:  # noqa: BLE001 — the fit fails either way
                pass

    timer = threading.Timer(deadline_s, kill_fleet)
    timer.daemon = True
    timer.start()
    try:
        return fit.fit(*args)
    except BaseException as exc:
        if fired.is_set():
            raise RuntimeError(f"elastic {fit.kind} fit missed its {deadline_s} s "
                               "deadline; its fleet was killed") from exc
        raise
    finally:
        timer.cancel()


def _elastic_fleet(checkpoint_dir: str, workers: int):
    """A ServingFleet of elastic workers starting on a thread (its workers
    load the spec at their first configure, so they can spawn while this
    process fits the in-process reference). Returns a function that waits
    for it: (fleet, spawn seconds)."""
    from mmlspark_tpu_torch.io_http.serving import ServingFleet
    from mmlspark_tpu_torch.resilience import ElasticWorkerFactory

    fleet = ServingFleet(ElasticWorkerFactory(checkpoint_dir), n_hosts=workers,
                         rendezvous=False, start_timeout_s=120.0,
                         flight_recorder_dir=os.path.join(checkpoint_dir, "flight"))
    pool = ThreadPoolExecutor(1)
    t0 = time.perf_counter()
    started = pool.submit(lambda: (fleet.start(), time.perf_counter() - t0)[1])

    def wait() -> tuple:
        try:
            return fleet, started.result(timeout=180.0)
        except BaseException:
            fleet.stop()
            raise
        finally:
            pool.shutdown(wait=False)
    return wait


def elastic_gbdt(tmp: Path) -> dict:
    """(a) ElasticGBDTFit on the Adult shape over 2 ServingFleet workers
    (spawned while the reference fits), worker 0 SIGKILLed at step 3 and
    respawned at step 6; against an undisturbed P=1 fit through
    in-process handlers."""
    from mmlspark_tpu_torch.automl.metrics import auc
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
    from mmlspark_tpu_torch.resilience import ElasticGBDTFit

    c = ELASTIC_GBDT
    x_all, y_all = make_dataset(c["rows"] + c["held_out"], c["features"])
    real_dir = str(tmp / "gbdt_fleet")
    contexts = len(_compute_apps())
    started = _elastic_fleet(real_dir, c["workers"])
    x, y, xv, yv = x_all[:c["rows"]], y_all[:c["rows"]], x_all[c["rows"]:], y_all[c["rows"]:]
    kw = dict(objective="binary", num_iterations=c["rounds"], num_leaves=c["leaves"],
              max_bin=c["max_bin"], num_virtual=c["virtual"], seed=0, device="cuda",
              request_timeout_s=120.0)

    local_dir = str(tmp / "gbdt_local")
    os.makedirs(local_dir)
    local = _LocalFleet(local_dir, 1)
    calm = ElasticGBDTFit(local_dir, n_workers=1, fleet=local, post=local.post, **kw)
    t0 = time.perf_counter()
    try:
        _bounded_fit(calm, x, y)
    except BaseException:
        started()[0].stop()
        raise
    local_s = time.perf_counter() - t0
    fleet, spawn_s = started()
    times: dict = {}
    fit = ElasticGBDTFit(real_dir, n_workers=c["workers"], fleet=fleet,
                         step_hook=_chaos(c["kill_at"], c["respawn_at"], times), **kw)
    torch.cuda.synchronize()
    histogram.launches = 0
    t0 = time.perf_counter()
    booster = _bounded_fit(fit, x, y)
    fit_s = time.perf_counter() - t0
    launches = histogram.launches
    assert launches == 0, f"the elastic GBDT driver launched K1 {launches} times"
    # host histograms: the workers open no context on the card
    assert times["contexts"] == contexts, (times["contexts"], contexts)
    assert fit.model_digest() == calm.model_digest(), \
        "the elastic GBDT fit through a kill and a respawn differs from the calm P=1 fit"
    causes = [r["cause"] for r in fit.reshards]
    assert "death" in causes and "join" in causes, causes
    assert booster.num_trees == c["rounds"] and booster.device.startswith("cuda")
    raw_card = booster.predict_raw(xv, device="device")
    raw_host = booster.predict_raw(xv, device="host")
    assert np.array_equal(raw_card, raw_host), "card traversal differs from the host walk"
    valid_auc = auc(yv, booster.predict(xv))
    assert valid_auc > 0.75, f"elastic GBDT held-out AUC {valid_auc}"
    return {"rows": c["rows"], "features": c["features"], "rounds": c["rounds"],
            "num_leaves": c["leaves"], "max_bin": c["max_bin"], "num_virtual": c["virtual"],
            "workers": c["workers"], "spawn_seconds": spawn_s,
            "respawn_seconds": times.get("respawn_s"), "fit_seconds": fit_s,
            "in_process_p1_seconds": local_s, "reshards": len(fit.reshards),
            "reshard_causes": causes, "model_digest": fit.model_digest(),
            "digest_equals_p1": True, "valid_auc": valid_auc, "driver_k1_launches": launches,
            "card_equals_host_walk": True, "card_contexts_during_fit": times["contexts"],
            "straggler_wait_s": fit.signals()["straggler_wait_s"]}


def _stop_after_first_step(store: dict):
    class _Stop(Exception):
        pass

    def hook(fit):
        if fit.step == 1:
            store["merged"] = np.array(fit.last_merged, copy=True)
            raise _Stop
    return hook, _Stop


def elastic_dnn(tmp: Path) -> dict:
    """(b) ElasticDNNFit of an MLP ([256, 256], 2 classes, input width 108)
    over 2 ServingFleet workers on the card (spawned while the references
    fit), worker 0 SIGKILLed at step 8 and respawned at step 16; against
    an undisturbed P=1 in-process fit on the card, and its first merged
    gradient against the CPU's."""
    from mmlspark_tpu_torch.resilience import ElasticDNNFit

    c = ELASTIC_DNN
    rng = np.random.default_rng(41)
    x = rng.normal(size=(c["rows"], c["features"])).astype(np.float32)
    w = rng.normal(size=c["features"])
    y = (x @ w + 0.5 * rng.normal(size=c["rows"]) > 0).astype(np.int64)
    kw = dict(architecture="mlp", model_config={"features": c["hidden"]}, loss="softmax_ce",
              optimizer="adam", learning_rate=c["lr"], epochs=c["epochs"],
              batch_size=c["batch"], seed=0, num_virtual=c["virtual"], request_timeout_s=120.0)

    def local_fit(name: str, device: str, hook=None):
        d = str(tmp / name)
        os.makedirs(d)
        local = _LocalFleet(d, 1)
        return ElasticDNNFit(d, n_workers=1, fleet=local, post=local.post, device=device,
                             step_hook=hook, **kw)

    real_dir = str(tmp / "dnn_fleet")
    started = _elastic_fleet(real_dir, c["workers"])
    try:
        calm = local_fit("dnn_local", "cuda")
        t0 = time.perf_counter()
        _bounded_fit(calm, x, y)
        local_s = time.perf_counter() - t0
        first: dict = {}
        hook, stop = _stop_after_first_step(first)
        for name, device in (("card", "cuda"), ("host", "cpu")):
            try:
                _bounded_fit(local_fit(f"dnn_first_{name}", device, hook), x, y)
            except stop:
                first[name] = first.pop("merged")
        rtol, atol = ELASTIC_GRAD_TOL
        grad_err = float(np.max(np.abs(first["card"] - first["host"])))
        assert np.allclose(first["card"], first["host"], rtol=rtol, atol=atol), \
            f"first merged gradient card vs CPU: max |err| {grad_err}"
    except BaseException:
        started()[0].stop()
        raise

    fleet, spawn_s = started()
    times: dict = {}
    fit = ElasticDNNFit(real_dir, n_workers=c["workers"], fleet=fleet, device="cuda",
                        step_hook=_chaos(c["kill_at"], c["respawn_at"], times), **kw)
    t0 = time.perf_counter()
    bundle = _bounded_fit(fit, x, y)
    fit_s = time.perf_counter() - t0
    steps = c["rows"] // c["batch"] * c["epochs"]
    assert fit.step == calm.step == steps, (fit.step, calm.step, steps)
    assert fit.params_digest() == calm.params_digest(), \
        "the elastic DNN fit through a kill and a respawn differs from the calm P=1 fit"
    causes = [r["cause"] for r in fit.reshards]
    assert "death" in causes and "join" in causes, causes
    flat = fit.params_flat()
    assert np.isfinite(flat).all()
    model = bundle.module.to("cuda")
    with torch.no_grad():
        logits = model(torch.as_tensor(x, device="cuda")).float()
        loss = float(torch.nn.functional.cross_entropy(logits, torch.as_tensor(y, device="cuda")))
        accuracy = float((logits.argmax(-1).cpu().numpy() == y).mean())
    assert np.isfinite(loss), loss
    return {"rows": c["rows"], "input_width": c["features"], "hidden": c["hidden"],
            "batch": c["batch"], "steps": steps, "num_virtual": c["virtual"],
            "workers": c["workers"], "spawn_seconds": spawn_s,
            "respawn_seconds": times.get("respawn_s"), "fit_seconds": fit_s,
            "steps_per_s": steps / fit_s, "in_process_p1_seconds": local_s,
            "reshards": len(fit.reshards), "reshard_causes": causes,
            "params_digest": fit.params_digest(), "digest_equals_p1": True,
            "first_grad_card_vs_cpu_max_abs_err": grad_err, "final_loss": loss,
            "train_accuracy": accuracy}


def phase_slice_elastic(card: str) -> dict:
    """Elastic training on the card: (a) an elastic GBDT fit whose workers
    build host histograms (0 K1 launches in the driver), (b) an elastic
    DNN fit whose workers compute on the card; each through a real SIGKILL
    and a respawn, its model's digest equal to an undisturbed P=1 fit's.
    Each fit runs under a deadline that kills its fleet."""
    import tempfile

    t0 = time.perf_counter()
    doc = {"phase": "slice_elastic", "card": card}
    with tempfile.TemporaryDirectory(prefix="slice_elastic_", dir=ROOT / "build") as tmp:
        doc["gbdt"] = elastic_gbdt(Path(tmp))
        doc["dnn"] = elastic_dnn(Path(tmp))
    doc["seconds"] = time.perf_counter() - t0
    emit(doc)
    g, d = doc["gbdt"], doc["dnn"]
    print(f"slice_elastic on {card}: GBDT fit {g['fit_seconds']:.2f} s (spawn "
          f"{g['spawn_seconds']:.2f} s, respawn {g['respawn_seconds']:.2f} s, "
          f"{g['reshards']} re-shards), AUC {g['valid_auc']:.4f}; DNN {d['steps_per_s']:.1f} "
          f"steps/s (spawn {d['spawn_seconds']:.2f} s, respawn {d['respawn_seconds']:.2f} s, "
          f"{d['reshards']} re-shards), final loss {d['final_loss']:.4f}", flush=True)
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

    env = phase_env()
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
    checkpoint = phase_slice_checkpoint()
    phase_slice_lightgbm_import(adult, categorical)
    mesh = phase_slice_mesh(adult)
    regressor = serving_regressor()          # slice_fusion_mesh's and slice_serving's
    fusion_mesh = phase_slice_fusion_mesh(mesh["pool"], env["nvidia_smi"], regressor[0])
    parallel = phase_slice_parallel(mesh.pop("pool"), env["nvidia_smi"],
                                    fusion_mesh.pop("bundle"))
    dnn = phase_slice_transformer(parallel.pop("bundle"))
    small = phase_small_transformer()
    wide = phase_serve_wide()
    phase_profile_transformer(dnn["stage"], dnn["tokens"])
    phase_stage_roundtrip(dnn["stage"], dnn["tokens"])
    phase_slice_zoo()
    featurize = phase_slice_featurize()
    tabular = phase_slice_tabular(env["nvidia_smi"])
    serving = phase_slice_serving(env["nvidia_smi"], dnn["bundle"], regressor)
    fleet = phase_slice_fleet(env["nvidia_smi"], serving.pop("regressor"), dnn["bundle"])
    train = phase_slice_train()
    recsys = phase_slice_recsys_automl(env["nvidia_smi"])
    streaming = phase_slice_streaming(env["nvidia_smi"], dnn["bundle"], tabular.pop("model"))
    elastic = phase_slice_elastic(env["nvidia_smi"])

    main_shape = kern["histogram"][0]
    flash_main = kern["flash_attention"][0]
    f32_rows = [r for r in kern["flash_attention"] if r["path"] == "tf32x3"]
    f32_main = next(r for r in f32_rows if r["shape"] == "slice_f32")
    mma_rows = [r for r in kern["flash_attention"] if r["path"] == "mma"]
    mma_main = next(r for r in mma_rows if r["shape"] == "default_bf16")
    wgmma_wide_rows = [r for r in kern["flash_attention"]
                       if r["path"] == "wgmma" and r["D"] > 128]
    wgmma_d192 = next(r for r in wgmma_wide_rows if r["shape"] == "d192_bf16")
    bert_row = next(r for r in kern["flash_attention"] if r["shape"] == "bert_bf16")
    wide_rows = [r for r in kern["flash_attention"] if r["path"] == "wide"]
    wide_main = next(r for r in wide_rows if r["shape"] == "d192_f32")
    train_k2 = train["transformer"]
    train_main = train["flash_fwd_bwd"][0]
    emit({"kernels": [{
        "name": "histogram",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/hist_kernel.cu",
        "replaces": "mmlspark_tpu/gbdt/hist_kernel.py:227",
        # every fit of the main path: Adult, Higgs, digits multiclass, the
        # five objectives, the Adult fits under each boosting type, the
        # early-stopped fit and its warm start, the 28 gate fits, the
        # categorical Adult and Amazon-access fits (B 256 and 1024), the
        # numeric Adult fit at max_bin 16383 (B 16,384), the five
        # checkpoint fits (uninterrupted, chunked, preempted and resumed,
        # goss and its chunked twin), slice_mesh's four 4-rank fits (every
        # rank's launches, counted in its own process), slice_tabular's
        # TrainClassifier fit (the one-hot Adult CSV, F 108) and text fit
        # (F 4,096), slice_serving's regressor, and slice_recsys_automl's
        # fits in this process: TuneHyperparameters' trials, refit and
        # resumed refit, the default model, the fold's card fit, and each
        # sweep's refits of its survivors (the sweep workers' own fits run
        # in their processes and are not counted here)
        "launches": (adult["histogram_launches"] + higgs["histogram_launches"]
                     + multiclass["histogram_launches"] + objectives["histogram_launches"]
                     + boosting["histogram_launches"] + early["histogram_launches"]
                     + early["warm_start_launches"] + gates["histogram_launches"]
                     + categorical["histogram_launches"] + wide_bins["histogram_launches"]
                     + max_bin["histogram_launches"] + checkpoint["histogram_launches"]
                     + sum(mesh["histogram_launches_by_fit"].values())
                     + tabular["fit"]["histogram_launches"]
                     + tabular["text"]["histogram_launches"]
                     + serving["fit"]["histogram_launches"]
                     + recsys["tune"]["histogram_launches"]
                     + recsys["sweep"]["histogram_launches"]),
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
                            "max_bin_16383": max_bin["histogram_launches"],
                            **{f"checkpoint_{name}": fit["histogram_launches"]
                               for name, fit in checkpoint["fits"].items()},
                            **mesh["histogram_launches_by_fit"],
                            "tabular": tabular["fit"]["histogram_launches"],
                            "text": tabular["text"]["histogram_launches"],
                            "serving_regressor": serving["fit"]["histogram_launches"],
                            "recsys_tune": recsys["tune"]["histogram_launches"],
                            **{f"recsys_sweep_{name}": run["histogram_launches"]
                               for name, run in recsys["sweep"]["runs"].items()},
                            # the elastic GBDT workers build host histograms
                            "elastic_gbdt_driver": elastic["gbdt"]["driver_k1_launches"]},
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
        # the wgmma kernel: the bf16 serving transformer (D 64), the bf16
        # wide transformer (D 192), the imported BERT-base-wide encoder
        # (D 64), slice_serving's transformer over HTTP (D 64, replayed
        # from the fused segment's CUDA graphs) and slice_fleet's two
        # replicas of it behind the gateway (each replica's own count),
        # slice_streaming's streamed and profiled transformer (D 64),
        # slice_parallel's use_mesh serving in each of the 4 ranks
        # (`mesh_serving_rank*`, counted in each rank's process), and
        # slice_fusion_mesh's fused transformer and its server in each of
        # the 4 ranks (`fusion_mesh_rank*`, replayed from each rank's
        # CUDA graphs, counted in each rank's process)
        "launches": (dnn["flash_launches"] + wide["bfloat16"]["flash_launches"]
                     + featurize["encoder"]["flash_launches"]
                     + serving["transformer_http"]["flash_launches"]
                     + fleet["transformer"]["flash_launches"]
                     + streaming["flash_launches"]
                     + sum(parallel["flash_launches_by_rank"].values())
                     + sum(fusion_mesh["flash_launches_by_rank"].values())),
        "launches_by_phase": {**parallel["flash_launches_by_rank"],
                              **fusion_mesh["flash_launches_by_rank"],
                              "slice_transformer": dnn["flash_launches"],
                              "serve_wide_bf16": wide["bfloat16"]["flash_launches"],
                              "slice_featurize": featurize["encoder"]["flash_launches"],
                              "slice_serving": serving["transformer_http"]["flash_launches"],
                              # counted in each replica process, read back from it
                              "slice_fleet": fleet["transformer"]["flash_launches"],
                              "slice_streaming": streaming["flash_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in kern["flash_attention"]),
        "ms": flash_main["ms"],
        "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound_ms"],
        "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["library_ms"],
        "shape": flash_main["shape"],
        "path": flash_main["path"],
        # slice_featurize's launches, at the imported encoder's 12 heads
        "featurize_row": {key: bert_row[key] for key in (
            "shape", "H", "path", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")},
        # its rows above head dim 128, d192 (serve_wide's) first
        "wide_rows": [{key: r[key] for key in ("shape", "D", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "max_abs_err")}
                      for r in [wgmma_d192] + [r for r in wgmma_wide_rows if r is not wgmma_d192]],
        "shapes": kern["flash_attention"],
    }, {
        # the same wrapper and TPU kernel; the CUDA kernel every f32 bundle
        # serves through, with its launches from the f32 serving run and
        # slice_featurize's f32 encoders (the tiny imported one, and the
        # BERT-base-wide one's card-vs-CPU check)
        "name": "flash_attention_tf32x3",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attn.cu",
        "replaces": "mmlspark_tpu/nn/attention.py:192",
        "launches": (dnn["f32_flash_launches"] + featurize["encoder"]["tiny_flash_launches"]
                     + featurize["encoder"]["f32_flash_launches"]),
        "launches_by_phase": {"slice_transformer": dnn["f32_flash_launches"],
                              "slice_featurize": featurize["encoder"]["tiny_flash_launches"]
                              + featurize["encoder"]["f32_flash_launches"]},
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
    }, {
        # the same wrapper and TPU kernel, made differentiable: K2's forward
        # and the port of _flash_bwd_xla (torch code, attention.py:246), with
        # the launches of slice_train's fits (every layer of every step;
        # twice a step under remat)
        "name": "flash_attention_fwd_bwd",
        "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attn.cu",
        "replaces": "mmlspark_tpu/nn/attention.py:192",
        "launches": train_k2["fit"]["flash_launches"] + train_k2["remat"]["flash_launches"],
        "launches_by_fit": {"transformer": train_k2["fit"]["flash_launches"],
                            "transformer_remat": train_k2["remat"]["flash_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in train["flash_fwd_bwd"]),
        "ms": train_main["ms"],
        "plain_ms": train_main["plain_ms"],
        "bound_ms": train_main["bound_ms"],
        "bound_by": train_main["bound_by"],
        "library_ms": train_main["library_ms"],
        "shape": train_main["shape"],
        "path": train_main["path"],
        "shapes": train["flash_fwd_bwd"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
