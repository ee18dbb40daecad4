#!/usr/bin/env python3
"""K1 (the port's GBDT histogram kernel) on one NVIDIA GPU: compiler
report, a quick check against the plain version, the device time of its
kernels by name, and timings of two trees in turns.

Run from the root of a checkout on a machine with a card:

    python3 tools/torch_hist_turns.py ptxas [TREE ...]
        nvcc -Xptxas -v of TREE's csrc/hist_kernel.cu (default: this
        checkout) with the port's flags: registers, spills and shared
        memory of every kernel, and from cuobjdump -sass each kernel's
        highest register and its local loads and stores.
    python3 tools/torch_hist_turns.py check
        one launch of K1 at each of chip_smoke.HIST_SHAPES against
        histogram_torch on stats on a 2**-10 grid (exact in any order):
        the launch plan's branch, equality, the same bits twice.
    python3 tools/torch_hist_turns.py plans [--shapes A,B] [--out FILE]
        above 256 bins: at each chip_smoke.HIST_SHAPES row past 256 bins
        (or the named ones), with every row kept and with 3% kept, the plan
        launch_plan picks and a spread of the others `wide_plans` weighs
        (the best of each warps-a-block and each grid_x class, and plans
        at ranks 1, 2, 3, 5, 8, 13, ... of the model), each launched once
        against histogram_torch on the 2**-10 grid, then timed: the
        modelled microseconds beside the measured median ms. One JSON line
        a plan, also written to FILE.
    python3 tools/torch_hist_turns.py mix [--device cuda|cpu] [--out FILE]
        the share of rows each K1 call keeps over the 3,100 calls of each
        fit that runs K1 above 256 bins (chip_smoke's slice_max_bin_16383
        and slice_high_cardinality, 100 rounds of 31 leaves): the mean, the
        quantiles, and the calls' weights in buckets of shares. On a card
        also, at each fit's (n, F, B), a spread of `wide_plans` timed at
        each bucket's mean share, weighed by the bucket's calls: the mix's
        ms of the plan `device_plan` picks beside the fastest plan timed.
    python3 tools/torch_hist_turns.py fit FILE ...
        (no card needed) the constants of launch_plan's model above 256
        bins (`_WIDE_US`) fitted to FILEs of `plans` lines: non-negative
        least squares on relative error; then, at each shape and share of
        rows kept, the measured ms of the plan the fitted model would pick
        beside the fastest plan timed.
    python3 tools/torch_hist_turns.py split TREE ...
        each TREE's K1 kernels by name under torch.profiler, 50 calls at
        the Adult shape (32,768 x 14 int32) with every row kept and with
        3% kept: device microseconds a call of each kernel.
    python3 tools/torch_hist_turns.py variants OUT NAME ...
        writes, for each NAME of VARIANTS below, a copy of this checkout's
        chip_smoke.py and mmlspark_tpu_torch/ to OUT/NAME with that
        variant's edits (each must match once): ablations that drop one
        part of the kernel to see what its time is made of (wrong on
        purpose, only timed) and tunings of the launch plan.
    python3 tools/torch_hist_turns.py time NAME=TREE ... [--shapes A,B]
        K1's median ms (chip_smoke.median_ms) and device microseconds a
        call (torch.profiler, 50 calls) at chip_smoke.HIST_SHAPES (or the
        named ones) for each tree, in a fresh process each, without any
        check.
    python3 tools/torch_hist_turns.py turns NAME=TREE ... --order A,B,B,A
        for each name in --order, a fresh process that builds TREE's
        kernels and runs TREE's chip_smoke.histogram_rows() (median ms of
        K1, the plain version and index_add_, host microseconds a call, at
        each of its shapes), the host microseconds of one call at the Adult
        shape while a sleep kernel holds the stream (the wrapper's own
        cost), the seconds of chip_smoke's 100-round Adult
        fit (GBDTClassifier, 3,100 K1 launches) and 5-round Higgs fit
        (Booster.train, 315 launches), and a profiled 10-round Adult fit:
        device seconds of K1 by kernel name against all kernels and the
        split search's scans. Compare two versions only inside one call.
    python3 tools/torch_hist_turns.py fits NAME=TREE ... --order A,B,B,A
        the fit alone: for each name in --order, a fresh process that
        builds TREE's kernels, warms up, takes the wrapper's host
        microseconds a call at the Adult shape (a sleep kernel holding the
        stream), then times three 100-round Adult fits (GBDTClassifier,
        3,100 K1 launches each) with nothing else run in the process.

Each result is one JSON line on stdout, with the card's name and power
limit. The TREEs are checkouts (for example a `git archive` of a parent
commit unpacked under build/); each builds into its own build/.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.torch_flash_turns import _card, ptxas  # noqa: E402

# run inside each turn's process, from the tree's root
_TURN = r"""
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke
import mmlspark_tpu_torch  # noqa: F401
from mmlspark_tpu_torch.core import kernels
from mmlspark_tpu_torch.gbdt import GBDTClassifier
from mmlspark_tpu_torch.gbdt.booster import Booster, TrainOptions
from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
kernels.build(["hist_kernel"])
rows = chip_smoke.histogram_rows()
empty = chip_smoke.hist_empty_launch_ms() if hasattr(chip_smoke, "hist_empty_launch_ms") else None
# the wrapper's host cost a call while a sleep kernel holds the stream, at
# the Adult shape (this tool's own measure, so both trees get it)
bins, stats = chip_smoke._hist_inputs(32768, 14, torch.int32, 1.0, seed=100)
for _ in range(20):
    histogram(bins, stats, 256)
torch.cuda.synchronize()
torch.cuda._sleep(400_000_000)
t0 = time.perf_counter()
for _ in range(200):
    histogram(bins, stats, 256)
enqueue_us = (time.perf_counter() - t0) / 200 * 1e6
torch.cuda.synchronize()

x, y = chip_smoke.make_dataset(32768, 14)
table = chip_smoke._table(x, y)
GBDTClassifier(num_iterations=2, num_leaves=31, device="cuda").fit(table)
torch.cuda.synchronize()
histogram.launches = 0
t0 = time.perf_counter()
GBDTClassifier(num_iterations=100, num_leaves=31, device="cuda").fit(table)
adult_s = time.perf_counter() - t0
adult_launches = histogram.launches

xh, yh = chip_smoke.make_dataset_wide(1 << 20, 28)
opts = TrainOptions(objective="binary", num_iterations=5, num_leaves=63, bin_dtype="uint8",
                    device="cuda")
torch.cuda.synchronize()
histogram.launches = 0
t0 = time.perf_counter()
Booster.train(xh, yh, opts)
higgs_s = time.perf_counter() - t0
higgs_launches = histogram.launches

profile = chip_smoke.phase_profile_adult()
print("TURN " + json.dumps({
    "rows": rows, "empty_launch": empty, "adult_host_enqueue_us": enqueue_us,
    "adult_fit_seconds": adult_s, "adult_launches": adult_launches,
    "higgs_fit_seconds": higgs_s, "higgs_launches": higgs_launches,
    "profile_adult": {k: profile.get(k) for k in (
        "wall_seconds_profiled", "device_kernel_seconds", "histogram_kernel_seconds",
        "histogram_kernels", "scan_seconds", "top_kernels")}}), flush=True)
"""

# run inside each `fits` turn's process, from the tree's root
_FITS = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke
import mmlspark_tpu_torch  # noqa: F401
from mmlspark_tpu_torch.core import kernels
from mmlspark_tpu_torch.gbdt import GBDTClassifier
from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
kernels.build(["hist_kernel"])
x, y = chip_smoke.make_dataset(32768, 14)
table = chip_smoke._table(x, y)
GBDTClassifier(num_iterations=2, num_leaves=31, device="cuda").fit(table)
bins, stats = chip_smoke._hist_inputs(32768, 14, torch.int32, 1.0, seed=100)
for _ in range(20):
    histogram(bins, stats, 256)
torch.cuda.synchronize()
torch.cuda._sleep(400_000_000)
t0 = time.perf_counter()
for _ in range(200):
    histogram(bins, stats, 256)
enqueue_us = (time.perf_counter() - t0) / 200 * 1e6
torch.cuda.synchronize()
seconds = []
for _ in range(3):
    histogram.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    GBDTClassifier(num_iterations=100, num_leaves=31, device="cuda").fit(table)
    seconds.append(time.perf_counter() - t0)
    assert histogram.launches == 3100
print("FITS " + json.dumps({"adult_host_enqueue_us": enqueue_us,
                            "adult_fit_seconds": seconds}), flush=True)
"""

_SPLIT = r"""
import json, sys
sys.path.insert(0, ".")
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke
import mmlspark_tpu_torch  # noqa: F401
from mmlspark_tpu_torch.core import kernels
from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
kernels.build(["hist_kernel"])
calls, out = 50, {}
for label, frac in (("adult_int32", 1.0), ("adult_int32_masked3pct", 0.03)):
    bins, stats = chip_smoke._hist_inputs(32768, 14, torch.int32, frac, seed=100)
    for _ in range(5):
        histogram(bins, stats, 256)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            histogram(bins, stats, 256)
        torch.cuda.synchronize()
    out[label] = {e.key[:80]: {"us_per_call": e.self_device_time_total / calls,
                               "count": e.count}
                  for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
print("SPLIT " + json.dumps(out), flush=True)
"""


_TIME = r"""
import json, sys
sys.path.insert(0, ".")
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke
import mmlspark_tpu_torch  # noqa: F401
from mmlspark_tpu_torch.core import kernels
from mmlspark_tpu_torch.gbdt.hist_kernel import histogram
kernels.build(["hist_kernel"])
only, out = set(json.loads(sys.argv[1])), {}
for i, (name, n, f, dt, frac, nb) in enumerate(chip_smoke.HIST_SHAPES):
    if only and name not in only:
        continue
    bins, stats = chip_smoke._hist_inputs(n, f, dt, frac, seed=100 + i, num_bins=nb)
    ms = chip_smoke.median_ms(lambda: histogram(bins, stats, nb))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            histogram(bins, stats, nb)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "hist" in e.key) / 50
    out[name] = {"ms": ms, "device_us": us}
print("TIME " + json.dumps(out), flush=True)
"""

_CU = Path("mmlspark_tpu_torch") / "csrc" / "hist_kernel.cu"
_PY = Path("mmlspark_tpu_torch") / "gbdt" / "hist_kernel.py"
# name: [(file, old, new)], each old matching once
VARIANTS = {
    # no adding up: stats, compaction, bin copies, partials, barrier, sums
    "no_accumulate": [(_CU, "        accumulate<BinT>(p, s, buf, fg);\n", "")],
    # the lane groups from __match_any_sync in place of the mask words
    "match_any": [(_CU, """            if (ok) atomicOr(masks + b, 1u << lane);
            __syncwarp();
            const unsigned peers = ok ? masks[b] : 0u;
            __syncwarp();""", """            const unsigned active = __ballot_sync(kFullMask, ok);
            const unsigned peers = ok ? __match_any_sync(active, b) : 0u;"""),
                  (_CU, "                    masks[b] = 0u;\n", "")],
    # every lane its own leader: no lane groups (races where bins repeat)
    "no_groups": [(_CU, """            if (ok) atomicOr(masks + b, 1u << lane);
            __syncwarp();
            const unsigned peers = ok ? masks[b] : 0u;
            __syncwarp();""", """            const unsigned peers = 1u << lane;"""),
                  (_CU, "                    masks[b] = 0u;\n", "")],
    # no read-add-write of the histogram (the sums kept alive, never stored)
    "no_rmw": [(_CU, """                    h[0] += a0;
                    h[1] += a1;
                    h[2] += a2;""", """                    if (a0 == 1234.5f) h[0] = a1 + a2;""")],
    # the leader's read-add-write as three shared-memory float atomic adds
    # (still one writer per bin at a time, so still in a fixed order)
    "red_f32": [(_CU, """                    h[0] += a0;
                    h[1] += a1;
                    h[2] += a2;""", """                    atomicAdd(h, a0);
                    atomicAdd(h + 1, a1);
                    atomicAdd(h + 2, a2);""")],
    # the kernel cut short after each phase: the launch alone, the zeroing
    # of the histograms, the tiles (stats, compaction, bins, adding up)
    "ret_start": [(_CU, "    const Smem s = carve<kWide>(smem_raw, p);\n",
                   "    const Smem s = carve<kWide>(smem_raw, p);\n    if (p.n >= 0) return;\n")],
    "ret_after_zero": [(_CU, "    WideWarp ww;\n",
                        "    __syncthreads();\n    if (p.n >= 0) return;\n    WideWarp ww;\n")],
    "ret_before_partial": [(_CU, "    // the block's partial: its copies summed in copy order\n",
                            "    if (p.n >= 0) return;\n")],
    # the grid barrier as a counter in device memory that each block's
    # first thread bumps and then waits on (one stream at a time)
    "own_barrier": [(_CU, "namespace cg = cooperative_groups;\n", """namespace cg = cooperative_groups;
__device__ unsigned own_barrier_state[2];
"""), (_CU, "    cg::this_grid().sync();", """    __syncthreads();
    if (threadIdx.x == 0) {
        volatile unsigned* gen = own_barrier_state + 1;
        const unsigned g = *gen;
        __threadfence();
        if (atomicAdd(own_barrier_state, 1u) == gridDim.x * gridDim.y - 1) {
            own_barrier_state[0] = 0u;
            __threadfence();
            atomicAdd(own_barrier_state + 1, 1u);
        } else {
            while (*gen == g) {}
        }
        __threadfence();
    }
    __syncthreads();""")],
    # %globaltimer of each block at its start, after its tiles, after its
    # partial, after the grid barrier, at its end, and in the cross-block
    # sum after the staging and after the runs' sums, read back through
    # mmlspark_hist_timeline (`timeline`)
    "timeline": [
        (_CU, "namespace cg = cooperative_groups;\n", """namespace cg = cooperative_groups;
__device__ unsigned long long hist_timeline[4096 * 7];
__device__ __forceinline__ void stamp(int k) {
    if (threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        hist_timeline[(blockIdx.y * gridDim.x + blockIdx.x) * 7 + k] = t;
    }
}
"""),
        (_CU, "    const Smem s = carve<kWide>(smem_raw, p);\n",
         "    const Smem s = carve<kWide>(smem_raw, p);\n    stamp(0);\n"),
        (_CU, "    // the block's partial: its copies summed in copy order\n",
         "    stamp(1);\n    // the block's partial: its copies summed in copy order\n"),
        (_CU, "    cg::this_grid().sync();\n",
         "    stamp(2);\n    cg::this_grid().sync();\n    stamp(3);\n"),
        (_CU, "        p.out[at + k] = sum;\n    }\n}\n",
         "        p.out[at + k] = sum;\n    }\n    __syncthreads();\n    stamp(4);\n}\n"),
        (_CU, "        cp_async_wait_all();\n        __syncthreads();\n        // slot i",
         "        cp_async_wait_all();\n        __syncthreads();\n        stamp(5);\n        // slot i"),
        (_CU, "    for (int k = tid; k < len; k += threads) {\n        float sum = run_sums[k];",
         "    stamp(6);\n    for (int k = tid; k < len; k += threads) {\n        float sum = run_sums[k];"),
        (_CU, 'const char* mmlspark_cuda_error_string(int code) {', """int mmlspark_hist_timeline(unsigned long long* out, int count) {
    return cudaMemcpyFromSymbol(out, hist_timeline, count * sizeof(unsigned long long));
}

const char* mmlspark_cuda_error_string(int code) {"""),
    ],
    # no grid barrier and no cross-block sum (the output is never written)
    "no_reduce": [(_CU, "    cg::this_grid().sync();", "    return;")],
    # the cross-block sum without the barrier before it (wrong sums)
    "no_barrier": [(_CU, "    cg::this_grid().sync();", "    __syncthreads();")],
    # one histogram copy a block (fewer warps where F < 32)
    "one_copy": [(_PY, "for copies in range(max(1, 32 // warps), 0, -1):",
                  "for copies in range(1, 0, -1):")],
    # at least two tiles a block (half the blocks at the Adult shape)
    "two_tiles": [(_PY, "per = -(-tiles // grid_x_max) if grid_x_max >= 2 else tiles",
                   "per = max(2, -(-tiles // grid_x_max)) if grid_x_max >= 2 else tiles")],
    # 128-row tiles
    "tile_128": [(_PY, "_TILE_ROWS = (256, 128, 64, 32)", "_TILE_ROWS = (128, 64, 32)")],
}


def variants(out: str, names: list[str]) -> None:
    """Each variant's tree; `ptxas` of a variant tree shows its SASS."""
    import shutil

    for name in names:
        tree = Path(out) / name
        shutil.rmtree(tree, ignore_errors=True)
        tree.mkdir(parents=True)
        shutil.copy2(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
        shutil.copytree(ROOT / "mmlspark_tpu_torch", tree / "mmlspark_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__", "_build"))
        for rel, old, new in VARIANTS[name]:
            text = (tree / rel).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: an edit of {rel} matches {text.count(old)} times")
            (tree / rel).write_text(text.replace(old, new))
        print(json.dumps({"variant": name, "tree": str(tree), "edits": len(VARIANTS[name])}))


def time_trees(trees: list[str], shapes: list[str]) -> None:
    card = _card()
    for label, tree in (t.split("=", 1) for t in trees):
        doc = _run(_TIME, tree, "TIME", [json.dumps(shapes)])
        print(json.dumps({"tree": label, "card": card, "times": doc}), flush=True)


def _run(code: str, tree: str, tag: str, args: list[str] = ()) -> dict:
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=tree, capture_output=True,
                          text=True)
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
        raise SystemExit(f"{tree} failed with exit {proc.returncode}")
    return json.loads(next(line for line in proc.stdout.splitlines()
                           if line.startswith(tag + " "))[len(tag) + 1:])


_TIMELINE = r"""
import ctypes, json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke
import mmlspark_tpu_torch  # noqa: F401
from mmlspark_tpu_torch.gbdt.hist_kernel import _lib, device_plan, histogram
out = {}
for i, (name, n, f, dt, frac, nb) in enumerate(chip_smoke.HIST_SHAPES[:5]):
    bins, stats = chip_smoke._hist_inputs(n, f, dt, frac, seed=100 + i, num_bins=nb)
    plan = device_plan(n, f, nb, bins.element_size(), 0)
    for _ in range(20):
        histogram(bins, stats, nb)
    torch.cuda.synchronize()
    histogram(bins, stats, nb)
    torch.cuda.synchronize()
    blocks = plan.grid_x * plan.grid_y
    buf = (ctypes.c_ulonglong * (blocks * 7))()
    timeline = _lib().mmlspark_hist_timeline
    timeline.argtypes, timeline.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    assert timeline(buf, blocks * 7) == 0
    t = np.array(buf, dtype=np.float64).reshape(blocks, 7)
    t = (t - t[:, 0].min()) / 1e3                     # microseconds from the first start
    out[name] = {"blocks": blocks, **{
        phase: [float(np.min(t[:, k])), float(np.median(t[:, k])), float(np.max(t[:, k]))]
        for k, phase in enumerate(("start", "tiles_done", "partial_done", "barrier_done", "end",
                                   "staged", "summed"))}}
print("TIMELINE " + json.dumps(out), flush=True)
"""


def timeline(tree: str) -> None:
    """Per phase, the first, median and last block to reach it, in
    microseconds from the first block's start, at the five main shapes:
    a `timeline` variant tree's stamps."""
    print(json.dumps({"timeline": tree, "card": _card(), **_run(_TIMELINE, tree, "TIMELINE")}),
          flush=True)


def check() -> None:
    import torch

    import chip_smoke
    from mmlspark_tpu_torch.gbdt.hist_kernel import device_plan, histogram, histogram_torch

    for i, (name, n, f, dt, frac, nb) in enumerate(chip_smoke.HIST_SHAPES):
        bins, stats = chip_smoke._hist_inputs(n, f, dt, frac, seed=100 + i, num_bins=nb)
        plan = device_plan(n, f, nb, bins.element_size(), 0)
        first, again = histogram(bins, stats, nb), histogram(bins, stats, nb)
        plain = histogram_torch(bins, stats, nb)
        torch.cuda.synchronize()
        print(json.dumps({"check": name, "branch": plan.branch,
                          "plan": plan._asdict(), "equal": torch.equal(first, plain),
                          "max_abs_err": (first - plain).abs().max().item(),
                          "same_bits": torch.equal(first, again)}), flush=True)


def _spread(ranked: list) -> list:
    """Indexes into `ranked` (plans sorted by modelled time) to time: the
    model's pick, the best of each class of warps a block, grid_x, feature
    groups, ranges (with small and large tiles), and ranks at Fibonacci
    steps."""
    picks, seen = [0], set()
    for i, (_, plan) in enumerate(ranked):
        gx = plan.grid_x
        keys = (("warps", plan.warps_per_copy),
                ("grid", "one" if gx == 1 else "few" if gx <= 8 else "some" if gx <= 32
                 else "many"),
                ("groups", plan.grid_y // plan.ranges),
                ("ranges", plan.ranges.bit_length()),
                ("ranges_rows", plan.ranges.bit_length(), plan.tile_rows >= 512))
        for key in keys:
            if key not in seen:
                seen.add(key)
                picks.append(i)
    a, b = 1, 2
    while a < len(ranked):
        picks.append(a)
        a, b = b, a + b
    return sorted(set(picks))


def plans(shapes: list[str], out: str) -> None:
    import torch

    from mmlspark_tpu_torch.gbdt import hist_kernel as hk

    card = _card()
    dev = torch.cuda.current_device()
    sms = hk._num_sms(dev)
    with open(out or os.devnull, "w") as sink:
        for line in _plan_lines(shapes, card, dev, sms):
            print(line, flush=True)
            sink.write(line + "\n")
            sink.flush()


def _plan_lines(shapes: list[str], card: str, dev: int, sms: int):
    import torch

    import chip_smoke
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk

    for i, (name, n, f, dt, _, nb) in enumerate(chip_smoke.HIST_SHAPES):
        if nb <= 256 or (shapes and name not in shapes):
            continue
        bin_bytes = 4 if dt == torch.int32 else 1
        ranked = sorted(hk.wide_plans(n, f, nb, bin_bytes, sms, hk._resident_on(dev, bin_bytes)),
                        key=lambda cp: cp[0])
        chosen = hk.device_plan(n, f, nb, bin_bytes, dev)
        assert ranked[0][1] == chosen
        for frac in (1.0, 0.03):
            bins, stats = chip_smoke._hist_inputs(n, f, dt, frac, seed=100 + i, num_bins=nb)
            plain = hk.histogram_torch(bins, stats, nb)
            for rank in _spread(ranked):
                model_us, plan = ranked[rank]
                out_t = torch.empty((f, nb, 3), device="cuda")

                def run():
                    hk._launch(bins, stats, out_t, plan, dev)
                try:
                    run()
                except RuntimeError as e:         # a launch the card refuses
                    yield json.dumps({"plans": name, "rank": rank, "error": str(e),
                                      "plan": plan._asdict()})
                    continue
                first = out_t.clone()
                run()
                torch.cuda.synchronize()
                doc = {"plans": name, "rows_kept": frac, "rank": rank, "model_us": model_us,
                       "ms": None, "equal": torch.equal(first, plain),
                       "same_bits": torch.equal(first, out_t), "branch": plan.branch,
                       "plan": plan._asdict(), "sms": sms, "card": card,
                       "held": hk._resident_on(dev, bin_bytes)(plan.threads, plan.smem_bytes)}
                if doc["equal"] and doc["same_bits"]:
                    doc["ms"] = chip_smoke.median_ms(run)
                yield json.dumps(doc)
            del bins, stats, plain


def fit(files: list[str]) -> None:
    import numpy as np
    from scipy.optimize import nnls

    import chip_smoke
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk

    shapes = {name: (n, f, nb) for name, n, f, _, _, nb in chip_smoke.HIST_SHAPES}
    keys = list(hk._WIDE_US)
    rows = [json.loads(line) for path in files for line in open(path)]
    rows = [r for r in rows if r.get("ms")]
    terms = []
    for r in rows:
        n, f, nb = shapes[r["plans"]]
        plan = hk.LaunchPlan(**r["plan"])
        # the blocks an SM held of the plan's size, where the line has them
        held = (lambda *_, h=r["held"]: h) if "held" in r else hk.resident_blocks
        t = hk._wide_terms(n, f, nb, r["sms"], plan, kept=r["rows_kept"], resident=held)
        terms.append([t[k] for k in keys])
    x = np.array(terms)
    y = np.array([r["ms"] * 1e3 for r in rows])
    coef, _ = nnls(x / y[:, None], np.ones(len(y)))
    pred = x @ coef
    print(json.dumps({"fit": dict(zip(keys, np.round(coef, 4).tolist())),
                      "plans_timed": len(rows),
                      "median_relative_error": float(np.median(np.abs(pred / y - 1)))}))
    by = {}
    for r, p_us, ms in zip(rows, pred, y):
        by.setdefault((r["plans"], r["rows_kept"]), []).append((p_us, ms, r["plan"]))
    for (name, kept), v in by.items():
        pick, best = min(v, key=lambda t: t[0]), min(v, key=lambda t: t[1])
        print(json.dumps({"shape": name, "rows_kept": kept, "picked_us": pick[1],
                          "fastest_us": best[1], "fastest_plan": best[2]}))


# buckets of the share of rows a call keeps, for `mix`
_KEPT_EDGES = (0.0, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5, 1.0)


def _fit_shares(device: str) -> dict:
    """Each K1 call's share of rows kept over the fits above 256 bins, run
    as chip_smoke's phases run them (100 rounds of 31 leaves): per fit its
    (n, F, B, bin bytes) and the shares, in call order."""
    from unittest import mock

    import torch

    import chip_smoke
    from mmlspark_tpu_torch.gbdt import GBDTClassifier, engine
    from mmlspark_tpu_torch.gbdt.hist_kernel import histogram

    n, held = 32768, 8192
    x, y = chip_smoke.make_dataset(n + held, 14)
    na = chip_smoke.AMAZON_ROWS
    xa, ya = chip_smoke.make_amazon_access(na + held)
    fits = {"max_bin_16383": (x[:n], y[:n], dict(max_bin=16383)),
            "high_cardinality": (xa[:na], ya[:na], dict(
                categorical_slot_indexes=list(range(xa.shape[1])), max_bin=1023,
                bin_dtype="uint8"))}
    out = {}
    for name, (xf, yf, params) in fits.items():
        kept, shapes = [], set()

        def spy(bins, stats, num_bins):
            kept.append((stats != 0).any(dim=1).sum())      # no sync: read after the fit
            shapes.add((bins.shape[0], bins.shape[1], int(num_bins), bins.element_size()))
            return histogram(bins, stats, num_bins)

        with mock.patch.object(engine, "histogram", spy):
            GBDTClassifier(num_iterations=100, num_leaves=31, device=device,
                           **params).fit(chip_smoke._table(xf, yf))
        (shape,) = shapes
        out[name] = (shape, (torch.stack(kept).double().cpu() / shape[0]).tolist())
    return out


def mix(device: str, out: str) -> None:
    import numpy as np

    card = _card() if device == "cuda" else "cpu"
    lines = []
    for name, ((n, f, b, bin_bytes), shares) in _fit_shares(device).items():
        s = np.array(shares)
        which = np.clip(np.searchsorted(_KEPT_EDGES, s, side="left") - 1, 0,
                        len(_KEPT_EDGES) - 2)
        buckets = [{"from": _KEPT_EDGES[k], "to": _KEPT_EDGES[k + 1],
                    "calls": int((which == k).sum()), "mean_share": float(s[which == k].mean())}
                   for k in range(len(_KEPT_EDGES) - 1) if (which == k).any()]
        doc = {"mix": name, "device": device, "card": card, "n": n, "features": f, "bins": b,
               "bin_bytes": bin_bytes, "calls": len(s), "mean_share": float(s.mean()),
               "quantiles": {str(q): float(np.quantile(s, q))
                             for q in (0.1, 0.25, 0.5, 0.75, 0.9)},
               "buckets": buckets}
        lines.append(json.dumps(doc))
        print(lines[-1], flush=True)
        if device == "cuda":
            for line in _mix_plans(doc):
                lines.append(line)
                print(line, flush=True)
    if out:
        Path(out).write_text("".join(line + "\n" for line in lines))


def _mix_plans(doc: dict):
    """At a fit's shape, a spread of `wide_plans` (and the picked plan),
    each checked against histogram_torch and timed at each bucket's mean
    share: the mix's ms, the calls' weighted mean."""
    import torch

    import chip_smoke
    from mmlspark_tpu_torch.gbdt import hist_kernel as hk

    dev = torch.cuda.current_device()
    n, f, b, bb = doc["n"], doc["features"], doc["bins"], doc["bin_bytes"]
    dt = torch.int32 if bb == 4 else torch.uint8
    ranked = sorted(hk.wide_plans(n, f, b, bb, hk._num_sms(dev), hk._resident_on(dev, bb)),
                    key=lambda cp: cp[0])
    picked = hk.device_plan(n, f, b, bb, dev)
    assert ranked[0][1] == picked
    inputs = [chip_smoke._hist_inputs(n, f, dt, k["mean_share"], seed=300 + i, num_bins=b)
              for i, k in enumerate(doc["buckets"])]
    weights = [k["calls"] / doc["calls"] for k in doc["buckets"]]
    timed = []
    for rank in _spread(ranked):
        model_us, plan = ranked[rank]
        out_t = torch.empty((f, b, 3), device="cuda")
        ms = []
        for bins, stats in inputs:
            def run():
                hk._launch(bins, stats, out_t, plan, dev)
            run()
            torch.cuda.synchronize()
            assert torch.equal(out_t, hk.histogram_torch(bins, stats, b)), (doc["mix"], plan)
            ms.append(chip_smoke.median_ms(run))
        mix_ms = float(sum(w * m for w, m in zip(weights, ms)))
        timed.append((mix_ms, rank, plan))
        yield json.dumps({"mix_plan": doc["mix"], "rank": rank, "model_us": model_us,
                          "branch": plan.branch, "plan": plan._asdict(), "bucket_ms": ms,
                          "mix_ms": mix_ms, "card": doc["card"]})
    best = min(timed, key=lambda t: t[0])
    pick = next(t for t in timed if t[1] == 0)
    yield json.dumps({"mix_summary": doc["mix"], "picked_mix_ms": pick[0],
                      "fastest_mix_ms": best[0], "fastest_rank": best[1],
                      "fastest_plan": best[2]._asdict(), "plans_timed": len(timed),
                      "card": doc["card"]})


def split(trees: list[str]) -> None:
    card = _card()
    for tree in trees:
        print(json.dumps({"split": tree, "card": card, **_run(_SPLIT, tree, "SPLIT")}),
              flush=True)


def turns(trees: list[str], order: list[str]) -> None:
    named = dict(t.split("=", 1) for t in trees)
    card = _card()
    for turn, label in enumerate(order):
        doc = _run(_TURN, named[label], "TURN")
        print(json.dumps({"turn": turn, "tree": label, "card": card, **doc}), flush=True)
        print(f"turn {turn} {label}: " + ", ".join(
            f"{r['shape']} {r['ms']:.4f} ms" for r in doc["rows"][:6])
            + f"; enqueue {doc['adult_host_enqueue_us']:.1f} us/call"
            + f"; Adult fit {doc['adult_fit_seconds']:.3f} s"
            + f"; Higgs fit {doc['higgs_fit_seconds']:.3f} s", file=sys.stderr, flush=True)


def fits(trees: list[str], order: list[str]) -> None:
    named = dict(t.split("=", 1) for t in trees)
    card = _card()
    for turn, label in enumerate(order):
        doc = _run(_FITS, named[label], "FITS")
        print(json.dumps({"fits": turn, "tree": label, "card": card, **doc}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("ptxas")
    p.add_argument("trees", nargs="*")
    sub.add_parser("check")
    p = sub.add_parser("plans")
    p.add_argument("--shapes", default="")
    p.add_argument("--out", default="")
    p = sub.add_parser("mix")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default="")
    p = sub.add_parser("fit")
    p.add_argument("files", nargs="+")
    p = sub.add_parser("variants")
    p.add_argument("out")
    p.add_argument("names", nargs="+", choices=sorted(VARIANTS))
    p = sub.add_parser("time")
    p.add_argument("trees", nargs="+", metavar="NAME=TREE")
    p.add_argument("--shapes", default="")
    p = sub.add_parser("timeline")
    p.add_argument("tree")
    p = sub.add_parser("split")
    p.add_argument("trees", nargs="+")
    p = sub.add_parser("fits")
    p.add_argument("trees", nargs="+", metavar="NAME=TREE")
    p.add_argument("--order", required=True)
    p = sub.add_parser("turns")
    p.add_argument("trees", nargs="+", metavar="NAME=TREE")
    p.add_argument("--order", required=True)
    args = ap.parse_args()
    if args.cmd == "ptxas":
        ptxas(args.trees, "hist_kernel.cu")
    elif args.cmd == "check":
        check()
    elif args.cmd == "mix":
        mix(args.device, args.out)
    elif args.cmd == "fit":
        fit(args.files)
    elif args.cmd == "plans":
        plans([x for x in args.shapes.split(",") if x], args.out)
    elif args.cmd == "variants":
        variants(args.out, args.names)
    elif args.cmd == "time":
        time_trees(args.trees, [x for x in args.shapes.split(",") if x])
    elif args.cmd == "timeline":
        timeline(args.tree)
    elif args.cmd == "split":
        split(args.trees)
    elif args.cmd == "fits":
        fits(args.trees, args.order.split(","))
    else:
        turns(args.trees, args.order.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
