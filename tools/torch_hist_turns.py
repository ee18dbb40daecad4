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

Each result is one JSON line on stdout, with the card's name and power
limit. The TREEs are checkouts (for example a `git archive` of a parent
commit unpacked under build/); each builds into its own build/.
"""

from __future__ import annotations

import argparse
import json
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
    "ret_start": [(_CU, "    const Smem s = carve(smem_raw, p);\n",
                   "    const Smem s = carve(smem_raw, p);\n    if (p.n >= 0) return;\n")],
    "ret_after_zero": [(_CU, "make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n\n",
                        "make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n    __syncthreads();\n"
                        "    if (p.n >= 0) return;\n\n")],
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
        (_CU, "    const Smem s = carve(smem_raw, p);\n", "    const Smem s = carve(smem_raw, p);\n    stamp(0);\n"),
        (_CU, "    // the block's partial: its copies summed in copy order\n",
         "    stamp(1);\n    // the block's partial: its copies summed in copy order\n"),
        (_CU, "    cg::this_grid().sync();\n",
         "    stamp(2);\n    cg::this_grid().sync();\n    stamp(3);\n"),
        (_CU, "        p.out[lo + k] = sum;\n    }\n}\n",
         "        p.out[lo + k] = sum;\n    }\n    __syncthreads();\n    stamp(4);\n}\n"),
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
from mmlspark_tpu_torch.gbdt.hist_kernel import _lib, _num_sms, histogram, launch_plan
out = {}
for i, (name, n, f, dt, frac, nb) in enumerate(chip_smoke.HIST_SHAPES[:5]):
    bins, stats = chip_smoke._hist_inputs(n, f, dt, frac, seed=100 + i, num_bins=nb)
    plan = launch_plan(n, f, nb, bins.element_size(), _num_sms(0))
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
    from mmlspark_tpu_torch.gbdt.hist_kernel import (_num_sms, histogram, histogram_torch,
                                                     launch_plan)

    for i, (name, n, f, dt, frac, nb) in enumerate(chip_smoke.HIST_SHAPES):
        bins, stats = chip_smoke._hist_inputs(n, f, dt, frac, seed=100 + i, num_bins=nb)
        plan = launch_plan(n, f, nb, bins.element_size(), _num_sms(0))
        first, again = histogram(bins, stats, nb), histogram(bins, stats, nb)
        plain = histogram_torch(bins, stats, nb)
        torch.cuda.synchronize()
        print(json.dumps({"check": name, "branch": plan.branch,
                          "plan": plan._asdict(), "equal": torch.equal(first, plain),
                          "max_abs_err": (first - plain).abs().max().item(),
                          "same_bits": torch.equal(first, again)}), flush=True)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("ptxas")
    p.add_argument("trees", nargs="*")
    sub.add_parser("check")
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
    p = sub.add_parser("turns")
    p.add_argument("trees", nargs="+", metavar="NAME=TREE")
    p.add_argument("--order", required=True)
    args = ap.parse_args()
    if args.cmd == "ptxas":
        ptxas(args.trees, "hist_kernel.cu")
    elif args.cmd == "check":
        check()
    elif args.cmd == "variants":
        variants(args.out, args.names)
    elif args.cmd == "time":
        time_trees(args.trees, [x for x in args.shapes.split(",") if x])
    elif args.cmd == "timeline":
        timeline(args.tree)
    elif args.cmd == "split":
        split(args.trees)
    else:
        turns(args.trees, args.order.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
