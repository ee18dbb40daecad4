#!/usr/bin/env python3
"""K2 (the port's flash-attention kernel) on one NVIDIA GPU: compiler
report, a quick check against the plain version, and timings of two trees
in turns.

Run from the root of a checkout on a machine with a card:

    python3 tools/torch_flash_turns.py ptxas [TREE ...]
        nvcc -Xptxas -v of TREE's csrc/flash_attn.cu (default: this
        checkout) with the port's flags: registers, spills and static
        shared memory of every kernel, and any ptxas warning; and from
        cuobjdump -sass, each kernel's highest register and its local
        loads and stores.
    python3 tools/torch_flash_turns.py check
        one launch of K2 at each of chip_smoke.FLASH_SHAPES against
        flash_attention_torch, with chip_smoke's gates: path, errors.
    python3 tools/torch_flash_turns.py time NAME=TREE ... [--shapes A,B]
        K2's median ms at every shape of chip_smoke.FLASH_SHAPES and of
        TIME_SHAPES below (or only the named ones) for each tree, in a fresh process
        each, without any check: for variants of the kernel that are
        deliberately wrong (an ablation that drops one instruction class
        to see what bounds the kernel) or tuned differently.
    python3 tools/torch_flash_turns.py variants OUT NAME ...
        writes, for each NAME of VARIANTS below, a copy of this checkout's
        chip_smoke.py and mmlspark_tpu_torch/ to OUT/NAME with that
        variant's edits to csrc/flash_attn.cu (each edit must match once),
        for `time`: the ablations of the mma path ("no_exp": every ex2 an
        add; "no_mma": every mma.sync of the path an xor of its operands
        into the accumulator) and its tunings.
    python3 tools/torch_flash_turns.py turns NAME=TREE ... --order A,B,B,A
        for each name in --order, a fresh process that builds TREE's
        kernels and runs TREE's chip_smoke.flash_rows() (median ms of K2,
        the plain version and SDPA at each shape), the host microseconds
        of one K2 call at a small shape (B 1, T 128, H 1, D 64, bf16),
        where the launch overhead, not the device, sets the time, and
        the seconds and tokens/s of serving chip_smoke's 1,024 x 512
        tokens through the f32 flash transformer, through the bf16
        transformer at TransformerEncoder's default width (this
        checkout's chip_smoke.SMALL_TRANSFORMERS["d16"], head dim 16, in
        its chip_smoke.SMALL_PASSES passes: all tokens over all seconds,
        with the rate's standard error) and through the tree's own
        serve_wide transformer (chip_smoke.WIDE_TRANSFORMER, head dim 192,
        minibatch chip_smoke.WIDE_BATCH, WIDE_PASSES passes) in bf16 and
        in f32, with TREE's own package (K2's launches and path beside
        them). Compare two versions only inside one such call.
    python3 tools/torch_flash_turns.py rows --shapes A,B --rows R1,R2
        K2's median ms at the named chip_smoke.FLASH_SHAPES with
        flash_plan's query rows a block or work item replaced by each of
        R1, R2 in turns (R1, R2, R2, R1) in one process, each launch first
        checked against the plain version: the wgmma path's 64-row items
        against 128-row ones, or the wide path's row groups.
    python3 tools/torch_flash_turns.py serve NAME=TREE ... --order A,B,B,A,...
        for each name in --order, a fresh process that serves TREE's
        chip_smoke serve_wide transformer (head dim 192, minibatch
        chip_smoke.WIDE_BATCH, 1,024 x 512 tokens) in bf16 and in f32,
        WIDE_PASSES timed passes each, after one host-microseconds
        measurement of a K2 call at that shape (B 4, T 512, H 4, D 192) in
        each dtype: the end-to-end rates with nothing else in the process,
        for many alternations in one call.
    python3 tools/torch_flash_turns.py mma_rate
        the issue rate of mma.sync on the card, from tools/mma_rate.cu:
        m16n8k8 TF32 alone, as three products into one accumulator
        (3xTF32), with the operands split every time, with B loaded from
        shared memory, and m16n8k16 bf16 for scale; each with 1, 4 and 8
        independent accumulators a warp, at 16 and 32 warps an SM (the
        tf32x3 kernel runs 16 at D = 64). TFLOP/s counts 2 m n k per mma.
        Then the issue rate of ex2.approx.f32 ("ex2", exponentials a
        second and a second an SM) with 1, 4 and 8 chains a thread.

Each result is one JSON line on stdout, with the card's name and power
limit. The TREEs are checkouts (for example a `git archive` of a parent
commit unpacked under build/); each builds into its own build/.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# run inside each turn's process, from the tree's root
_TURN = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke
import mmlspark_tpu_torch  # noqa: F401
from mmlspark_tpu_torch.core import kernels
from mmlspark_tpu_torch.nn.attention import _flash_fwd_lse
kernels.build()
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn((1, 128, 1, 64), generator=g, device="cuda").to(torch.bfloat16)
           for _ in range(3))
with torch.no_grad():
    for _ in range(20):
        _flash_fwd_lse(q, k, v)
    host_us = chip_smoke.host_us_per_call(lambda: _flash_fwd_lse(q, k, v), reps=2000)
rows = chip_smoke.flash_rows()

# f32 flash serving of chip_smoke's slice: warm-up on one minibatch, then
# all rows, timed
import numpy as np
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.nn import ModelBundle
from mmlspark_tpu_torch.nn.attention import flash_attention
bundle = ModelBundle.init("transformer", (chip_smoke.SLICE_TOKENS,), seed=0,
                          attention_impl="flash", dtype="float32",
                          **chip_smoke.SLICE_TRANSFORMER)
x = np.random.default_rng(11).integers(0, chip_smoke.SLICE_TRANSFORMER["vocab_size"],
                                       size=(chip_smoke.SLICE_ROWS, chip_smoke.SLICE_TOKENS))
stage, _ = chip_smoke._serve(bundle, x[:chip_smoke.SLICE_BATCH], "cuda", chip_smoke.SLICE_BATCH)
torch.cuda.synchronize()
flash_attention.launches = 0
t0 = time.perf_counter()
logits = np.asarray(stage.transform(Table({"tokens": x}))["logits"])
serve_s = time.perf_counter() - t0
assert np.isfinite(logits).all()
serve = {"seconds": serve_s, "tokens_per_s": x.size / serve_s,
         "launches": flash_attention.launches, "path": flash_attention.last_path}

# the bf16 transformer at TransformerEncoder's default width (head dim 16),
# its config and number of passes passed in by the caller: 1,024 x 512
# tokens a pass, the rate of all passes' tokens over all their seconds
cfg, passes = json.loads(sys.argv[1]), int(sys.argv[2])
bundle16 = ModelBundle.init("transformer", (chip_smoke.SLICE_TOKENS,), seed=0,
                            attention_impl="flash", dtype="bfloat16", **cfg)
x16 = np.random.default_rng(11).integers(0, cfg["vocab_size"],
                                         size=(chip_smoke.SLICE_ROWS, chip_smoke.SLICE_TOKENS))
stage16, _ = chip_smoke._serve(bundle16, x16[:chip_smoke.SLICE_BATCH], "cuda",
                               chip_smoke.SLICE_BATCH)
seconds16 = []
for _ in range(passes):
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    logits16 = np.asarray(stage16.transform(Table({"tokens": x16}))["logits"])
    seconds16.append(time.perf_counter() - t0)
    assert np.isfinite(logits16).all()
s16 = np.asarray(seconds16)
serve16 = {"passes": passes, "tokens_per_s": x16.size * passes / s16.sum(),
           "pass_seconds_min": s16.min(), "pass_seconds_median": float(np.median(s16)),
           "pass_seconds_max": s16.max(),
           "rate_rel_stderr": s16.std(ddof=1) / np.sqrt(passes) / s16.mean(),
           "launches": flash_attention.launches, "path": flash_attention.last_path}

# the tree's serve_wide transformer (head dim 192), bf16 and f32, at its
# minibatch and passes
wide = {}
bundle_w = ModelBundle.init("transformer", (chip_smoke.SLICE_TOKENS,), seed=0,
                            attention_impl="flash", dtype="bfloat16",
                            **chip_smoke.WIDE_TRANSFORMER)
xw = np.random.default_rng(12).integers(0, chip_smoke.WIDE_TRANSFORMER["vocab_size"],
                                        size=(chip_smoke.SLICE_ROWS, chip_smoke.SLICE_TOKENS))
for dtype in ("bfloat16", "float32"):
    bw = bundle_w if dtype == "bfloat16" else chip_smoke._variant(bundle_w, dtype="float32")
    stage_w, _ = chip_smoke._serve(bw, xw[:chip_smoke.WIDE_BATCH], "cuda", chip_smoke.WIDE_BATCH)
    seconds_w = []
    for _ in range(chip_smoke.WIDE_PASSES):
        torch.cuda.synchronize()
        flash_attention.launches = 0
        flash_attention.launches_by_path = {}
        t0 = time.perf_counter()
        logits_w = np.asarray(stage_w.transform(Table({"tokens": xw}))["logits"])
        seconds_w.append(time.perf_counter() - t0)
        assert np.isfinite(logits_w).all()
    wide[dtype] = {**chip_smoke.pass_rate(seconds_w, xw.size),
                   "launches_by_path": dict(flash_attention.launches_by_path)}
print("TURN " + json.dumps({"rows": rows, "host_us_small": host_us, "f32_serving": serve,
                            "bf16_d16_serving": serve16, "wide_serving": wide}), flush=True)
"""


_TIME = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke
import mmlspark_tpu_torch  # noqa: F401
from mmlspark_tpu_torch.core import kernels
from mmlspark_tpu_torch.nn.attention import _flash_fwd_lse
kernels.build()
only = set(json.loads(sys.argv[1]))
extra = [(n, b, tq, tk, h, d, getattr(torch, dt), c) for n, b, tq, tk, h, d, dt, c
         in json.loads(sys.argv[2])]
ms = {}
with torch.no_grad():
    for i, (name, b, tq, tk, h, d, dt, causal) in enumerate(chip_smoke.FLASH_SHAPES + extra):
        if only and name not in only:
            continue
        q, k, v = chip_smoke._flash_inputs(name, b, tq, tk, h, d, dt, seed=200 + i)
        ms[name] = chip_smoke.median_ms(lambda: _flash_fwd_lse(q, k, v, causal))
print("TIME " + json.dumps(ms), flush=True)
"""


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def ptxas(trees: list[str], source: str = "flash_attn.cu") -> None:
    sys.path.insert(0, str(ROOT))
    from mmlspark_tpu_torch.core import kernels

    failed = 0
    for tree in trees or [str(ROOT)]:
        src = Path(tree) / "mmlspark_tpu_torch" / "csrc" / source
        with tempfile.TemporaryDirectory() as tmp:
            lib = Path(tmp) / "lib.so"
            proc = subprocess.run(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                 str(src)], capture_output=True, text=True)
            sass = _sass_summary(Path(kernels._nvcc()).parent / "cuobjdump", lib) \
                if proc.returncode == 0 else {}
        out = proc.stdout + proc.stderr
        report, name = {}, None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = _demangle(m.group(1))
                report[name] = {}
            elif name and "Used" in line:
                m = re.search(r"Used (\d+) registers", line)
                report[name]["registers"] = int(m.group(1)) if m else None
                m = re.search(r"(\d+) bytes smem", line)
                report[name]["static_smem_bytes"] = int(m.group(1)) if m else 0
            elif name and "spill" in line:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    report[name]["spill_store_bytes"] = int(m.group(1))
                    report[name]["spill_load_bytes"] = int(m.group(2))
        # ptxas warnings, and its coded notes such as C7519 (a warpgroup
        # fence it had to add before a wgmma)
        warnings = sorted({line.strip() for line in out.splitlines()
                           if "warning" in line.lower() or re.search(r"\(C\d{4}\)", line)})
        for name, info in report.items():
            info.update(sass.get(name, {}))
        print(json.dumps({"ptxas": str(src), "nvcc_exit": proc.returncode,
                          "kernels": report, "warnings": warnings}), flush=True)
        if proc.returncode:
            print(out, file=sys.stderr)
            failed = proc.returncode
    if failed:
        raise SystemExit(failed)


def _sass_summary(cuobjdump: Path, lib: Path) -> dict:
    """Per kernel, from its SASS: the highest register number any
    instruction names (what a thread really uses, setmaxnreg regions
    included), the local-memory loads and stores (spill traffic), and the
    shared-memory atomics by opcode."""
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    summary, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _demangle(m.group(1))
            summary[name] = {"sass_max_register": -1, "sass_local_loads": 0,
                             "sass_local_stores": 0}
        elif name:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            if regs:
                summary[name]["sass_max_register"] = max(summary[name]["sass_max_register"],
                                                         max(regs))
            summary[name]["sass_local_loads"] += bool(re.search(r"\bLDL\b", line))
            summary[name]["sass_local_stores"] += bool(re.search(r"\bSTL\b", line))
            atom = re.search(r"\b(ATOMS\.[\w.]+)", line)
            if atom:
                ops = summary[name].setdefault("sass_shared_atomics", {})
                ops[atom.group(1)] = ops.get(atom.group(1), 0) + 1
    return summary


def _demangle(name: str) -> str:
    try:
        return subprocess.run(["c++filt", name], capture_output=True, text=True,
                              timeout=30).stdout.strip() or name
    except OSError:
        return name


def check() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from mmlspark_tpu_torch.nn.attention import (_flash_fwd_lse, flash_attention,
                                                 flash_attention_torch)

    for i, (name, b, tq, tk, h, d, dt, causal) in enumerate(chip_smoke.FLASH_SHAPES):
        q, k, v = chip_smoke._flash_inputs(name, b, tq, tk, h, d, dt, seed=200 + i)
        with torch.no_grad():
            out, lse = _flash_fwd_lse(q, k, v, causal)
            path = flash_attention.last_path
            ref, ref_lse = flash_attention_torch(q, k, v, causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        fin = torch.isfinite(ref_lse)
        atol, rtol = chip_smoke.FLASH_TOL[dt]
        ok_out = bool(torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol))
        ok_lse = bool(torch.equal(torch.isinf(lse), torch.isinf(ref_lse))
                      and torch.allclose(lse[fin], ref_lse[fin], atol=2e-5, rtol=1e-5))
        print(json.dumps({
            "check": name, "path": path, "want_path": chip_smoke.flash_path(dt, d),
            "max_abs_err": err.max().item() if err.numel() else 0.0,
            "lse_max_abs_err": (lse[fin] - ref_lse[fin]).abs().max().item() if fin.any() else 0.0,
            "out_ok": ok_out, "lse_ok": ok_lse}), flush=True)


def turns(trees: list[str], order: list[str]) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    named = dict(t.split("=", 1) for t in trees)
    card = _card()
    small = json.dumps(chip_smoke.SMALL_TRANSFORMERS["d16"])
    for turn, label in enumerate(order):
        proc = subprocess.run([sys.executable, "-c", _TURN, small, str(chip_smoke.SMALL_PASSES)],
                              cwd=named[label],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"turn {turn} ({label}) failed with exit {proc.returncode}")
        doc = json.loads(next(line for line in proc.stdout.splitlines()
                              if line.startswith("TURN "))[5:])
        print(json.dumps({"turn": turn, "tree": label, "card": card, **doc}), flush=True)
        print(f"turn {turn} {label}: " + ", ".join(
            f"{r['shape']} {r['ms']:.4f} ms" for r in doc["rows"])
            + f"; host {doc['host_us_small']:.1f} us/call"
            + f"; f32 serving {doc['f32_serving']['tokens_per_s']:.0f} tokens/s"
            + f"; bf16 d16 serving {doc['bf16_d16_serving']['tokens_per_s']:.0f} tokens/s"
            + f" (standard error {100 * doc['bf16_d16_serving']['rate_rel_stderr']:.2f}%)"
            + "".join(f"; wide {dt} serving {w['tokens_per_s']:.0f} tokens/s"
                      for dt, w in doc["wide_serving"].items()),
            file=sys.stderr, flush=True)


_SERVE = r"""
import json, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke
import mmlspark_tpu_torch  # noqa: F401
from mmlspark_tpu_torch.core import Table, kernels
from mmlspark_tpu_torch.nn import ModelBundle
from mmlspark_tpu_torch.nn.attention import _flash_fwd_lse, flash_attention
kernels.build()
host_us = {}
with torch.no_grad():
    for dt in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((chip_smoke.WIDE_BATCH, chip_smoke.SLICE_TOKENS, 4, 192),
                               generator=g, device="cuda").to(dt) for _ in range(3))
        for _ in range(20):
            _flash_fwd_lse(q, k, v)
        host_us[str(dt).replace("torch.", "")] = chip_smoke.host_us_per_call(
            lambda: _flash_fwd_lse(q, k, v), reps=500)
bundle = ModelBundle.init("transformer", (chip_smoke.SLICE_TOKENS,), seed=0,
                          attention_impl="flash", dtype="bfloat16", **chip_smoke.WIDE_TRANSFORMER)
x = np.random.default_rng(12).integers(0, chip_smoke.WIDE_TRANSFORMER["vocab_size"],
                                       size=(chip_smoke.SLICE_ROWS, chip_smoke.SLICE_TOKENS))
out = {}
for dtype in ("bfloat16", "float32"):
    b = bundle if dtype == "bfloat16" else chip_smoke._variant(bundle, dtype="float32")
    stage, _ = chip_smoke._serve(b, x[:chip_smoke.WIDE_BATCH], "cuda", chip_smoke.WIDE_BATCH)
    seconds = []
    for _ in range(chip_smoke.WIDE_PASSES):
        torch.cuda.synchronize()
        flash_attention.launches_by_path = {}
        t0 = time.perf_counter()
        logits = np.asarray(stage.transform(Table({"tokens": x}))["logits"])
        seconds.append(time.perf_counter() - t0)
        assert np.isfinite(logits).all()
    out[dtype] = {**chip_smoke.pass_rate(seconds, x.size),
                  "launches_by_path": dict(flash_attention.launches_by_path)}
print("SERVE " + json.dumps({"host_us_d192": host_us, "wide_serving": out}), flush=True)
"""


def serve_turns(trees: list[str], order: list[str]) -> None:
    named = dict(t.split("=", 1) for t in trees)
    card = _card()
    for turn, label in enumerate(order):
        proc = subprocess.run([sys.executable, "-c", _SERVE], cwd=named[label],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"serve turn {turn} ({label}) failed with exit {proc.returncode}")
        doc = json.loads(next(line for line in proc.stdout.splitlines()
                              if line.startswith("SERVE "))[6:])
        print(json.dumps({"turn": turn, "tree": label, "card": card, **doc}), flush=True)
        print(f"serve {turn} {label}: " + "; ".join(
            f"{dt} {w['tokens_per_s']:.0f} tokens/s, K2 host {doc['host_us_d192'][dt]:.1f} us"
            for dt, w in doc["wide_serving"].items()), file=sys.stderr, flush=True)


# timed by `time` and `rows` beside chip_smoke.FLASH_SHAPES, (name, B, Tq,
# Tk, H, D, dtype, causal): the mma path at D = 32 in 8-warp blocks
# (d_model 128, 4 heads, at the serving rows and tokens), which no model of
# the repo serves; wgmma at D = 256 with 128-row items (256 of them)
TIME_SHAPES = [("serve_d32_bf16", 64, 512, 512, 4, 32, "bfloat16", False),
               ("d256_b16_bf16", 16, 512, 512, 4, 256, "bfloat16", False)]


def time_trees(trees: list[str], shapes: list[str]) -> None:
    card = _card()
    for label, tree in (t.split("=", 1) for t in trees):
        proc = subprocess.run([sys.executable, "-c", _TIME, json.dumps(shapes),
                               json.dumps(TIME_SHAPES)], cwd=tree, capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"{label} failed with exit {proc.returncode}")
        doc = json.loads(next(line for line in proc.stdout.splitlines()
                              if line.startswith("TIME "))[5:])
        print(json.dumps({"tree": label, "card": card, "ms": doc}), flush=True)


def rows_turns(shapes: list[str], rows: list[int]) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from mmlspark_tpu_torch.nn import attention as att

    card = _card()
    plan = att.flash_plan
    extra = [(n, b, tq, tk, h, d, getattr(torch, dt), c)
             for n, b, tq, tk, h, d, dt, c in TIME_SHAPES]
    picked = [(i, s) for i, s in enumerate(chip_smoke.FLASH_SHAPES + extra) if s[0] in shapes]
    inputs = {s[0]: chip_smoke._flash_inputs(s[0], *s[1:7], seed=200 + i) for i, s in picked}
    order = rows + rows[::-1]
    ms = {}
    try:
        with torch.no_grad():
            for turn, r in enumerate(order):
                att.flash_plan = lambda *a, r=r: plan(*a)._replace(rows=r)
                for _, (name, b, tq, tk, h, d, dt, causal) in picked:
                    q, k, v = inputs[name]
                    out, lse = att._flash_fwd_lse(q, k, v, causal)
                    ref, ref_lse = att.flash_attention_torch(q, k, v, causal)
                    atol, rtol = chip_smoke.FLASH_TOL[dt]
                    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
                    fin = torch.isfinite(ref_lse)
                    torch.testing.assert_close(lse[fin], ref_lse[fin], atol=2e-5, rtol=1e-5)
                    ms.setdefault(name, {}).setdefault(str(r), []).append(
                        chip_smoke.median_ms(lambda: att._flash_fwd_lse(q, k, v, causal)))
                    print(json.dumps({"turn": turn, "shape": name, "rows": r,
                                      "path": att.flash_attention.last_path,
                                      "ms": ms[name][str(r)][-1], "card": card}), flush=True)
    finally:
        att.flash_plan = plan
    print(json.dumps({"rows_summary": ms, "order": order, "card": card}), flush=True)


_MMA_MODES = {"tf32": (0, 1), "chain3": (1, 3), "split3": (2, 3), "split3_lds": (3, 3),
              "bf16": (4, 1), "ex2": (5, 1)}
# name: (mode, mma (or ex2 a thread) a warp per accumulator and iteration)


def mma_rate(iters: int = 4096) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke

    card = _card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = chip_smoke.rate_lib()
    threads = 256                                   # eight warps a block
    for warps_per_sm in (16, 32):
        blocks = sms * warps_per_sm // 8
        sink = torch.empty(blocks * threads, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for name, (mode, per_acc) in _MMA_MODES.items():
            for acc in (1, 4, 8):
                def run():
                    err = lib.mma_rate(mode, acc, blocks, threads, iters, sink.data_ptr(),
                                       stream)
                    if err:
                        raise RuntimeError(f"mma_rate {name} acc {acc}: cudaError {err}")
                ms = chip_smoke.median_ms(run, reps=10, warmup=2)
                doc = {"mma_rate": name, "accumulators": acc, "warps_per_sm": warps_per_sm,
                       "card": card, "ms": ms}
                if name == "ex2":
                    ex2 = blocks * threads * iters * acc
                    doc.update(ex2_per_s=ex2 / (ms * 1e-3), ex2_per_s_per_sm=ex2 / (ms * 1e-3) / sms)
                else:
                    mmas = blocks * (threads // 32) * iters * acc * per_acc
                    flops = mmas * 2 * 16 * 8 * (16 if name == "bf16" else 8)
                    doc.update(tflops=flops / (ms * 1e-3) / 1e12,
                               f32_accurate_tflops=flops / (ms * 1e-3) / 1e12 / 3
                               if per_acc == 3 else None)
                print(json.dumps(doc), flush=True)


# Edits of csrc/flash_attn.cu, each (old, new) matching once: the mma
# path's ablations, which are wrong on purpose and only timed, and its
# tunings
_EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
_MMA_K16 = '''    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
_MMA_K8 = '''    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(b0));'''
_X = "fmaf(s[i], scale_log2, -m_new[r])"          # softmax_tile's exponent of a score
_P_LINE = f"s[i] = keep(i) ? exp2_approx({_X}) : 0.0f;"
_POLY = ("__device__ __forceinline__ float exp2_approx(float x) {", """\
__device__ __forceinline__ float exp2_poly(float x) {
    x = fmaxf(x, -125.0f);
    const float t = x + 12582912.0f;
    const float f = x - (t - 12582912.0f);
    float p = 0.00129156734328717f;
    p = fmaf(p, f, 0.009668530896306038f);
    p = fmaf(p, f, 0.055516887456178665f);
    p = fmaf(p, f, 0.24022264778614044f);
    p = fmaf(p, f, 0.6931464672088623f);
    p = fmaf(p, f, 1.0f);
    return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

__device__ __forceinline__ float exp2_approx(float x) {""")
VARIANTS = {
    # every exponential an add (1 when the max did not move, as ex2 gives)
    "no_exp": [(_EX2, "y = x + 1.0f;")],
    # no tensor-core products: each mma.sync of the path xors its operands
    # into one accumulator register, so the fragment loads and the bf16
    # packs stay live
    "no_mma": [(_MMA_K16, "    c[0] = __uint_as_float(__float_as_uint(c[0]) ^ a[0] ^ a[1] ^ "
                          "a[2] ^ a[3] ^ b0 ^ b1);"),
               (_MMA_K8, "    c[0] = __uint_as_float(__float_as_uint(c[0]) ^ a0 ^ a1 ^ b0);")],
    # a share of the exponentials on the FMA pipe: 2^x as 2^n 2^f, n the
    # nearest integer, 2^f a degree-5 polynomial on [-0.5, 0.5] (relative
    # error 3.4e-7), for every 4th or 8th score of a thread
    "poly4": [_POLY, (_P_LINE, _P_LINE.replace(f"exp2_approx({_X})", f"(i % 4 == 0 ? "
                                               f"exp2_poly({_X}) : exp2_approx({_X}))"))],
    "poly8": [_POLY, (_P_LINE, _P_LINE.replace(f"exp2_approx({_X})", f"(i % 8 == 0 ? "
                                               f"exp2_poly({_X}) : exp2_approx({_X}))"))],
    # at D = 32 the register cap lifted from 128 to 255 in 8-warp blocks
    # too (half the blocks an SM guaranteed), so nothing spills there
    "d32_regs_w8": [("D == 32 && W == 2 ? 4 : 16 / W;", "D == 32 ? 8 / W : 16 / W;")],
    # wgmma with two consumer warpgroups at D = 192: tile j's PV product
    # in flight beside tile j + 1's S product, as below
    "overlap_w2": [("static constexpr bool kOverlap = !(W == 2 && D > 128);",
                    "static constexpr bool kOverlap = true;")],
    # the wgmma kernel's warp index straight from threadIdx, not through a
    # shuffle
    "warp_noshfl": [("const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 32), 0);",
                     "const int warp = threadIdx.x / 32;")],
}


def variants(out: str, names: list[str]) -> None:
    src_rel = Path("mmlspark_tpu_torch") / "csrc" / "flash_attn.cu"
    for name in names:
        tree = Path(out) / name
        shutil.rmtree(tree, ignore_errors=True)
        tree.mkdir(parents=True)
        shutil.copy2(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
        shutil.copytree(ROOT / "mmlspark_tpu_torch", tree / "mmlspark_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__", "_build"))
        src = (tree / src_rel).read_text()
        for old, new in VARIANTS[name]:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: an edit matches {src.count(old)} times")
            src = src.replace(old, new)
        (tree / src_rel).write_text(src)
        print(json.dumps({"variant": name, "tree": str(tree), "edits": len(VARIANTS[name])}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("ptxas")
    p.add_argument("trees", nargs="*")
    sub.add_parser("check")
    sub.add_parser("mma_rate")
    p = sub.add_parser("rows")
    p.add_argument("--shapes", required=True)
    p.add_argument("--rows", required=True)
    p = sub.add_parser("time")
    p.add_argument("trees", nargs="+", metavar="NAME=TREE")
    p.add_argument("--shapes", default="")
    p = sub.add_parser("variants")
    p.add_argument("out")
    p.add_argument("names", nargs="+", choices=sorted(VARIANTS))
    for name in ("turns", "serve"):
        p = sub.add_parser(name)
        p.add_argument("trees", nargs="+", metavar="NAME=TREE")
        p.add_argument("--order", required=True)
    args = ap.parse_args()
    if args.cmd == "ptxas":
        ptxas(args.trees)
    elif args.cmd == "check":
        check()
    elif args.cmd == "time":
        time_trees(args.trees, [s for s in args.shapes.split(",") if s])
    elif args.cmd == "variants":
        variants(args.out, args.names)
    elif args.cmd == "mma_rate":
        mma_rate()
    elif args.cmd == "serve":
        serve_turns(args.trees, args.order.split(","))
    elif args.cmd == "rows":
        rows_turns(args.shapes.split(","), [int(r) for r in args.rows.split(",")])
    else:
        turns(args.trees, args.order.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
