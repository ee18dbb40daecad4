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
    python3 tools/torch_flash_turns.py time NAME=TREE ...
        K2's median ms at every shape of chip_smoke.FLASH_SHAPES (bf16 and
        f32) for each tree, in a fresh process each, without any check:
        for variants of the kernel that are deliberately wrong (an
        ablation that drops one instruction class to see what bounds the
        kernel) or tuned differently.
    python3 tools/torch_flash_turns.py turns NAME=TREE ... --order A,B,B,A
        for each name in --order, a fresh process that builds TREE's
        kernels and runs TREE's chip_smoke.flash_rows() (median ms of K2,
        the plain version and SDPA at each shape), the host microseconds
        of one K2 call at a small shape (B 1, T 128, H 1, D 64, bf16),
        where the launch overhead, not the device, sets the time, and
        the seconds and tokens/s of serving chip_smoke's 1,024 x 512
        tokens through the f32 flash transformer with TREE's own package
        (K2's launches and path beside them). Compare two versions only
        inside one such call.
    python3 tools/torch_flash_turns.py mma_rate
        the issue rate of mma.sync on the card, from tools/mma_rate.cu:
        m16n8k8 TF32 alone, as three products into one accumulator
        (3xTF32), with the operands split every time, with B loaded from
        shared memory, and m16n8k16 bf16 for scale; each with 1, 4 and 8
        independent accumulators a warp, at 16 and 32 warps an SM (the
        tf32x3 kernel runs 16 at D = 64). TFLOP/s counts 2 m n k per mma.

Each result is one JSON line on stdout, with the card's name and power
limit. The TREEs are checkouts (for example a `git archive` of a parent
commit unpacked under build/); each builds into its own build/.
"""

from __future__ import annotations

import argparse
import json
import re
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
print("TURN " + json.dumps({"rows": rows, "host_us_small": host_us, "f32_serving": serve}),
      flush=True)
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
ms = {}
with torch.no_grad():
    for i, (name, b, tq, tk, h, d, dt, causal) in enumerate(chip_smoke.FLASH_SHAPES):
        q, k, v = chip_smoke._flash_inputs(name, b, tq, tk, h, d, dt, seed=200 + i)
        ms[name] = chip_smoke.median_ms(lambda: _flash_fwd_lse(q, k, v, causal))
print("TIME " + json.dumps(ms), flush=True)
"""


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def ptxas(trees: list[str]) -> None:
    sys.path.insert(0, str(ROOT))
    from mmlspark_tpu_torch.core import kernels

    for tree in trees or [str(ROOT)]:
        src = Path(tree) / "mmlspark_tpu_torch" / "csrc" / "flash_attn.cu"
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
            raise SystemExit(proc.returncode)


def _sass_summary(cuobjdump: Path, lib: Path) -> dict:
    """Per kernel, from its SASS: the highest register number any
    instruction names (what a thread really uses, setmaxnreg regions
    included) and the local-memory loads and stores (spill traffic)."""
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
    named = dict(t.split("=", 1) for t in trees)
    card = _card()
    for turn, label in enumerate(order):
        proc = subprocess.run([sys.executable, "-c", _TURN], cwd=named[label],
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
            + f"; f32 serving {doc['f32_serving']['tokens_per_s']:.0f} tokens/s",
            file=sys.stderr, flush=True)


def time_trees(trees: list[str]) -> None:
    card = _card()
    for label, tree in (t.split("=", 1) for t in trees):
        proc = subprocess.run([sys.executable, "-c", _TIME], cwd=tree, capture_output=True,
                              text=True)
        if proc.returncode:
            print(proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"{label} failed with exit {proc.returncode}")
        doc = json.loads(next(line for line in proc.stdout.splitlines()
                              if line.startswith("TIME "))[5:])
        print(json.dumps({"tree": label, "card": card, "ms": doc}), flush=True)


_MMA_MODES = {"tf32": (0, 1), "chain3": (1, 3), "split3": (2, 3), "split3_lds": (3, 3),
              "bf16": (4, 1)}     # name: (mode, mma a warp per accumulator and iteration)


def mma_rate(iters: int = 4096) -> None:
    import ctypes

    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from mmlspark_tpu_torch.core import kernels

    card = _card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "libmma_rate.so"
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib_path),
                        str(ROOT / "tools" / "mma_rate.cu")], check=True)
        lib = ctypes.CDLL(str(lib_path))
    threads = 256                                   # eight warps a block
    for warps_per_sm in (16, 32):
        blocks = sms * warps_per_sm // 8
        sink = torch.empty(blocks * threads, device="cuda")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for name, (mode, per_acc) in _MMA_MODES.items():
            for acc in (1, 4, 8):
                def run():
                    err = lib.mma_rate(mode, acc, blocks, threads, iters,
                                       ctypes.c_void_p(sink.data_ptr()), stream)
                    if err:
                        raise RuntimeError(f"mma_rate {name} acc {acc}: cudaError {err}")
                ms = chip_smoke.median_ms(run, reps=10, warmup=2)
                mmas = blocks * (threads // 32) * iters * acc * per_acc
                flops = mmas * 2 * 16 * 8 * (16 if name == "bf16" else 8)
                print(json.dumps({
                    "mma_rate": name, "accumulators": acc, "warps_per_sm": warps_per_sm,
                    "card": card, "ms": ms, "tflops": flops / (ms * 1e-3) / 1e12,
                    "f32_accurate_tflops": flops / (ms * 1e-3) / 1e12 / 3 if per_acc == 3
                    else None}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("ptxas")
    p.add_argument("trees", nargs="*")
    sub.add_parser("check")
    sub.add_parser("mma_rate")
    p = sub.add_parser("time")
    p.add_argument("trees", nargs="+", metavar="NAME=TREE")
    p = sub.add_parser("turns")
    p.add_argument("trees", nargs="+", metavar="NAME=TREE")
    p.add_argument("--order", required=True)
    args = ap.parse_args()
    if args.cmd == "ptxas":
        ptxas(args.trees)
    elif args.cmd == "check":
        check()
    elif args.cmd == "time":
        time_trees(args.trees)
    elif args.cmd == "mma_rate":
        mma_rate()
    else:
        turns(args.trees, args.order.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
