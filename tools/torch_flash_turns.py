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
        K2's median ms at the bf16 shapes of chip_smoke.FLASH_SHAPES for
        each tree, in a fresh process each, without any check: for
        variants of the kernel that are deliberately wrong (an ablation
        that drops one instruction class to see what bounds the kernel).
    python3 tools/torch_flash_turns.py turns NAME=TREE ... --order A,B,B,A
        for each name in --order, a fresh process that builds TREE's
        kernels and runs TREE's chip_smoke.flash_rows() (median ms of K2,
        the plain version and SDPA at each shape), plus the host
        microseconds of one K2 call at a small shape (B 1, T 128, H 1,
        D 64, bf16), where the launch overhead, not the device, sets the
        time. Compare two versions only inside one such call.

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
print("TURN " + json.dumps({"rows": rows, "host_us_small": host_us}), flush=True)
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
        if dt == torch.bfloat16:
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
            + f"; host {doc['host_us_small']:.1f} us/call", file=sys.stderr, flush=True)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("ptxas")
    p.add_argument("trees", nargs="*")
    sub.add_parser("check")
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
    else:
        turns(args.trees, args.order.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
