"""Readings that the output check's limits are set from; the benchmark's
own runs never run this.

    python perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--calls N] [--out path.json]

For each of `--seeds` it makes the cell's inputs, makes `--calls` calls of
the timed path at the cell's own size and reads the compared numbers
(the program's readings, whose largest sets the lower end of each
limit). For each of `--control-seeds` it puts the reference, computed one
precision step below the configuration's, in the program's place (the
traffic module's `control`) and reads the same numbers (the upper end). One
process, so the set-up is paid once a seed."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def readings(cell: str, seed: int, calls: int, control: bool, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    import torch

    spec, config, traffic = harness.cell_files(cell, overrides=overrides)
    if "check_every" in traffic:
        traffic["check_every"] = 1       # every call's outputs are compared
    drv = harness.load_module(harness.PB / "traffic" / f"{traffic['driver']}.py").Driver(
        config, traffic, seed, device)
    t0 = time.perf_counter()
    drv.setup(warm=False)
    for i in range(calls):
        drv.call(i)
    drv.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = drv.control() if control else drv.check()
    return {"cell": cell, "seed": seed, "control": control,
            "seconds": time.perf_counter() - t0,
            **{k: (float(v) if isinstance(v, (int, float)) else v) for k, v in numbers.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args()
    rows = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            rows.append(readings(args.workload, int(s), args.calls, control))
            print(json.dumps(rows[-1], default=str), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
