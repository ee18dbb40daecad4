"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, and prints no result, without a CUDA card (or with fewer
than the cell asks for), when the program under test cannot be imported,
or when JAX or the JAX package is loaded once the window has closed."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the run at a fixed path in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
