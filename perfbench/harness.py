"""The benchmark's one general runner. It finds everything by name:

- the cell: perfbench/workloads/<cell>.json (configuration, traffic mix,
  chips, why, and the limit of each number the output check compares);
- the configuration: perfbench/configs/<config>.json;
- the traffic mix: perfbench/traffic/<traffic>.json, whose `driver` names
  perfbench/traffic/<driver>.py, the code that makes the inputs, warms
  up, makes one call of the timed path and checks the outputs;
- each metric of BENCHMARK.json that applies to the cell:
  perfbench/metrics/<metric>.py, whose `read(run)` returns a number or
  None (nothing to read: the metric is left out of the line).

A run: set-up (inputs, weights and a warm-up of the cell's own shapes),
then a closed loop of calls, one caller, until the first call to end
after `seconds`; with `trace` a profiler trace over the traffic's first
`trace_calls` calls (all where it names none). Then the card's peak
memory is read, the program's state is freed and the traffic module
compares what the window produced with the plain reference."""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from contextlib import ExitStack
from dataclasses import dataclass, field
from pathlib import Path

PB = Path(__file__).resolve().parent
ROOT = PB.parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "mmlspark_tpu")


@dataclass
class Call:
    start: float
    end: float
    work: dict
    ok: bool = True

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """What the metric readers read."""

    cell: str
    spec: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    driver: object
    setup_s: float = 0.0
    calls: list = field(default_factory=list)
    window_start: float = 0.0
    trace: object = None          # trace.Trace of the traced calls
    traced_calls: list = field(default_factory=list)
    info: dict = field(default_factory=dict)

    @property
    def done(self) -> list:
        return [c for c in self.calls if c.ok]

    @property
    def window_s(self) -> float:
        return self.calls[-1].end - self.window_start if self.calls else 0.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(cell: str, pb: Path = PB, overrides: dict | None = None):
    """(workload spec, configuration, traffic) of a cell, with a test's
    overrides of the configuration and traffic merged in."""
    spec = load_json(pb / "workloads" / f"{cell}.json")
    config = load_json(pb / "configs" / f"{spec['config']}.json")
    traffic = load_json(pb / "traffic" / f"{spec['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return spec, config, traffic


def metrics_for(man: dict, cell: str, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports."""
    return [m for m in man[kind] if "workloads" not in m or cell in m["workloads"]]


def leaked_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, overrides: dict | None = None,
             pb: Path = PB, root: Path = ROOT) -> tuple[dict, list]:
    """One run of `cell`. Returns (the result object, the compared numbers
    as [(name, value, limit)])."""
    import torch

    from perfbench.trace import traced

    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest(root)
    spec, config, traffic = cell_files(cell, pb, overrides)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver = load_module(pb / "traffic" / f"{traffic['driver']}.py").Driver(
        config, traffic, seed, device)
    run = Run(cell, spec, config, traffic, seed, seconds, driver)

    driver.setup()
    _sync(device)
    traces: list = []
    trace_calls = traffic.get("trace_calls") or 10 ** 9
    with ExitStack() as stack:
        if trace:
            stack.enter_context(traced(traces))
        run.window_start = time.perf_counter()
        run.setup_s = run.window_start - t_start
        i = 0
        while True:
            c0 = time.perf_counter()
            try:
                with torch.profiler.record_function("perfbench.call"):
                    work = driver.call(i)
                _sync(device)
                run.calls.append(Call(c0, time.perf_counter(), work))
            except Exception as exc:   # a failed call counts as failed, not as a crash
                print(f"call {i} failed: {exc!r}", file=sys.stderr)
                run.calls.append(Call(c0, time.perf_counter(), {}, ok=False))
            i += 1
            if trace and i == trace_calls:
                stack.close()
            if run.calls[-1].end - run.window_start >= seconds:
                break
    run.trace = traces[0] if traces else None
    run.traced_calls = run.calls[:trace_calls] if trace else []

    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    driver.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check()
    limits = spec["limits"]
    checks = [(name, float(numbers[name]), float(limits[name])) for name in limits]
    correct = all(v <= lim for _, v, lim in checks) and all(c.ok for c in run.calls)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(man, cell, kind):
        value = load_module(pb / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name() if device == "cuda" else device,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(run.calls),
              "failed": sum(not c.ok for c in run.calls), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    chips = load_json(PB / "workloads" / f"{args.workload}.json")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=t_start)
    leaked = leaked_modules()
    if leaked:
        print(f"the run's process loaded {leaked}; no result", file=sys.stderr)
        return 3
    print(f"card {power_limit()}; calls {result['attempted']}, failed {result['failed']}",
          file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
