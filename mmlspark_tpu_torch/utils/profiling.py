"""Tracing/profiling utilities (SURVEY.md §5.1).

A port of mmlspark_tpu/utils/profiling.py. The reference's tracing story
is the `Timer` pipeline stage (wall-clock per fit/transform) plus
per-test timing; a device trace adds what the card did underneath. Here
the trace is `torch.profiler.profile` (CPU and, on a card, CUDA
activities through CUPTI), exported as a Chrome/Perfetto trace JSON file
into the trace directory. Usage:

    with device_trace("/tmp/trace"):          # trace-<pid>-<n>.json there
        booster = Booster.train(...)

    with annotate("histogram"):               # named range inside a trace
        ...

    out, stats = profile_fn(fn, *args)        # quick wall+device timing

`device_trace` is also switchable by env var: MMLSPARK_TPU_TRACE_DIR set ->
every `device_trace(None)` call traces into it; unset -> no-op context.

`block_until_ready` waits on the streams that produced its tensors (an
event recorded on each device's current stream), or on the CUDA event a
fused dispatch carries; it never calls a device-wide
`torch.cuda.synchronize()`, which would also wait on, and could disturb,
another thread's CUDA-graph capture.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Any, Callable

__all__ = ["device_trace", "annotate", "profile_fn", "block_until_ready"]

_TRACE_SEQ = itertools.count()


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """torch.profiler trace into `trace_dir` (or MMLSPARK_TPU_TRACE_DIR);
    no-op when neither is set. On exit the trace is written as
    `trace-<pid>-<n>.json` there and `device_trace.last_path` names it."""
    target = trace_dir or os.environ.get("MMLSPARK_TPU_TRACE_DIR")
    if not target:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(target, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield target
    path = os.path.join(target, f"trace-{os.getpid()}-{next(_TRACE_SEQ)}.json")
    prof.export_chrome_trace(path)
    device_trace.last_path = path


device_trace.last_path = None


def annotate(name: str):
    """Named range (`torch.profiler.record_function`) visible in the
    device trace."""
    import torch

    return torch.profiler.record_function(name)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def block_until_ready(tree: Any) -> Any:
    """Wait until every CUDA tensor in `tree` (dicts, tuples, lists) has
    been computed, and return `tree`. A container carrying `.event` (a
    fused dispatch's outputs) waits on that event; other CUDA tensors on
    an event recorded on their device's current stream. CPU values are
    ready as they are."""
    event = getattr(tree, "event", None)
    if event is not None:
        event.synchronize()
        return tree
    devices = {leaf.device for leaf in _leaves(tree)
               if getattr(getattr(leaf, "device", None), "type", None) == "cuda"}
    if devices:
        import torch

        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()
    return tree


def _cuda_device_of(tree: Any):
    for leaf in _leaves(tree):
        dev = getattr(leaf, "device", None)
        if getattr(dev, "type", None) == "cuda":
            return dev
    return None


def profile_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3,
               registry: Any = None, name: "str | None" = None,
               clock: "Callable[[], float] | None" = None,
               **kwargs) -> "tuple[Any, dict]":
    """Quick timing: first-call time, then per-iteration steady wall times
    with device completion awaited. Returns `(out, stats)`. All times in
    seconds: first_call_s, steady_s (mean), compile_overhead_s,
    iter_min_s, iter_median_s, iter_max_s, iters. When the output holds
    CUDA tensors, each steady iteration is also bracketed by two CUDA
    events on that device's current stream, and `device_steady_s` is the
    mean of their elapsed times (read after the end event is waited on).

    `clock` is any zero-arg monotonic float source (default
    `time.perf_counter`); tests inject a fake to assert on the stats
    arithmetic without depending on real elapsed time.

    The measurements also land in `registry` (the process default when
    None) as `mmlspark_tpu_profile_*` series labeled `fn=` the callable's
    name (override with `name=`)."""
    now = clock if clock is not None else time.perf_counter
    t0 = now()
    out = block_until_ready(fn(*args, **kwargs))
    first = now() - t0
    for _ in range(max(warmup - 1, 0)):
        block_until_ready(fn(*args, **kwargs))
    dev = _cuda_device_of(out)
    samples = []
    device_samples = []
    for _ in range(iters):
        if dev is not None:
            import torch

            stream = torch.cuda.current_stream(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
        t0 = now()
        out = fn(*args, **kwargs)
        if dev is not None:
            end.record(stream)
        out = block_until_ready(out)
        samples.append(now() - t0)
        if dev is not None:
            end.synchronize()
            device_samples.append(start.elapsed_time(end) / 1e3)
    steady = sum(samples) / len(samples) if samples else 0.0
    ordered = sorted(samples)
    stats = {
        "first_call_s": first, "steady_s": steady,
        "compile_overhead_s": max(first - steady, 0.0),
        "iter_min_s": ordered[0] if ordered else 0.0,
        "iter_median_s": ordered[len(ordered) // 2] if ordered else 0.0,
        "iter_max_s": ordered[-1] if ordered else 0.0,
        "iters": len(samples),
    }
    if device_samples:
        stats["device_steady_s"] = sum(device_samples) / len(device_samples)
    try:
        from ..observability.metrics import get_registry

        reg = registry if registry is not None else get_registry()
        label = name or getattr(fn, "__name__", None) or "fn"
        reg.gauge("mmlspark_tpu_profile_steady_seconds",
                  "profile_fn steady-state wall time (mean over iters)",
                  labels=("fn",)).labels(fn=label).set(steady)
        reg.gauge("mmlspark_tpu_profile_first_call_seconds",
                  "profile_fn first-call (compile-inclusive) wall time",
                  labels=("fn",)).labels(fn=label).set(first)
        reg.counter("mmlspark_tpu_profile_runs_total",
                    "profile_fn invocations",
                    labels=("fn",)).labels(fn=label).inc()
    except Exception:
        pass
    return out, stats
