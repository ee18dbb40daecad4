"""One torch.profiler (Kineto/CUPTI) trace over a cell's traced window,
read by the benchmark's own code.

The profiler runs with CUDA activity (kernels, copies, runtime calls) and,
on the CPU side, user annotations only (the harness's own spans around
each call), so a window of a million launches stays cheap to record. The
raw events are read once into numpy columns, without torch's per-event
parsing. Timestamps are nanoseconds on the host's wall clock for host and
device events alike. A user annotation also appears on the device's
timeline; it is a span, not an operation, and is never counted as one."""

from __future__ import annotations

import re
from contextlib import contextmanager

import numpy as np

#: the harness's own spans (`torch.profiler.record_function` names)
SPAN_PREFIX = "perfbench."


class Trace:
    """The events of one traced window. Device operations (kernels and
    copies) as columns: `op_name` (an index into `names`), `op_start`,
    `op_end`, `op_corr`, `op_kernel` (False for a copy or memset)."""

    def __init__(self, start_ns: int, end_ns: int, ops=(), runtime=(), spans=()):
        self.start_ns, self.end_ns = int(start_ns), int(end_ns)
        self.names: list[str] = []
        index: dict[str, int] = {}
        cols = ([], [], [], [], [])
        for name, s, e, corr in ops:
            i = index.get(name)
            if i is None:
                i = index[name] = len(self.names)
                self.names.append(name)
            for col, v in zip(cols, (i, s, e, corr, not _is_copy(name))):
                col.append(v)
        self.op_name = np.asarray(cols[0], np.int64)
        self.op_start = np.asarray(cols[1], np.int64)
        self.op_end = np.asarray(cols[2], np.int64)
        self.op_corr = np.asarray(cols[3], np.int64)
        self.op_kernel = np.asarray(cols[4], bool)
        rt = sorted(runtime)
        self.rt_corr = np.asarray([c for c, _ in rt], np.int64)
        self.rt_start = np.asarray([s for _, s in rt], np.int64)
        self.spans = list(spans)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def _matches(self, pattern: str | None) -> np.ndarray:
        """Per device operation: a kernel whose name matches `pattern`."""
        if pattern is None:
            return self.op_kernel
        rx = re.compile(pattern)
        hit = np.asarray([bool(rx.search(n)) for n in self.names] + [False], bool)
        return hit[self.op_name] & self.op_kernel if len(self.op_name) else self.op_kernel

    def kernel_count(self, pattern: str | None = None) -> int:
        return int(self._matches(pattern).sum())

    def kernel_seconds(self, pattern: str | None = None) -> float:
        m = self._matches(pattern)
        return float((self.op_end[m] - self.op_start[m]).sum()) * 1e-9

    def launch_ns(self, pattern: str) -> np.ndarray:
        """Host times of the runtime calls that launched the kernels
        matching `pattern` (a kernel's own start where its call is not in
        the trace), in order."""
        m = self._matches(pattern)
        out = self.op_start[m].copy()
        if len(self.rt_corr):
            corr = self.op_corr[m]
            at = np.minimum(np.searchsorted(self.rt_corr, corr), len(self.rt_corr) - 1)
            found = self.rt_corr[at] == corr
            out[found] = self.rt_start[at[found]]
        return np.sort(out)

    def _sorted_ops(self):
        order = np.argsort(self.op_start, kind="stable")
        s = np.clip(self.op_start[order], self.start_ns, self.end_ns)
        e = np.clip(self.op_end[order], self.start_ns, self.end_ns)
        return s, e, self.op_name[order]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card (the union)."""
        s, e, _ = self._sorted_ops()
        if not len(s):
            return 0.0
        reach = np.maximum.accumulate(e)
        # a busy stretch starts where an operation begins after every
        # earlier one has ended
        new = np.concatenate([[True], s[1:] > reach[:-1]])
        ends = np.concatenate([reach[:-1][new[1:]], reach[-1:]])
        return float((ends - s[new]).sum()) * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the operation that ended them ("window end" for the
        last), `top` of each, in seconds."""
        short_names = [short(n) for n in self.names]
        labels = sorted(set(short_names))
        code = np.asarray([labels.index(n) for n in short_names] + [0], np.int64)
        s, e, name = self._sorted_ops()
        by_op = np.bincount(code[self.op_name], weights=(self.op_end - self.op_start),
                            minlength=len(labels)) if len(name) else np.zeros(0)
        ops = sorted(zip(labels, by_op.tolist()), key=lambda kv: -kv[1])[:top]
        gaps: dict = {}
        if len(s):
            reach = np.concatenate([[self.start_ns], np.maximum.accumulate(e)])
            gap = s - reach[:-1]
            idle = gap > 0
            per = np.bincount(code[name[idle]], weights=gap[idle], minlength=len(labels))
            gaps = {f"before {labels[i]}": float(v) for i, v in enumerate(per) if v > 0}
            tail = self.end_ns - reach[-1]
        else:
            tail = self.end_ns - self.start_ns
        if tail > 0:
            gaps["window end"] = float(tail)
        idle_top = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v * 1e-9] for n, v in ops if v > 0],
                "idle_gaps": [[n, v * 1e-9] for n, v in idle_top]}


def _is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:120]


def _config():
    from torch.autograd import ProfilerConfig, ProfilerState
    from torch._C._profiler import _ExperimentalConfig

    args = (ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
    try:
        return ProfilerConfig(*args, "")
    except TypeError:
        return ProfilerConfig(*args)


@contextmanager
def traced(out: list):
    """Trace the body; append the `Trace` to `out` when it ends."""
    import time

    import torch
    from torch.autograd import (DeviceType, ProfilerActivity, _disable_profiler,
                                _enable_profiler, _prepare_profiler)
    from torch._C._profiler import RecordScope

    acts = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        acts.add(ProfilerActivity.CUDA)
    cfg = _config()
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    t0 = time.time_ns()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
        ops, runtime, spans, device_spans = [], [], [], []
        cuda = DeviceType.CUDA
        for ev in _disable_profiler().events():
            name, s = ev.name(), ev.start_ns()
            if name.startswith(SPAN_PREFIX):
                # the host's span, or its copy on the device's timeline
                # (from its first operation to its last)
                (device_spans if ev.device_type() == cuda else spans).append(
                    (name, s, s + ev.duration_ns()))
            elif ev.device_type() == cuda:
                ops.append((name, s, s + ev.duration_ns(), ev.correlation_id()))
            elif ev.correlation_id():
                runtime.append((ev.correlation_id(), s))
        out.append(Trace(t0, t1, ops, runtime, spans or device_spans))
