"""95th percentile of every call's latency in the window, in ms (host
clock), by nearest rank; a failed call counts as missing any limit."""

import math


def p95(seconds: list[float]) -> float:
    s = sorted(seconds)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def read(run):
    return p95([c.seconds if c.ok else math.inf for c in run.calls]) * 1e3
