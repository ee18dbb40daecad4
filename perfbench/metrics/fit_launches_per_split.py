"""Device kernels in the traced window over the split steps the traced
fits ran (device trace)."""


def read(run):
    if run.trace is None:
        return None
    steps = sum(c.work["split_steps"] for c in run.traced_calls if c.ok)
    return run.trace.kernel_count() / steps if steps else None
