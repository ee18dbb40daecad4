"""Shared by the device-idle readers: the traced window's idle share."""


def idle_pct(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
