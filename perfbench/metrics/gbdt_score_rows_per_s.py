"""Rows scored over the window, all calls (host clock)."""


def read(run):
    return sum(c.work["rows"] for c in run.done) / run.window_s
