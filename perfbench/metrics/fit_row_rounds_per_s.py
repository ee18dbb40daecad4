"""Rows x boosting rounds of every fit in the window over the time from
the window's start to the end of its last fit (host clock)."""


def read(run):
    return sum(c.work["row_rounds"] for c in run.done) / run.window_s
