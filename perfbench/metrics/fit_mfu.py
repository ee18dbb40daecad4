"""The traced fits' least time on one H100 (counts.fit_seconds: the rows
uploaded and binned once, a gradient and score pass a round, and a
histogram of each split's smaller child, LightGBM's subtraction) over the
traced window (device trace)."""

from perfbench import counts
from perfbench.metrics._fit import traced_forests


def read(run):
    if run.trace is None:
        return None
    rows, f = run.driver.x.shape
    least = 0.0
    for b, cnt in traced_forests(run):
        small = sum(counts.smaller_child_rows(b.feature[t], b.left[t], b.right[t], cnt[t])
                    for t in range(b.feature.shape[0]))
        least += counts.fit_seconds(rows, f, b.feature.shape[0], small)
    return 100.0 * least / run.trace.window_s
