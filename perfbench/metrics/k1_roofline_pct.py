"""K1's least time for the histograms the traced fits asked of it (each
tree's root and each split's left child, at the kernel table's bound:
kept rows' bins, every row's stats, the output once) over K1's summed
device time (device trace)."""

from perfbench import counts
from perfbench.metrics._fit import traced_forests


def read(run):
    tr = run.trace
    if tr is None or not tr.kernel_count(counts.K1_PATTERN):
        return None
    cfg = run.config
    rows, f = run.driver.x.shape
    bins = int(run.driver.ref_bins().max()) + 1
    least = 0.0
    for b, cnt in traced_forests(run):
        for t in range(b.feature.shape[0]):
            kept = [rows] + [cnt[t, lc] for lc in b.left[t][b.feature[t] >= 0]]
            least += sum(counts.k1_launch_seconds(k, rows, f, bins) for k in kept)
    return 100.0 * least / tr.kernel_seconds(counts.K1_PATTERN)
