"""Shared by the fit's readers: the rows that reach each node of the
traced fits' trees, by the benchmark's own walk over its bins, worked
out once a run."""

import numpy as np

from perfbench import counts


def traced_forests(run):
    """[(booster, node row counts (T, M))] of each traced fit."""
    if "traced_forests" not in run.info:
        drv = run.driver
        n_traced = sum(1 for c in run.traced_calls if c.ok)
        out, cache = [], {}
        for b in drv.boosters[:n_traced]:
            key = (b.feature.tobytes(), b.threshold_bin.tobytes())
            if key not in cache:
                bins = drv.ref_bins()
                cache[key] = np.stack([counts.node_rows(b.feature[t], b.threshold_bin[t],
                                                        b.left[t], b.right[t], bins)
                                       for t in range(b.feature.shape[0])])
            out.append((b, cache[key]))
        run.info["traced_forests"] = out
    return run.info["traced_forests"]
