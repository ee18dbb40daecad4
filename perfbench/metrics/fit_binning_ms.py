"""Host time from each traced fit's start (the harness's span around the
call) to the launch of its first K1 histogram: the Table to arrays, the
boundary sketch and the binning (device trace; mean over traced fits)."""

import numpy as np

from perfbench.counts import K1_PATTERN


def read(run):
    tr = run.trace
    if tr is None:
        return None
    k1 = tr.launch_ns(K1_PATTERN)
    out = []
    for name, s, e in tr.spans:
        if name == "perfbench.call":
            i = int(np.searchsorted(k1, s))
            if i < len(k1) and k1[i] <= e:
                out.append((k1[i] - s) * 1e-6)
    return sum(out) / len(out) if out else None
