"""K2's least time for its launches in the traced window (counts.
k2_launch_seconds at the cell's minibatch and tokens: q, k, v, out and
lse moved once, or the products at the bf16 peak) over K2's summed
device time (device trace)."""

from perfbench import counts


def read(run):
    tr = run.trace
    if tr is None or not tr.kernel_count(counts.K2_PATTERN):
        return None
    cfg, t = run.config, run.traffic
    one = counts.k2_launch_seconds(t["mini_batch_size"], t["tokens"], cfg["num_heads"],
                                   cfg["d_model"] // cfg["num_heads"])
    return (100.0 * one * tr.kernel_count(counts.K2_PATTERN)
            / tr.kernel_seconds(counts.K2_PATTERN))
