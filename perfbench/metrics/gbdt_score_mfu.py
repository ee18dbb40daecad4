"""The traced calls' least time on one H100 (counts.score_call_seconds:
the host rows up to the card over PCIe, read once, a comparison a row and
tree at least, the margins back) over the traced window (device
trace)."""

from perfbench import counts


def read(run):
    if run.trace is None:
        return None
    trees = run.config["num_iterations"]
    least = sum(counts.score_call_seconds(c.work["rows"], run.driver.rows.shape[-1],
                                          c.work["rows"] * trees)
                for c in run.traced_calls if c.ok)
    return 100.0 * least / run.trace.window_s
