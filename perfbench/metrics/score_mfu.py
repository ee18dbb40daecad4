"""Model FLOPs of the traced calls' tokens (counts.encoder_flops_per_token
at the cell's tokens a row: the GEMMs, attention's two products and the
head) over the traced window at the bf16 peak, 989 TFLOP/s (device
trace)."""

from perfbench import counts, peaks


def read(run):
    if run.trace is None:
        return None
    cfg, t = run.config, run.traffic
    per_token = counts.encoder_flops_per_token(cfg["num_layers"], cfg["d_model"], cfg["d_ff"],
                                               t["tokens"], cfg["num_outputs"])
    tokens = sum(c.work["tokens"] for c in run.traced_calls if c.ok)
    return 100.0 * per_token * tokens / (run.trace.window_s * peaks.BF16_FLOPS_PER_S)
