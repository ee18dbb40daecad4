"""Device time in kernels that are neither a GEMM nor K2 (the casts,
LayerNorms, GELU, adds, softmax and pooling of the encoder) over all
kernel time in the traced window (device trace)."""

from perfbench.counts import GEMM_PATTERN, K2_PATTERN


def read(run):
    tr = run.trace
    if tr is None or not tr.kernel_count():
        return None
    total = tr.kernel_seconds()
    other = total - tr.kernel_seconds(GEMM_PATTERN) - tr.kernel_seconds(K2_PATTERN)
    return 100.0 * other / total
