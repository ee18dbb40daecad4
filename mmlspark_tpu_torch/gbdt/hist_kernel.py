"""Gradient/hessian histogram build — the GBDT hot kernel, on Hopper.

Counterpart of mmlspark_tpu/gbdt/hist_kernel.py. The JAX package builds the
(F, B, C) histogram H[f, b, c] = sum_{i: bins[i, f] = b} stats[i, c] with a
Pallas TPU kernel (`_histogram_pallas`) that turns the scatter into a
one-hot compare plus a matmul, because the TPU has no fast scatter. Here:

- `histogram` is the wrapper the engine calls. On a CUDA tensor it launches
  the hand-written kernel in csrc/hist_kernel.cu (shared-memory scatter per
  warp and feature, deterministic, see the note in the source) or raises;
  on a CPU tensor it runs `histogram_torch`. `histogram.launches` counts
  kernel launches.
- `histogram_torch` is the plain version: `index_add_` over flat ids
  `bins + f * B`, the counterpart of `histogram_xla_scatter`. The CPU tests
  use it, and chip_smoke.py holds the kernel against it on the card.

Both return (F, B, C) float32. Padded or masked rows must carry zero stats.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import kernels

__all__ = ["histogram", "histogram_torch", "tiling"]

_CHANNELS = 3
_WARPS_PER_BLOCK = 8      # features per block, one warp each (the .cu's block shape)
_MAX_CHUNK_ROWS = 8192    # rows one warp walks per chunk


def histogram_torch(bins: torch.Tensor, stats: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """Plain version: bins (n, F) uint8/int32, stats (n, C) f32 -> (F, B, C)."""
    n, f = bins.shape
    c = stats.shape[1]
    # widen before the id arithmetic: bins + f*B overflows narrow dtypes
    ids = (bins.long() + torch.arange(f, device=bins.device) * num_bins).reshape(-1)
    data = stats.float()[:, None, :].expand(n, f, c).reshape(-1, c)
    out = torch.zeros((f * num_bins, c), dtype=torch.float32, device=bins.device)
    out.index_add_(0, ids, data)
    return out.view(f, num_bins, c)


def tiling(n: int, num_features: int, num_sms: int) -> tuple[int, int, int]:
    """(rows_per_chunk, num_chunks, warps_per_block) of one launch: at least
    two blocks per SM, at most _MAX_CHUNK_ROWS rows per chunk."""
    warps = min(num_features, _WARPS_PER_BLOCK)
    groups = -(-num_features // warps)
    chunks = max(-(-2 * num_sms // groups), -(-n // _MAX_CHUNK_ROWS))
    rows = max(n // chunks, 1)     # round rows down so no block is lost
    return rows, -(-n // rows), warps


def _check(bins: torch.Tensor, stats: torch.Tensor, num_bins: int) -> None:
    if bins.dim() != 2 or bins.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"bins must be a 2-D uint8 or int32 tensor, got "
                         f"{tuple(bins.shape)} {bins.dtype}")
    if stats.dim() != 2 or stats.shape != (bins.shape[0], _CHANNELS) \
            or stats.dtype != torch.float32:
        raise ValueError(f"stats must be ({bins.shape[0]}, {_CHANNELS}) float32, "
                         f"got {tuple(stats.shape)} {stats.dtype}")
    if bins.device != stats.device:
        raise ValueError(f"bins on {bins.device} but stats on {stats.device}")
    if not (bins.is_contiguous() and stats.is_contiguous()):
        raise ValueError("bins and stats must be contiguous")
    if not 1 <= int(num_bins) <= 256:
        raise ValueError(f"num_bins must be in [1, 256], got {num_bins}")


def _lib() -> ctypes.CDLL:
    lib = kernels.load("hist_kernel")
    if not getattr(lib, "_mmlspark_bound", False):
        lib.mmlspark_hist_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.mmlspark_hist_build.restype = ctypes.c_int
        lib.mmlspark_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mmlspark_cuda_error_string.restype = ctypes.c_char_p
        lib._mmlspark_bound = True
    return lib


def histogram(bins: torch.Tensor, stats: torch.Tensor, num_bins: int) -> torch.Tensor:
    """bins (n, F) uint8/int32 with values < num_bins <= 256; stats (n, 3)
    f32 (grad*mask, hess*mask, mask>0). Returns (F, B, 3) f32.

    A CPU tensor runs `histogram_torch`. A CUDA tensor launches the kernel
    (the same bits on every launch) or raises; bins outside [0, num_bins)
    are dropped by the kernel."""
    _check(bins, stats, num_bins)
    if bins.device.type == "cpu":
        return histogram_torch(bins, stats, num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"histogram runs on cuda or cpu tensors, not {bins.device}")
    n, f = bins.shape
    out = torch.empty((f, num_bins, _CHANNELS), dtype=torch.float32,
                      device=bins.device)
    if n == 0:
        return out.zero_()
    dev = bins.device.index if bins.device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, chunks, warps = tiling(n, f, sms)
    partials = torch.empty((chunks, f, num_bins, _CHANNELS), dtype=torch.float32,
                           device=bins.device)
    lib = _lib()
    code = lib.mmlspark_hist_build(
        bins.data_ptr(), bins.element_size(), stats.data_ptr(), n, f,
        int(num_bins), rows, chunks, warps, partials.data_ptr(),
        out.data_ptr(), dev, torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError("histogram kernel launch failed: "
                           + lib.mmlspark_cuda_error_string(code).decode())
    histogram.launches += 1
    return out


histogram.launches = 0
