"""Gradient/hessian histogram build — the GBDT hot kernel, on Hopper.

Counterpart of mmlspark_tpu/gbdt/hist_kernel.py. The JAX package builds the
(F, B, C) histogram H[f, b, c] = sum_{i: bins[i, f] = b} stats[i, c] with a
Pallas TPU kernel (`_histogram_pallas`) that turns the scatter into a
one-hot compare plus a matmul, because the TPU has no fast scatter. Here:

- `histogram` is the wrapper the engine calls. On a CUDA tensor it launches
  the hand-written kernel in csrc/hist_kernel.cu or raises: one launch
  that reads every row's stats and the bins of the rows with nonzero ones,
  adds them into shared-memory histograms with one writer per bin, and sums
  the blocks' partials in block order after a grid barrier (deterministic;
  see the note in the source). On a CPU tensor it runs `histogram_torch`.
  `histogram.launches` counts kernel launches.
- `launch_plan` is the launch the wrapper makes for a shape: grid, block,
  tiles and shared memory.
- `histogram_torch` is the plain version: `index_add_` over flat ids
  `bins + f * B`, the counterpart of `histogram_xla_scatter`. The CPU tests
  use it, and chip_smoke.py holds the kernel against it on the card.

Both return (F, B, C) float32. Padded or masked rows must carry zero stats.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core import kernels

__all__ = ["histogram", "histogram_torch", "launch_plan", "LaunchPlan", "max_bins"]

_CHANNELS = 3
_SMEM_MAX = 232448        # bytes of shared memory a block may use on sm_90
_TILE_ROWS = (256, 128, 64, 32)   # rows a block stages at a time, largest that fits
_MISC_BYTES = 256         # the kernel's counters


class LaunchPlan(NamedTuple):
    """One launch of the kernel (csrc/hist_kernel.cu, `Params`)."""
    grid_x: int           # blocks along the rows, each `tiles_per_block` tiles
    grid_y: int           # feature groups of `feats_per_group` (1 unless F x B x 12 bytes is too much)
    feats_per_group: int
    warps_per_copy: int   # W: warps sharing one histogram copy, each its own features
    copies: int           # C: histogram copies a block holds, summed in order
    tile_rows: int        # R
    tiles_per_block: int
    bins_buf_bytes: int   # one of the two bin staging buffers
    gather_pitch: int     # bytes of one gathered row in a staging buffer
    smem_bytes: int

    @property
    def threads(self) -> int:
        return 32 * self.warps_per_copy * self.copies

    @property
    def branch(self) -> str:
        """Which launch this is: one block along the rows ("one_block": no
        grid barrier, a plain launch), feature groups ("split"), a tile
        under 256 rows ("small_tile"), a grid capped by the SMs, more than
        one tile a block ("capped"), or one tile a block ("rows")."""
        if self.grid_x == 1:
            return "one_block"
        if self.grid_y > 1:
            return "split"
        if self.tile_rows < _TILE_ROWS[0]:
            return "small_tile"
        return "capped" if self.tiles_per_block > 1 else "rows"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_bytes(copies: int, feats: int, num_bins: int, warps: int, tile_rows: int,
                buf: int) -> int:
    """The kernel's `smem_bytes_of`: histogram copies, each warp's lane
    masks, one tile's stats, two entry and two bin buffers, counters."""
    return (4 * _round_up(copies * feats * num_bins * _CHANNELS, 4)
            + 4 * _round_up(warps * num_bins, 4) + 12 * tile_rows + 32 * tile_rows + 2 * buf
            + _MISC_BYTES)


@functools.lru_cache(maxsize=256)
def _block(num_features: int, num_bins: int, bin_bytes: int):
    """The block of `launch_plan`: (groups, features a group, warps a copy,
    copies, tile rows, bin buffer bytes, gather pitch, shared memory bytes),
    or None where not even one feature's histogram fits."""
    f = num_features
    for groups in range(1, f + 1):
        fg = -(-f // groups)
        if -(-f // fg) != groups:       # the same split as fewer groups
            continue
        warps = min(fg, 32)
        # the 4-byte words of a row's group bins, from the word below it;
        # odd, so gathered rows fall in different banks
        words = (fg * bin_bytes + 2) // 4 + 1
        pitch = 4 * (words | 1)
        for rows in _TILE_ROWS:
            # dense tiles stage the whole span of a tile (groups == 1);
            # gathered ones a quarter of it at most, or all of a group's
            buf = (rows * pitch if groups > 1
                   else max(rows * f * bin_bytes + 32, rows // 4 * pitch))
            buf = _round_up(buf, 16)
            for copies in range(max(1, 32 // warps), 0, -1):
                if 32 * warps * copies < rows:   # a tile's rows are one a thread
                    break
                smem = _smem_bytes(copies, fg, num_bins, copies * warps, rows, buf)
                if smem <= _SMEM_MAX:
                    return groups, fg, warps, copies, rows, buf, pitch, smem
    return None


def max_bins(num_features: int, bin_bytes: int) -> int:
    """The most bins a launch fits for F features of `bin_bytes` bytes: one
    feature's histogram (12 bytes a bin), its warp's lane masks (4 bytes a
    bin) and a tile's buffers in a block's shared memory."""
    lo, hi = 1, _SMEM_MAX // 16 + 1      # lo fits, hi does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _block(num_features, mid, bin_bytes) else (lo, mid)
    return lo


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, num_features: int, num_bins: int, bin_bytes: int,
                num_sms: int) -> LaunchPlan:
    """The launch for n rows of F features: all features in one block if
    their histograms fit in shared memory, else feature groups along
    grid_y; the largest row tile that fits, at most one row a thread;
    W = min(features, 32) warps per histogram copy and as many copies as
    fill 32 warps; the rows spread over as many blocks as the SMs take, at
    most one block an SM (the grid barrier needs every block resident), or
    one block along the rows where the groups alone fill the card. (Two
    tiles a block at least, 64 blocks at the Adult shape in place of 128,
    took 14.4 us of device time against 12.1: PERF.md, K1's versions.)
    Raises ValueError past `max_bins`: the CUDA kernel has no other route."""
    block = _block(num_features, num_bins, bin_bytes)
    if block is None:
        raise ValueError(
            f"no launch fits {num_features} features of {num_bins} bins: one "
            f"feature's histogram, lane masks and tile buffers must fit the "
            f"{_SMEM_MAX} bytes of shared memory a block has on sm_90, which "
            f"holds at most {max_bins(num_features, bin_bytes)} bins here")
    groups, fg, warps, copies, rows, buf, pitch, smem = block
    tiles = -(-n // rows)
    grid_x_max = num_sms // groups
    per = -(-tiles // grid_x_max) if grid_x_max >= 2 else tiles
    grid_x = -(-tiles // per)
    return LaunchPlan(grid_x, groups, fg, warps, copies, rows, per, buf, pitch, smem)


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
    if int(num_bins) < 1:
        raise ValueError(f"num_bins must be at least 1, got {num_bins}")


def _lib() -> ctypes.CDLL:
    lib = kernels.load("hist_kernel")
    if not getattr(lib, "_mmlspark_bound", False):
        i32, ptr = ctypes.c_int, ctypes.c_void_p
        lib.mmlspark_hist_build.argtypes = [
            ptr, i32, ptr, ctypes.c_int64, i32, i32,           # bins .. num_bins
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,  # the launch plan
            ptr, ptr, i32, ptr,                                # partials, out, device, stream
        ]
        lib.mmlspark_hist_build.restype = i32
        lib.mmlspark_hist_empty.argtypes = [i32, i32, i32, i32, ptr]
        lib.mmlspark_hist_empty.restype = i32
        lib.mmlspark_cuda_error_string.argtypes = [i32]
        lib.mmlspark_cuda_error_string.restype = ctypes.c_char_p
        lib._mmlspark_bound = True
    return lib


_SMS: dict = {}           # device index -> SM count
_PARTIALS: dict = {}      # (device index, stream) -> the largest partials buffer so far


def _num_sms(dev: int) -> int:
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _partials(device: torch.device, stream: int, floats: int) -> torch.Tensor:
    """Scratch for the blocks' partials, one buffer per device and stream
    (two streams never share one), grown to the largest size asked for."""
    key = (device.index, stream)
    buf = _PARTIALS.get(key)
    if buf is None or buf.numel() < floats:
        buf = _PARTIALS[key] = torch.empty(floats, dtype=torch.float32, device=device)
    return buf


def histogram(bins: torch.Tensor, stats: torch.Tensor, num_bins: int) -> torch.Tensor:
    """bins (n, F) uint8/int32 with values < num_bins; stats (n, 3) f32
    (grad*mask, hess*mask, mask>0). Returns (F, B, 3) f32, a new tensor on
    every call.

    A CPU tensor runs `histogram_torch`, at any num_bins. A CUDA tensor
    launches the kernel once (the same bits on every launch) or raises:
    past `max_bins` (about 14,000 bins) no launch fits shared memory, and
    `launch_plan` raises ValueError naming the limit. Bins outside
    [0, num_bins) are dropped by the kernel. The call neither syncs nor
    allocates beyond the output once its scratch exists, so it can be
    captured in a CUDA graph."""
    _check(bins, stats, num_bins)
    if bins.device.type == "cpu":
        return histogram_torch(bins, stats, num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"histogram runs on cuda or cpu tensors, not {bins.device}")
    n, f = bins.shape
    out = torch.empty((f, num_bins, _CHANNELS), dtype=torch.float32, device=bins.device)
    if n == 0:
        return out.zero_()
    dev = bins.device.index if bins.device.index is not None else torch.cuda.current_device()
    plan = launch_plan(n, f, int(num_bins), bins.element_size(), _num_sms(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials = (_partials(bins.device, stream, plan.grid_x * out.numel())
                if plan.grid_x > 1 else out)
    lib = _lib()
    code = lib.mmlspark_hist_build(
        bins.data_ptr(), bins.element_size(), stats.data_ptr(), n, f, int(num_bins),
        plan.grid_x, plan.grid_y, plan.feats_per_group, plan.warps_per_copy, plan.copies,
        plan.tile_rows, plan.tiles_per_block, plan.bins_buf_bytes, plan.gather_pitch,
        plan.smem_bytes, partials.data_ptr(), out.data_ptr(), dev, stream)
    if code != 0:
        raise RuntimeError("histogram kernel launch failed: "
                           + lib.mmlspark_cuda_error_string(code).decode())
    histogram.launches += 1
    return out


histogram.launches = 0
