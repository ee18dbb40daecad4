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
  see the note in the source). Above 256 bins a block owns a range of its
  features' bins, so any B launches. On a CPU tensor it runs
  `histogram_torch`. `histogram.launches` counts kernel launches.
- `launch_plan` is the launch for a shape: grid, block, tiles, bin ranges
  and shared memory; `device_plan` is the one the wrapper makes on a card.
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

__all__ = ["histogram", "histogram_torch", "launch_plan", "device_plan", "LaunchPlan"]

_CHANNELS = 3
_SMEM_MAX = 232448        # bytes of shared memory a block may use on sm_90
_TILE_ROWS = (256, 128, 64, 32)   # rows a block stages at a time, largest that fits
_WIDE_TILE_ROWS = (512, 256, 128)  # above 256 bins, beside a row for each thread
_MISC_BYTES = 256         # the kernel's counters
_NARROW_BINS = 256        # above it, the kernel's ranged variant
_RING = 64                # entries of a warp's ring above 256 bins, 16 bytes each
_MAX_IDS = 1 << 31        # the JAX package's int32 ids bins + f * B (hist_kernel.py:93-94)


class LaunchPlan(NamedTuple):
    """One launch of the kernel (csrc/hist_kernel.cu, `Params`)."""
    grid_x: int           # blocks along the rows, each `tiles_per_block` tiles
    grid_y: int           # feature groups of `feats_per_group` x bin ranges
    feats_per_group: int
    warps_per_copy: int   # W: warps sharing one histogram copy, each its own features
                          # (above 256 bins: a feature and a part of the block's bins)
    copies: int           # C: histogram copies a block holds, summed in order (1 above 256 bins)
    tile_rows: int        # R
    tiles_per_block: int
    bins_buf_bytes: int   # one of the two bin staging buffers
    gather_pitch: int     # bytes of one gathered row in a staging buffer
    smem_bytes: int
    bins_per_range: int   # Br: bins of a feature a block holds (B up to 256 bins)
    ranges: int           # bin ranges of a feature along grid_y (1 up to 256 bins)

    @property
    def threads(self) -> int:
        return 32 * self.warps_per_copy * self.copies

    @property
    def branch(self) -> str:
        """Which launch this is: one block along the rows ("one_block": no
        grid barrier, a plain launch), bin ranges ("ranges"), feature groups
        ("split"), a tile under 256 rows ("small_tile"), a grid capped by
        the SMs, more than one tile a block ("capped"), or one tile a block
        ("rows")."""
        if self.grid_x == 1:
            return "one_block"
        if self.ranges > 1:
            return "ranges"
        if self.grid_y > 1:
            return "split"
        if self.tile_rows < _TILE_ROWS[0]:
            return "small_tile"
        return "capped" if self.tiles_per_block > 1 else "rows"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_bytes(copies: int, feats: int, num_bins: int, warps: int, tile_rows: int,
                buf: int) -> int:
    """The kernel's `smem_bytes_of` up to 256 bins: histogram copies, each
    warp's lane masks, one tile's stats, two entry and two bin buffers,
    counters."""
    return (4 * _round_up(copies * feats * num_bins * _CHANNELS, 4)
            + 4 * _round_up(warps * num_bins, 4) + 12 * tile_rows + 32 * tile_rows + 2 * buf
            + _MISC_BYTES)


def _smem_bytes_wide(feats: int, bins: int, warps: int, tile_rows: int, buf: int) -> int:
    """`smem_bytes_of` above 256 bins: one histogram of `bins` bins a
    feature, each warp's masks of its part of them and its ring, a tile
    (its entries with their bins' offsets)."""
    part = -(-bins // (warps // feats))
    return (4 * _round_up(feats * bins * _CHANNELS, 4) + 4 * _round_up(warps * part, 4)
            + 16 * _RING * warps + 12 * tile_rows + 40 * tile_rows + 2 * buf + _MISC_BYTES)


def _staging(f: int, fg: int, groups: int, bin_bytes: int, rows: int) -> tuple:
    """(bytes of one bin buffer, gather pitch): dense tiles stage the whole
    span of a tile (one group); gathered ones a quarter of it at most, or
    all of a group's words, each row at an odd pitch of 4-byte words from
    the word below it, so gathered rows fall in different banks."""
    words = (fg * bin_bytes + 2) // 4 + 1
    pitch = 4 * (words | 1)
    buf = (rows * pitch if groups > 1
           else max(rows * f * bin_bytes + 32, rows // 4 * pitch))
    return _round_up(buf, 16), pitch


def _group_counts(f: int):
    """Each way to cut F features in groups of ceil(F / groups), once."""
    for groups in range(1, f + 1):
        fg = -(-f // groups)
        if -(-f // fg) == groups:
            yield groups, fg


@functools.lru_cache(maxsize=256)
def _block(num_features: int, num_bins: int, bin_bytes: int):
    """The block of `launch_plan` up to 256 bins: (groups, features a
    group, warps a copy, copies, tile rows, bin buffer bytes, gather pitch,
    shared memory bytes)."""
    f = num_features
    for groups, fg in _group_counts(f):
        warps = min(fg, 32)
        for rows in _TILE_ROWS:
            buf, pitch = _staging(f, fg, groups, bin_bytes, rows)
            for copies in range(max(1, 32 // warps), 0, -1):
                if 32 * warps * copies < rows:   # a tile's rows are one a thread
                    break
                smem = _smem_bytes(copies, fg, num_bins, copies * warps, rows, buf)
                if smem <= _SMEM_MAX:
                    return groups, fg, warps, copies, rows, buf, pitch, smem
    raise AssertionError("one feature of 256 bins always fits a block")


# Above 256 bins several blocks of a plan may share an SM, and a
# cooperative grid may hold no more blocks than the SMs hold at once. On a
# card that count is the runtime's (`device_plan`: the kernel's registers,
# shared memory and threads). `resident_blocks` stands for it where there
# is no card, as in the tests: an SM's 65,536 registers at up to 128 a
# thread (the kernel's launch bounds of 512 threads), and 196 KB of its
# shared memory at 1,024 bytes reserved a block.
_SM_THREADS = 512
_SM_SMEM = 200704
_BLOCK_RESERVED = 1024


def resident_blocks(threads: int, smem_bytes: int) -> int:
    """Blocks above 256 bins of `threads` threads and `smem_bytes` of
    shared memory one SM holds at once, by the model above."""
    return max(1, min(_SM_THREADS // threads, _SM_SMEM // (smem_bytes + _BLOCK_RESERVED)))


# The cost model of the plans above 256 bins: microseconds of an H100 for
# each term of `_wide_terms`, fitted to timed plans with every row and 3%
# of rows kept (tools/torch_hist_turns.py plans and fit; PERF.md, K1 above
# 256 bins). A plan is weighed at _KEPT, the mean share of rows a call
# keeps over the 6,200 calls of the two fits that run K1 above 256 bins,
# Adult at max_bin 16383 (0.117) and Amazon access at 1023 (0.135;
# tools/torch_hist_turns.py mix): as the model is linear in the share, the
# plan with the least cost there has the least mean cost over their calls.
_KEPT = 0.126
_WIDE_US = {
    "coop": 9.14,         # a cooperative launch, its grid barrier and cross-block sum
    "plain": 8.88,        # a plain launch (and its output's first touch)
    "tile": 1.104,        # a block's tile: stats, compaction and bin copies in flight
    "tile_rows": 0.048,   # 256 rows of a tile staged
    "issue": 0.2163,      # 32 kept rows scanned by every warp of a block
    "add": 0.3095,        # a warp's add of 32 ring entries
    "gather": 0.367,      # 1,000 kept rows' bins gathered row by row (feature groups)
    "bins": 2.644,        # 100 KB of a block's bins staged
    "partials": 0.562,    # a MB of partials, written and summed
}


def _wide_terms(n: int, f: int, b: int, sms: int, plan: "LaunchPlan",
                kept: float = _KEPT, resident=resident_blocks) -> dict:
    """How many of each `_WIDE_US` unit one launch of a plan above 256 bins
    costs: each block's tiles, scans, adds and staged bins (latency-bound,
    so the blocks an SM holds at once overlap), in waves of what the SMs
    hold (`resident`) where the launch is plain; with blocks along the
    rows, the partials (grid_x x F x B x 12 bytes) and the cross-block sum
    of a cooperative launch. Every term is linear in `kept`, the share of
    rows a call keeps, so the cost at the mean share of a mix of calls is
    the mix's mean cost."""
    parts = plan.warps_per_copy // plan.feats_per_group
    groups = plan.grid_y // plan.ranges
    rows_pb = min(n, plan.tile_rows * plan.tiles_per_block)
    steps = rows_pb * kept / 32
    tiles = -(-rows_pb // plan.tile_rows)
    coop = plan.grid_x > 1
    waves = 1
    if not coop:
        blocks = plan.grid_x * plan.grid_y
        per_sm = min(resident(plan.threads, plan.smem_bytes), -(-blocks // sms))
        waves = -(-blocks // (per_sm * sms))
    return {"coop": float(coop), "plain": float(not coop), "tile": waves * tiles,
            "tile_rows": waves * tiles * plan.tile_rows / 256,
            "issue": waves * steps * plan.warps_per_copy / 32,
            "add": waves * steps / (plan.ranges * parts),
            "gather": waves * rows_pb * kept / 1000 * (groups > 1),
            "bins": waves * rows_pb * (f if groups == 1 else plan.feats_per_group) * 4 / 1e5,
            "partials": plan.grid_x * f * b * 12 / 1e6 * coop}


def _wide_cost(n: int, f: int, b: int, sms: int, plan: "LaunchPlan",
               resident=resident_blocks) -> float:
    """Modelled microseconds of one launch of a plan above 256 bins."""
    return sum(_WIDE_US[k] * v
               for k, v in _wide_terms(n, f, b, sms, plan, resident=resident).items())


_WIDE_WARPS = 16          # warps of a block above 256 bins (the kernel's launch bounds)
_RANGE_STEPS = (4, 5, 6, 8, 10, 12, 16, 20, 24, 32)   # ranges weighed, in quarters of the fewest


def wide_plans(n: int, num_features: int, num_bins: int, bin_bytes: int,
               num_sms: int, resident=resident_blocks) -> list:
    """Every plan `launch_plan` weighs above 256 bins, with its modelled
    microseconds: (us, plan). Groups of features; ranges of a feature's
    bins from the fewest that fit a block to eight times as many (in
    `_RANGE_STEPS`); a warp a feature and a power of two parts of the range
    (at most 16 warps); a tile of a row a thread or a power of two rows;
    and along the rows one block (a plain launch, any number of blocks) or
    any number up to what the SMs hold at once beside the groups and
    ranges (`resident` blocks an SM: a cooperative launch)."""
    f, b = num_features, num_bins
    out = []
    for groups, fg in _group_counts(f):
        if fg > _WIDE_WARPS:
            continue
        fewest = -(-b * fg * 16 // _SMEM_MAX)
        for ranges in sorted({-(-fewest * m // 4) for m in _RANGE_STEPS}):
            br = -(-b // ranges)
            if (ranges - 1) * br >= b:        # the last range would be empty
                continue
            gy = groups * ranges
            parts = 1
            while fg * parts <= _WIDE_WARPS:
                warps = fg * parts
                parts *= 2
                for rows in sorted({32 * warps} | {r for r in _WIDE_TILE_ROWS
                                                   if r < 32 * warps}, reverse=True):
                    buf, pitch = _staging(f, fg, groups, bin_bytes, rows)
                    smem = _smem_bytes_wide(fg, br, warps, rows, buf)
                    if smem > _SMEM_MAX:
                        continue
                    held = resident(32 * warps, smem)
                    if held < 1:                      # the block does not fit an SM
                        continue
                    tiles = -(-n // rows)
                    # one block along the rows always (a plain launch), more
                    # only where the grid is co-resident
                    most = max(1, min(tiles, held * num_sms // gy))
                    for gx in range(1, most + 1):
                        per = -(-tiles // gx)
                        if -(-tiles // per) != gx:    # the same as fewer blocks
                            continue
                        plan = LaunchPlan(gx, gy, fg, warps, 1, rows, per, buf, pitch, smem,
                                          br, ranges)
                        out.append((_wide_cost(n, f, b, num_sms, plan, resident), plan))
    return out


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, num_features: int, num_bins: int, bin_bytes: int,
                num_sms: int, resident=resident_blocks) -> LaunchPlan:
    """The launch for n rows of F features.

    Up to 256 bins: all features in one block if their histograms fit in
    shared memory, else feature groups along grid_y; the largest row tile
    that fits, at most one row a thread; W = min(features, 32) warps per
    histogram copy and as many copies as fill 32 warps; the rows spread
    over as many blocks as the SMs take, at most one block an SM (the grid
    barrier needs every block resident), or one block along the rows where
    the groups alone fill the card. (Two tiles a block at least, 64 blocks
    at the Adult shape in place of 128, took 14.4 us of device time against
    12.1: PERF.md, K1's versions.)

    Above 256 bins: the plan of `wide_plans` with the least modelled time,
    (feature group, bin range) along grid_y, its cooperative grids no
    larger than `resident(threads, shared memory bytes)` blocks an SM hold.
    Any B launches; F x B at or past 2**31 raises ValueError, as the JAX
    package's int32 ids overflow there."""
    if num_bins > _NARROW_BINS:
        if num_features * num_bins >= _MAX_IDS:
            raise ValueError(
                f"{num_features} features of {num_bins} bins: F x B must stay below 2**31, "
                f"where the JAX package's int32 histogram ids overflow")
        return min(wide_plans(n, num_features, num_bins, bin_bytes, num_sms, resident),
                   key=lambda cp: cp[0])[1]
    groups, fg, warps, copies, rows, buf, pitch, smem = _block(num_features, num_bins,
                                                               bin_bytes)
    tiles = -(-n // rows)
    grid_x_max = num_sms // groups
    per = -(-tiles // grid_x_max) if grid_x_max >= 2 else tiles
    grid_x = -(-tiles // per)
    return LaunchPlan(grid_x, groups, fg, warps, copies, rows, per, buf, pitch, smem,
                      num_bins, 1)


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
            i32, i32,                                          # bins a range, ranges
            ptr, ptr, i32, ptr,                                # partials, out, device, stream
        ]
        lib.mmlspark_hist_build.restype = i32
        lib.mmlspark_hist_resident_blocks.argtypes = [i32, i32, i32, i32, i32, ptr]
        lib.mmlspark_hist_resident_blocks.restype = i32
        lib.mmlspark_hist_empty.argtypes = [i32, i32, i32, i32, ptr]
        lib.mmlspark_hist_empty.restype = i32
        lib.mmlspark_cuda_error_string.argtypes = [i32]
        lib.mmlspark_cuda_error_string.restype = ctypes.c_char_p
        lib._mmlspark_bound = True
    return lib


_SMS: dict = {}           # device index -> SM count
_PARTIALS: dict = {}      # (device index, stream) -> the largest partials buffer so far
_RESIDENT: dict = {}      # (device index, bin bytes) -> its `resident` function


def _num_sms(dev: int) -> int:
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _resident_on(dev: int, bin_bytes: int):
    """`resident` of `launch_plan` on card `dev` above 256 bins: the blocks
    an SM holds from the runtime's occupancy of the kernel, once per
    (threads, shared memory bytes). One function per (card, bin bytes), so
    `launch_plan`'s cache keeps its plans."""
    key = (dev, bin_bytes)
    fn = _RESIDENT.get(key)
    if fn is None:
        @functools.lru_cache(maxsize=None)
        def fn(threads: int, smem_bytes: int) -> int:
            lib, blocks = _lib(), ctypes.c_int(0)
            code = lib.mmlspark_hist_resident_blocks(bin_bytes, 1, threads, smem_bytes, dev,
                                                     ctypes.byref(blocks))
            if code != 0:
                raise RuntimeError("histogram kernel occupancy query failed: "
                                   + lib.mmlspark_cuda_error_string(code).decode())
            return blocks.value
        fn = _RESIDENT[key] = fn
    return fn


def device_plan(n: int, num_features: int, num_bins: int, bin_bytes: int,
                dev: int) -> LaunchPlan:
    """The plan `histogram` launches on card `dev`: `launch_plan` at its SM
    count, above 256 bins with the blocks an SM holds from the runtime."""
    resident = _resident_on(dev, bin_bytes) if num_bins > _NARROW_BINS else resident_blocks
    return launch_plan(n, num_features, num_bins, bin_bytes, _num_sms(dev), resident)


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
    launches the kernel once (the same bits on every launch) at any
    num_bins, or raises where F x num_bins reaches 2**31 (`launch_plan`).
    Bins outside [0, num_bins) are dropped by the kernel. The call neither
    syncs nor allocates beyond the output once its scratch exists, so it
    can be captured in a CUDA graph."""
    _check(bins, stats, num_bins)
    if bins.device.type == "cpu":
        return histogram_torch(bins, stats, num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"histogram runs on cuda or cpu tensors, not {bins.device}")
    n, f = bins.shape
    if n == 0:
        return torch.zeros((f, num_bins, _CHANNELS), dtype=torch.float32, device=bins.device)
    dev = bins.device.index if bins.device.index is not None else torch.cuda.current_device()
    plan = device_plan(n, f, int(num_bins), bins.element_size(), dev)
    out = torch.empty((f, num_bins, _CHANNELS), dtype=torch.float32, device=bins.device)
    _launch(bins, stats, out, plan, dev)
    histogram.launches += 1
    return out


def _launch(bins: torch.Tensor, stats: torch.Tensor, out: torch.Tensor, plan: LaunchPlan,
            dev: int) -> None:
    """One launch of the kernel under `plan` into `out` (F, B, 3)."""
    n, f = bins.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials = (_partials(bins.device, stream, plan.grid_x * out.numel())
                if plan.grid_x > 1 else out)
    lib = _lib()
    code = lib.mmlspark_hist_build(
        bins.data_ptr(), bins.element_size(), stats.data_ptr(), n, f, out.shape[1],
        plan.grid_x, plan.grid_y, plan.feats_per_group, plan.warps_per_copy, plan.copies,
        plan.tile_rows, plan.tiles_per_block, plan.bins_buf_bytes, plan.gather_pitch,
        plan.smem_bytes, plan.bins_per_range, plan.ranges, partials.data_ptr(), out.data_ptr(),
        dev, stream)
    if code != 0:
        raise RuntimeError("histogram kernel launch failed: "
                           + lib.mmlspark_cuda_error_string(code).decode())


histogram.launches = 0
