"""Collectives over a mesh's process group, and the deterministic reductions.

Counterpart of mmlspark_tpu/parallel/collectives.py. There a collective is
an XLA op over a `shard_map` axis; here it is a `torch.distributed` call on
the mesh's group (`psum` is `all_reduce(SUM)`, `pmax`/`pmin` are
`all_reduce(MAX/MIN)`, `all_gather` and `reduce_scatter` their
namesakes). Each takes the `Mesh` where the JAX package takes an axis name,
returns a new tensor on the input's device, and does nothing on a
one-shard mesh (the value is already the total).

Gloo reduces CPU tensors. A card tensor under a gloo group (ranks that
share one card) goes to the host, through the collective and back; that
copy waits for the card's queue, as any read back does. NCCL takes card
tensors as they are.

The substance is deterministic reduction, as in the reference. A float
`all_reduce` adds the shards in whatever order the backend's ring or tree
takes, so a near-tied split gain can flip between orders:

  * `psum_ordered`   — all-gather the shard partials and fold them left to
    right in shard order: the same bits on every rank, whatever the
    backend or the shard -> rank table.
  * `psum_kahan`     — the same fold, Neumaier-compensated.
  * `psum_exact_fixedpoint` — quantize to integer multiples of a shared
    per-channel scale such that every partial sum stays below 2**23, then
    a plain `all_reduce`: integer adds in float32 are exact, so the result
    is the same bits under any order and any permutation, and equal to the
    JAX package's on the same inputs (the scale is the reference's float32
    expression, `torch.round` rounds half to even as `jnp.round` does).

`GrowConfig.deterministic` routes the GBDT histogram merge through the
fixed-point reduction (gbdt/engine.py).

`stats()` counts the calls, the bytes each rank contributed and the host
seconds spent in them since `reset_stats()`; under NCCL the seconds are
the host's enqueue time, not the card's transfer time. `pcast` has no
counterpart (it types JAX's shard_map carries; torch tensors carry no
such type). `ppermute_ring` and `all_to_all` wait for ROADMAP.md Queue 1,
item 12c.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = [
    "psum",
    "psum_autograd",
    "pmean",
    "pmax",
    "pmin",
    "all_gather",
    "reduce_scatter",
    "axis_index",
    "axis_size",
    "psum_ordered",
    "psum_kahan",
    "psum_exact_fixedpoint",
    "stats",
    "reset_stats",
]

_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def stats() -> dict:
    """{"calls", "bytes", "seconds"} of this process's collectives since
    the last `reset_stats()`."""
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(calls=0, bytes=0, seconds=0.0)


def _staged(x: torch.Tensor, mesh: Mesh) -> bool:
    """Whether the backend needs the tensor on the host (gloo, card tensor)."""
    return x.device.type == "cuda" and dist.get_backend(mesh.group) != "nccl"


def _begin(x: torch.Tensor, mesh: Mesh) -> tuple:
    """(the buffer the collective overwrites, the start time)."""
    if _staged(x, mesh):
        # the copy waits for the card anyway: wait first, so the time
        # counted is the collective's and not the queued kernels'
        torch.cuda.synchronize(x.device)
        return x.to("cpu", copy=True), time.perf_counter()
    return x.clone(), time.perf_counter()


def _count(buf: torch.Tensor, t0: float) -> None:
    _STATS["calls"] += 1
    _STATS["bytes"] += buf.numel() * buf.element_size()
    _STATS["seconds"] += time.perf_counter() - t0


def _all_reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    if mesh.size == 1:
        return x
    buf, t0 = _begin(x.contiguous(), mesh)
    dist.all_reduce(buf, op=op, group=mesh.group)
    out = buf.to(x.device)
    _count(buf, t0)
    return out


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The histogram all-reduce (LightGBM's socket reduce-scatter and
    allgather)."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return psum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.mesh), None


def psum_autograd(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`psum` whose gradient is the psum of the shards' gradients: what XLA
    differentiates through a reduction over a sharded axis (the trainer's
    BatchNorm moments of the global batch). Every rank must run the
    backward, in the same order."""
    return x if mesh.size == 1 else _PsumGrad.apply(x, mesh)


def pmean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return psum(x, mesh) / mesh.size


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _all_reduce(x, mesh, dist.ReduceOp.MIN)


def _gather_shards(x: torch.Tensor, mesh: Mesh) -> list:
    """Every shard's x, in shard order (not group-rank order)."""
    if mesh.size == 1:
        return [x]
    buf, t0 = _begin(x.contiguous(), mesh)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    # the group lists its ranks sorted; shard s lives on mesh.ranks[s]
    by_rank = dict(zip(sorted(mesh.ranks), parts))
    ordered = [by_rank[r].to(x.device) for r in mesh.ranks]
    _count(buf, t0)
    return ordered


def all_gather(x: torch.Tensor, mesh: Mesh, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """The shards' x in shard order: concatenated along `axis` (tiled) or
    stacked on a new `axis`."""
    parts = _gather_shards(x, mesh)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, scatter_dimension: int = 0) -> torch.Tensor:
    """This shard's block of the sum along `scatter_dimension` (tiled).
    Gloo has no reduce-scatter, and a permuted mesh's blocks follow its
    shard table, so it is the sum's block on every backend."""
    total = psum(x, mesh)
    return total.chunk(mesh.size, dim=scatter_dimension)[axis_index(mesh)].contiguous()


def axis_index(mesh: Mesh) -> int:
    return mesh.shard_index


def axis_size(mesh: Mesh) -> int:
    return mesh.size


# --------------------------------------------------------------------- #
# deterministic reductions                                              #
# --------------------------------------------------------------------- #


def psum_ordered(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-reduce with a fixed summation order (shard 0, then 1, ...):
    every rank folds the same gathered operands left to right and gets the
    same bits, whatever the backend's own reduction order."""
    total = torch.zeros_like(x)
    for part in _gather_shards(x, mesh):
        total = total + part
    return total


def psum_kahan(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`psum_ordered` with Neumaier-compensated accumulation: the rounding
    error stays O(eps) whatever the shard count."""
    acc = torch.zeros_like(x)
    comp = torch.zeros_like(x)
    for part in _gather_shards(x, mesh):
        t = acc + part
        comp = comp + torch.where(acc.abs() >= part.abs(), (acc - t) + part, (part - t) + acc)
        acc = t
    return acc + comp


def psum_exact_fixedpoint(x: torch.Tensor, mesh: Mesh, *,
                          n_shards: "int | None" = None) -> torch.Tensor:
    """Bit-exact all-reduce under any reduction order and shard permutation
    (reference collectives.py:177-223, the same arithmetic).

    Each channel of the last axis (GBDT histograms stack [grad, hess,
    count] there) takes its own scale from the mesh-wide max |x| (`pmax`,
    order-free): scale = (2**23 / n_shards) / max(max_abs, 2**-100) in
    float32, 1 where max_abs is 0. The partials round to integers at that
    scale, the all-reduce adds integers below 2**23 exactly, and the sum
    divides back. Precision: about 2**23 steps of each channel's range."""
    if n_shards is None:
        n_shards = mesh.size
    x = x.to(torch.float32)
    if x.dim() >= 2:
        max_abs = pmax(x.abs().amax(dim=tuple(range(x.dim() - 1))), mesh)
    else:
        max_abs = pmax(x.abs().amax(), mesh)
    budget = torch.tensor((2.0 ** 23) / n_shards, dtype=torch.float32, device=x.device)
    floor = torch.tensor(2.0 ** -100, dtype=torch.float32, device=x.device)
    scale = budget / torch.maximum(max_abs, floor)
    scale = torch.where(max_abs > 0, scale, torch.ones_like(scale))
    q = torch.round(x * scale)            # integer-valued float32
    return psum(q, mesh) / scale
