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
the host's enqueue time, not the card's transfer time.

Fusion under a mesh of several ranks (core/fusion.py) moves host data:
`broadcast_word` and `broadcast_arrays` send a control word and a dict of
host arrays from shard 0 to every rank (where only shard 0 holds a
server's request batch or a stream's micro-batch), `all_gather_rows`
gives every rank all shards' rows of host arrays (a fused segment's
outputs), and `all_gather_floats` every shard's few numbers (its
readback seconds and rows, for the shard-skew gauge). They carry bytes,
so every dtype travels exact; their tensors are CPU tensors under gloo and
card tensors under NCCL, and they are counted in `stats()` as the others
are. `pcast` has no
counterpart (it types JAX's shard_map carries; torch tensors carry no
such type).

`ppermute_ring` (one hop around the ring of shards, a send to the next and
a receive from the previous) and `all_to_all` (tiled: split one axis over
the shards, concatenate what arrives along another, in shard order) are
autograd functions, because ring attention, Ulysses and MoE differentiate
through them: a hop's gradient is the reverse hop, an all-to-all's the
all-to-all with the two axes swapped. Every rank of the mesh must run the
backward, in the same order.
"""

from __future__ import annotations

import json
import time

import numpy as np
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
    "ppermute_ring",
    "all_to_all",
    "axis_index",
    "axis_size",
    "psum_ordered",
    "psum_kahan",
    "psum_exact_fixedpoint",
    "broadcast_word",
    "broadcast_arrays",
    "all_gather_rows",
    "all_gather_floats",
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


def _ppermute_ring(x: torch.Tensor, mesh: Mesh, reverse: bool) -> torch.Tensor:
    """Shard i's x lands on shard i+1 (i-1 when `reverse`), mod the size."""
    n = mesh.size
    if n == 1:
        return x
    me = mesh.shard_index
    step = -1 if reverse else 1
    dst, src = mesh.ranks[(me + step) % n], mesh.ranks[(me - step) % n]
    buf, t0 = _begin(x.contiguous(), mesh)
    out = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, dst, mesh.group),
           dist.P2POp(dist.irecv, out, src, mesh.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _count(buf, t0)
    return out.to(x.device)


class _RingGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, reverse):
        ctx.mesh, ctx.reverse = mesh, reverse
        return _ppermute_ring(x, mesh, reverse)

    @staticmethod
    def backward(ctx, g):
        return _ppermute_ring(g.contiguous(), ctx.mesh, not ctx.reverse), None, None


def ppermute_ring(x: torch.Tensor, mesh: Mesh, reverse: bool = False) -> torch.Tensor:
    """Rotate shards one step around the ring (shard i's x to shard i+1),
    the building block of ring attention; `reverse` rotates the other way.
    Differentiable: the gradient hops back."""
    if mesh.size == 1:
        return x
    return _RingGrad.apply(x, mesh, bool(reverse))


def _all_to_all(x: torch.Tensor, mesh: Mesh, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = mesh.size
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not split over {n} shards")
    buf, t0 = _begin(x, mesh)
    chunks = [c.contiguous() for c in buf.chunk(n, dim=split_axis)]   # chunk j to shard j
    me = mesh.shard_index
    recv = [torch.empty_like(c) for c in chunks]
    recv[me] = chunks[me]
    # pairwise sends and receives: every backend has them (gloo has no
    # all_to_all in some builds)
    ops = []
    for s in range(n):
        if s != me:
            ops.append(dist.P2POp(dist.isend, chunks[s], mesh.ranks[s], mesh.group))
            ops.append(dist.P2POp(dist.irecv, recv[s], mesh.ranks[s], mesh.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = torch.cat(recv, dim=concat_axis)
    _count(buf, t0)
    return out.to(x.device)


class _AllToAllGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, split_axis, concat_axis):
        ctx.mesh, ctx.axes = mesh, (split_axis, concat_axis)
        return _all_to_all(x, mesh, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g.contiguous(), ctx.mesh, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, mesh: Mesh, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all (the Ulysses sequence <-> head reshard): `x` cut
    into `mesh.size` blocks along `split_axis`, block j sent to shard j,
    the blocks received concatenated along `concat_axis` in shard order.
    Differentiable: the gradient is the all-to-all with the axes swapped."""
    if mesh.size == 1:
        return x
    split_axis %= x.dim()
    concat_axis %= x.dim()
    return _AllToAllGrad.apply(x, mesh, split_axis, concat_axis)


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


# --------------------------------------------------------------------- #
# host data over the mesh (fusion under a mesh of several ranks)        #
# --------------------------------------------------------------------- #


def _wire_device(mesh: Mesh) -> torch.device:
    """Where a host collective's buffers live: the card under NCCL, else the CPU."""
    if dist.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast(buf: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    t0 = time.perf_counter()
    dist.broadcast(buf, src=mesh.ranks[0], group=mesh.group)
    _count(buf, t0)
    return buf


def broadcast_word(word, mesh: Mesh, size: int = 4) -> list:
    """Shard 0's `size` int64 control word on every rank (shard 0 passes
    it, the others None)."""
    if mesh.size == 1:
        return [int(v) for v in word]
    buf = torch.zeros(size, dtype=torch.int64, device=_wire_device(mesh))
    if mesh.shard_index == 0:
        if len(word) != size:
            raise ValueError(f"a control word has {size} ints, got {len(word)}")
        buf.copy_(torch.as_tensor([int(v) for v in word], dtype=torch.int64))
    return [int(v) for v in _broadcast(buf, mesh).cpu()]


def broadcast_arrays(arrays, mesh: Mesh) -> dict:
    """Shard 0's {name: host ndarray} on every rank, dtypes and shapes
    exact (shard 0 passes the dict, the others None): a header of names,
    dtypes and shapes, then every array's bytes in one buffer."""
    if mesh.size == 1:
        return {k: np.asarray(v) for k, v in arrays.items()}
    dev = _wire_device(mesh)
    if mesh.shard_index == 0:
        arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        header = json.dumps([[k, a.dtype.str, list(a.shape)] for k, a in arrays.items()]).encode()
        payload = b"".join(a.tobytes() for a in arrays.values())
        sizes = broadcast_word([len(header), len(payload), 0, 0], mesh)
    else:
        sizes = broadcast_word(None, mesh)
    head = torch.empty(sizes[0], dtype=torch.uint8, device=dev)
    body = torch.empty(sizes[1], dtype=torch.uint8, device=dev)
    if mesh.shard_index == 0:
        head.copy_(torch.frombuffer(bytearray(header), dtype=torch.uint8))
        if sizes[1]:
            body.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    header = bytes(_broadcast(head, mesh).cpu().numpy())
    raw = _broadcast(body, mesh).cpu().numpy() if sizes[1] else np.zeros(0, np.uint8)
    out, at = {}, 0
    for name, dtype, shape in json.loads(header):
        dt = np.dtype(dtype)
        n = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        out[name] = raw[at:at + n].view(dt).reshape(shape).copy()
        at += n
    return out


def all_gather_rows(arrays, mesh: Mesh) -> list:
    """Every shard's rows of each host array, concatenated in shard order
    along axis 0. Each shard passes arrays of one row count (a shard's
    block); the arrays travel as their rows' bytes side by side in one
    all-gather, so every dtype comes back bit for bit."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if mesh.size == 1:
        return arrays
    rows = arrays[0].shape[0] if arrays else 0
    widths = [a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64)) for a in arrays]
    packed = np.concatenate([a.view(np.uint8).reshape(rows, w)
                             for a, w in zip(arrays, widths)], axis=1)
    buf = torch.from_numpy(packed).to(_wire_device(mesh))
    every = torch.cat(_gather_shards(buf, mesh), dim=0).cpu().numpy()
    out, at = [], 0
    for a, w in zip(arrays, widths):
        part = np.ascontiguousarray(every[:, at:at + w])
        out.append(part.view(a.dtype).reshape((every.shape[0],) + a.shape[1:]))
        at += w
    return out


def all_gather_floats(values, mesh: Mesh):
    """(shards, k) float64 ndarray: each shard's k numbers, in shard order."""
    x = torch.as_tensor(np.asarray(values, np.float64)).reshape(1, -1)
    if mesh.size == 1:
        return x.numpy()
    return torch.cat(_gather_shards(x.to(_wire_device(mesh)), mesh), dim=0).cpu().numpy()
