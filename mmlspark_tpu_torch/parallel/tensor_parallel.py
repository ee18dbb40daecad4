"""Tensor-parallel building blocks (Megatron-style column/row sharding).

Counterpart of mmlspark_tpu/parallel/tensor_parallel.py. There the layers
run under `shard_map` over the "model" axis; here every rank of the mesh's
model axis (`mesh.axis("model")`, a process group) calls them with its own
block of the weights. A column-parallel matmul (no communication on entry,
output sharded on features) followed by a row-parallel matmul (features
sharded in, ONE psum out) is the MLP block with a single all-reduce.

`gathered_column_parallel` is the bit-exact layout: every output element
is one full-contraction dot, the tiled all-gather only concatenates
disjoint feature slices. `ring_all_gather` schedules that gather as n-1
ring hops. `column_block` cuts a rank's block of a dense tree's weights,
the port's form of the reference's `dense_column_specs` (a rank holds its
block as a plain tensor, so no placement objects exist).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

from . import collectives as C
from .mesh import MODEL_AXIS, Mesh

__all__ = [
    "column_parallel",
    "row_parallel",
    "ring_all_gather",
    "gathered_column_parallel",
    "column_block",
    "dense_column_blocks",
    "make_tp_mlp",
]


def column_parallel(x, w_local, b_local=None):
    """x replicated on the model axis, w sharded on OUTPUT features.
    Returns the output sharded on features; no collective."""
    y = torch.einsum("...i,io->...o", x.float(), w_local.float())
    if b_local is not None:
        y = y + b_local
    return y


def row_parallel(x_local, w_local, mesh: Mesh, b=None):
    """x and w sharded on INPUT features: ONE psum over the model axis
    reassembles the output (differentiable: `psum_autograd`)."""
    y = torch.einsum("...i,io->...o", x_local.float(), w_local.float())
    y = C.psum_autograd(y, mesh)
    if b is not None:
        y = y + b
    return y


def ring_all_gather(y, mesh: Mesh, axis: int = -1):
    """The tiled all-gather as n-1 ring hops (`ppermute_ring`, receiving
    from the next shard): after hop k this rank holds shard (i+k)'s block,
    so the received order is the ring rotated by i and one roll restores
    shard order. Blocks are moved, never added: the same bits as
    `collectives.all_gather(tiled=True)`."""
    n = mesh.size
    if n == 1:
        return y
    axis %= y.dim()
    blocks, blk = [y], y
    for _ in range(n - 1):
        blk = C.ppermute_ring(blk, mesh, reverse=True)
        blocks.append(blk)
    out = torch.cat(blocks, dim=axis)
    return torch.roll(out, mesh.shard_index * y.shape[axis], dims=axis)


def gathered_column_parallel(x, w_local, b_local, mesh: Mesh, ring: bool = False):
    """Column-parallel dense, then a tiled all-gather: every rank leaves
    with the FULL output features, each one full-contraction dot, so the
    result is the unsharded matmul's. `ring` schedules the gather as ring
    hops (same bytes)."""
    y = column_parallel(x, w_local, b_local)
    if ring:
        return ring_all_gather(y, mesh, axis=y.dim() - 1)
    return C.all_gather(y, mesh, axis=y.dim() - 1, tiled=True)


def column_block(leaf, index: int, n: int):
    """A rank's block of one dense leaf under column parallelism: a 2-D
    kernel's OUTPUT features (the last axis), a 1-D bias's same slice,
    anything else whole."""
    nd = getattr(leaf, "ndim", None)
    if nd in (1, 2):
        size = leaf.shape[-1]
        if size % n:
            raise ValueError(f"{size} output features do not split over {n} ranks")
        per = size // n
        return leaf[..., index * per:(index + 1) * per]
    return leaf


def dense_column_blocks(params: Any, mesh: Mesh, model_axis: str = MODEL_AXIS) -> Any:
    """This rank's blocks of a {layer: {"kernel", "bias"}} tree (flax's
    dense layout) under column parallelism over `model_axis`."""
    sub = mesh.axis(model_axis)
    if isinstance(params, dict):
        return {k: dense_column_blocks(v, mesh, model_axis) for k, v in params.items()}
    return column_block(params, sub.shard_index, sub.size)


def make_tp_mlp(mesh: Mesh, model_axis: str = MODEL_AXIS,
                activation: Callable = F.gelu):
    """The 2-layer tensor-parallel MLP over `model_axis`:
    fn(x (B, F), w1 (F, H), b1 (H,), w2 (H, F), b2 (F,)) -> (B, F) with the
    FULL weights given on every rank; each rank computes with its block of
    H (w1's and b1's columns, w2's rows) and ONE psum joins them. The
    activation defaults to the tanh GELU, `jax.nn.gelu`'s default."""
    sub = mesh.axis(model_axis)
    if activation is F.gelu:
        activation = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731

    def fn(x, w1, b1, w2, b2):
        n, i = sub.size, sub.shard_index
        if w1.shape[1] % n:
            raise ValueError(f"hidden {w1.shape[1]} does not split over {n} ranks")
        per = w1.shape[1] // n
        cols = slice(i * per, (i + 1) * per)
        h = activation(column_parallel(x, w1[:, cols], b1[cols]))
        return row_parallel(h, w2[cols], sub, b2)

    return fn
