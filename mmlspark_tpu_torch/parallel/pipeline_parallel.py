"""Pipeline parallelism: GPipe-style microbatched stage execution over a
mesh axis.

Counterpart of mmlspark_tpu/parallel/pipeline_parallel.py. There one SPMD
program runs under `shard_map` and device i applies stage i; here rank i
of the pipeline mesh (a process group) applies stage i. Activations hop
one stage to the right each micro-step (`collectives.ppermute_ring`), and
microbatches stream through so every stage is busy after the fill: the
GPipe schedule of fill, steady state and drain, n_micro + n_stages - 1
micro-steps. A stage computes only on micro-steps that hold a real
microbatch for it (the reference computes on the fill's zeros and throws
the result away; the outputs are the same). At the end the last stage's
outputs are psum-med, so every rank leaves with the full result.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from . import collectives as C
from .mesh import Mesh, _group_for, _world

PIPE_AXIS = "pipe"

__all__ = ["PIPE_AXIS", "make_pipe_mesh", "pipeline_apply", "pipeline_forward"]


def make_pipe_mesh(n_stages: int, ranks: "Sequence[int] | None" = None,
                   device: "str | torch.device | None" = None) -> Mesh:
    """A 1-axis mesh whose only axis is the pipeline-stage axis: rank
    `ranks[i]` (default: rank i) runs stage i. Every rank of the world
    calls it (its process group is collective)."""
    world = _world()
    ranks = tuple(range(n_stages)) if ranks is None else tuple(int(r) for r in ranks)
    if len(ranks) != n_stages:
        raise ValueError(f"{n_stages} stages but {len(ranks)} ranks given")
    if n_stages > world:
        raise ValueError(f"need {n_stages} processes, have {world}")
    if device is not None:
        from ..core.kernels import resolve_device

        device = resolve_device(device)
    return Mesh(ranks, _group_for(ranks), device, (PIPE_AXIS,))


def pipeline_apply(stage_fn: Callable, n_stages: int, mesh: Mesh) -> Callable:
    """The pipeline body for this rank: body(stage_params, microbatches)
    -> outputs, where `stage_params` are THIS rank's stage's and
    `microbatches` is the (n_micro, mb, ...) input, the same on every
    rank. `stage_fn(stage_params, x) -> y` applies one stage; every stage
    keeps the activation's shape. Every rank returns the full
    (n_micro, mb, ...) output."""
    if mesh.size != n_stages:
        raise ValueError(f"mesh of {mesh.size} ranks for {n_stages} stages")

    def body(stage_params, microbatches):
        n_micro = microbatches.shape[0]
        idx = mesh.shard_index
        is_first, is_last = idx == 0, idx == n_stages - 1
        state = torch.zeros_like(microbatches[0])
        outputs = []
        for t in range(n_micro + n_stages - 1):
            mine = t - idx                  # the microbatch at this stage now
            if 0 <= mine < n_micro:
                y = stage_fn(stage_params, microbatches[mine] if is_first else state)
            else:
                y = torch.zeros_like(state)
            if is_last and mine >= 0 and mine < n_micro:
                outputs.append(y)
            state = C.ppermute_ring(y, mesh)
        out = torch.stack(outputs) if is_last else torch.zeros_like(microbatches)
        return C.psum_autograd(out.contiguous(), mesh)

    return body


def _stage_slice(params: Any, i: int) -> Any:
    if isinstance(params, (tuple, list)):
        return type(params)(_stage_slice(p, i) for p in params)
    if isinstance(params, dict):
        return {k: _stage_slice(v, i) for k, v in params.items()}
    return params[i]


def _leaves(params: Any) -> list:
    if isinstance(params, (tuple, list)):
        return [leaf for p in params for leaf in _leaves(p)]
    if isinstance(params, dict):
        return [leaf for v in params.values() for leaf in _leaves(v)]
    return [params]


def pipeline_forward(stage_fn: Callable, params_stacked: Any, x: torch.Tensor, n_micro: int,
                     mesh: Mesh) -> torch.Tensor:
    """The pipelined forward: `params_stacked` holds every stage's params
    with a leading stage axis (rank i takes slice i), `x` the (batch, ...)
    input, the same on every rank, split into `n_micro` microbatches.
    Returns the (batch, ...) output on every rank."""
    n_stages = mesh.size
    for leaf in _leaves(params_stacked):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"params leading dim {leaf.shape[0]} != pipeline stages {n_stages}")
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible into {n_micro} microbatches")
    xm = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    out = pipeline_apply(stage_fn, n_stages, mesh)(
        _stage_slice(params_stacked, mesh.shard_index), xm)
    return out.reshape(b, *out.shape[2:])
