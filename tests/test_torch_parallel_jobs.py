"""Jobs that the ranks of a `RankPool` run for the port's parallel-layer
tests (tests/test_torch_parallel_p4.py): ring and Ulysses attention on a
sequence axis, the tensor-parallel MLP on a model axis, the GPipe
pipeline, MoE dispatch, the mesh's axes and `use_mesh` serving.

A rank is a spawned process, so this module imports only numpy, torch and
mmlspark_tpu_torch. Every rank of the pool runs every job, in the same
order, and builds the job's mesh (process groups are collective); a rank
outside the mesh returns None. Inputs arrive whole; each rank takes its
block and returns (shard index, its block of the result).
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.parallel import collectives as C
from mmlspark_tpu_torch.parallel import make_mesh
from mmlspark_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

_MESHES: dict = {}


def _mesh(kind: str, *args, **kw):
    key = (kind, args, tuple(sorted(kw.items())))
    if key not in _MESHES:
        if kind == "pipe":
            from mmlspark_tpu_torch.parallel.pipeline_parallel import make_pipe_mesh

            _MESHES[key] = make_pipe_mesh(*args, **kw)
        else:
            _MESHES[key] = make_mesh(*args, **kw)
    return _MESHES[key]


def _member(mesh) -> bool:
    return torch.distributed.get_rank() in mesh.ranks


def _block(a: np.ndarray, i: int, n: int, axis: int) -> torch.Tensor:
    size = a.shape[axis] // n
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(i * size, (i + 1) * size)
    return torch.as_tensor(np.ascontiguousarray(a[tuple(idx)]))


def attention(impl: str, q, k, v, causal: bool, local_chunk, n_seq: int, grads: bool = False,
              device: str = "cpu"):
    """Ring or Ulysses attention over a seq axis of `n_seq` ranks on this
    rank's sequence block; with `grads`, also the gradients of the sum of
    squared outputs (over every rank) for q, k and v, each rank's block."""
    from mmlspark_tpu_torch.parallel.ring_attention import (make_ring_attention,
                                                            make_ulysses_attention)

    mesh = _mesh("grid", n_data=1, n_seq=n_seq)
    seq = mesh.axis(SEQ_AXIS)
    i = seq.shard_index
    make = make_ring_attention if impl == "ring" else make_ulysses_attention
    fn = make(mesh, SEQ_AXIS, causal=causal, local_chunk=local_chunk)
    qb, kb, vb = (_block(a, i, n_seq, 1).to(device).requires_grad_(grads) for a in (q, k, v))
    C.reset_stats()
    if device == "cuda":
        torch.cuda.synchronize()
    import time

    t0 = time.perf_counter()
    out = fn(qb, kb, vb)
    if device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    moved = C.stats()["bytes"]
    result = {"shard": i, "out": out.detach().cpu().numpy(), "ms": ms, "bytes": moved}
    if grads:
        (out.float() ** 2).sum().backward()
        result.update({name: t.grad.cpu().numpy() for name, t in
                       (("dq", qb), ("dk", kb), ("dv", vb))})
    return result


def tp_mlp(x, w1, b1, w2, b2, n_model: int, ring: bool = False):
    """The TP MLP over a model axis of `n_model` ranks, and the bit-exact
    gathered column-parallel dense of x @ w1 + b1 (all-gather or ring)."""
    from mmlspark_tpu_torch.parallel.tensor_parallel import (gathered_column_parallel,
                                                             make_tp_mlp)

    mesh = _mesh("grid", n_data=1, n_model=n_model)
    sub = mesh.axis(MODEL_AXIS)
    t = [torch.as_tensor(a) for a in (x, w1, b1, w2, b2)]
    out = make_tp_mlp(mesh, MODEL_AXIS)(*t)
    i, n = sub.shard_index, sub.size
    per = w1.shape[1] // n
    cols = slice(i * per, (i + 1) * per)
    gathered = gathered_column_parallel(t[0], t[1][:, cols], t[2][cols], sub, ring=ring)
    return {"shard": i, "out": out.numpy(), "gathered": gathered.numpy()}


def _stage_fn(params, x):
    w, b = params
    return x + torch.tanh(x @ w + b)


def pipeline(ws, bs, x, n_micro: int, n_stages: int):
    from mmlspark_tpu_torch.parallel.pipeline_parallel import pipeline_forward

    mesh = _mesh("pipe", n_stages)
    if not _member(mesh):
        return None
    out = pipeline_forward(_stage_fn, (torch.as_tensor(ws), torch.as_tensor(bs)),
                           torch.as_tensor(x), n_micro=n_micro, mesh=mesh)
    return {"shard": mesh.shard_index, "out": out.numpy()}


def moe(params: dict, x, capacity_factor: float, n_shards: int, grads: bool = False):
    """This rank's tokens through `moe_ffn_sharded` on an expert axis of
    `n_shards` ranks holding E / n_shards experts each; with `grads`, the
    gradients of the sum of squared outputs for this rank's expert
    weights and its tokens."""
    from mmlspark_tpu_torch.parallel.moe import MoEParams, moe_ffn_sharded

    mesh = _mesh("grid", ranks=tuple(range(n_shards)))
    if not _member(mesh):
        return None
    i = mesh.shard_index
    local = MoEParams(
        w_gate=torch.as_tensor(params["w_gate"]),
        **{k: _block(params[k], i, n_shards, 0) for k in ("w1", "b1", "w2", "b2")})
    if grads:
        local = MoEParams(*(p.requires_grad_(True) for p in local))
    xb = _block(x, i, n_shards, 0).requires_grad_(grads)
    out = moe_ffn_sharded(local, xb, mesh, capacity_factor=capacity_factor)
    result = {"shard": i, "out": out.detach().numpy()}
    if grads:
        (out ** 2).sum().backward()
        result.update({"dw1": local.w1.grad.numpy(), "dw2": local.w2.grad.numpy(),
                       "dx": xb.grad.numpy()})
    return result


def axes(n_data: int, n_seq: int, n_model: int):
    """The grid's shape, and for each axis the ranks of this rank's line,
    its place on it, and a psum of the global rank along it."""
    mesh = _mesh("grid", n_data=n_data, n_seq=n_seq, n_model=n_model)
    rank = torch.distributed.get_rank()
    if rank not in mesh.ranks:
        return None
    out = {"shape": mesh.shape, "rank": rank}
    for name in (DATA_AXIS, SEQ_AXIS, MODEL_AXIS):
        sub = mesh.axis(name)
        total = C.psum(torch.tensor([float(rank)]), sub)
        out[name] = {"ranks": list(sub.ranks), "index": sub.shard_index,
                     "psum": float(total[0])}
    return out


def serve(bundle_bytes: bytes, x, fetch: dict, mini_batch_size: int, ranks,
          device: str = "cpu"):
    """DeepModelTransformer(use_mesh=True) on a data mesh of `ranks`: the
    whole table's outputs on every rank of the mesh, and the K2 launches
    this rank made (`flash_attention.launches` counts card launches)."""
    from mmlspark_tpu_torch.core.schema import Table
    from mmlspark_tpu_torch.nn.attention import flash_attention
    from mmlspark_tpu_torch.nn.models import ModelBundle
    from mmlspark_tpu_torch.nn.runner import DeepModelTransformer
    from mmlspark_tpu_torch.parallel.mesh import use_mesh

    mesh = _mesh("grid", ranks=tuple(ranks), device=device)
    if not _member(mesh):
        return None
    bundle = ModelBundle.from_bytes(bundle_bytes)
    before = flash_attention.launches
    with use_mesh(mesh):
        out = DeepModelTransformer(input_col="x", fetch_dict=fetch,
                                   mini_batch_size=mini_batch_size, use_mesh=True,
                                   device=device).set_model(bundle).transform(Table({"x": x}))
    launched = flash_attention.launches - before
    return {"shard": mesh.shard_index,
            "cols": {c: np.asarray(out[c]) for c in fetch}, "launches": launched}
