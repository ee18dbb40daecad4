"""Ring attention and Ulysses sequence parallelism for long contexts.

Counterpart of mmlspark_tpu/parallel/ring_attention.py. There one SPMD
program runs under `shard_map` with the sequence sharded over a mesh axis;
here every rank of the mesh's sequence axis (`mesh.axis("seq")`, a process
group) calls the function with its own contiguous block of the sequence,
(B, T/n, H, D), and gets its block of the output back:

  - **Ring attention**: each rank keeps its Q block and the K/V blocks
    rotate one hop a step (`collectives.ppermute_ring`). Softmax is
    accumulated online (running max and denominator) in f32, so no rank
    ever holds the (T, T) scores; positions are global, so causal masking
    is by the block's origin. `local_chunk` folds each hop's K/V block in
    chunks under the same online state, bounding the score tile at
    (T/n, local_chunk).
  - **Ulysses**: one `collectives.all_to_all` reshards (seq-sharded ->
    head-sharded), every rank runs exact attention on the full sequence
    for its H/n heads (`nn.attention.dense_attention`, or the chunked
    online-softmax core with `local_chunk`), and a second all-to-all
    reshards back.

Both are torch ops, as the reference's are XLA ops, not a Pallas kernel:
nothing here launches K2. Both differentiate (the collectives carry their
gradients), and every rank of the axis must run the backward.
"""

from __future__ import annotations

import functools

import torch

from . import collectives as C
from .mesh import SEQ_AXIS, Mesh

__all__ = [
    "dense_attention",
    "ring_attention",
    "ulysses_attention",
    "make_ring_attention",
    "make_ulysses_attention",
]


def dense_attention(q, k, v, causal: bool = False, q_offset: int = 0, k_offset: int = 0):
    """The reference math (nn/attention.py's one copy)."""
    from ..nn.attention import dense_attention as _dense

    return _dense(q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset)


def _online_update(o, l, m, q, k_blk, v_blk, qpos, kpos, causal: bool, scale: float):
    """One online-softmax accumulation of a K/V block into (o, l, m): o
    (B, Tq, H, D), l and m (B, H, Tq), all f32. The running max m only
    shifts the exponentials, which the final o / l cancels, so it is held
    out of the gradient: the derivative stays exact."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
        scores = scores.masked_fill(~mask[None, None], float("-inf"))
    finite = torch.isfinite(scores)
    m_new = torch.maximum(m, scores.detach().amax(dim=-1))
    # a fully masked block keeps m_new at -inf: shift by 0 there
    safe_m = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), torch.zeros_like(m))
    p = torch.exp(torch.where(finite, scores - safe_m[..., None], torch.zeros_like(scores)))
    p = torch.where(finite, p, torch.zeros_like(p))
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v_blk.float())
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, l_new, m_new


def _n_chunks(t_local: int, local_chunk: "int | None") -> int:
    if local_chunk is not None and local_chunk < 1:
        raise ValueError(f"local_chunk={local_chunk} must be >= 1")
    if local_chunk and local_chunk < t_local:
        if t_local % local_chunk:
            raise ValueError(
                f"local_chunk={local_chunk} must divide the per-rank sequence length {t_local}")
        return t_local // local_chunk
    return 1


def ring_attention_local(q, k, v, mesh: Mesh, causal: bool = False,
                         local_chunk: "int | None" = None):
    """This rank's block of ring attention over the 1-D mesh `mesh` (shard
    i holds positions [i T/n, (i+1) T/n)). q, k, v: (B, T/n, H, D)."""
    b, t_local, h, d = q.shape
    scale = d ** -0.5
    n_dev = mesh.size
    my = mesh.shard_index
    n_chunks = _n_chunks(t_local, local_chunk)
    dev = q.device
    qpos = torch.arange(t_local, device=dev) + my * t_local
    o = torch.zeros((b, t_local, h, d), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=dev)
    m = torch.full((b, h, t_local), float("-inf"), device=dev)
    k_blk, v_blk = k.float(), v.float()
    for s in range(n_dev):
        src = (my - s) % n_dev              # origin shard of the block held now
        k_off = src * t_local
        if n_chunks == 1:
            kpos = torch.arange(t_local, device=dev) + k_off
            o, l, m = _online_update(o, l, m, q, k_blk, v_blk, qpos, kpos, causal, scale)
        else:
            c = local_chunk
            for ci in range(n_chunks):
                kpos = torch.arange(c, device=dev) + k_off + ci * c
                o, l, m = _online_update(o, l, m, q, k_blk[:, ci * c:(ci + 1) * c],
                                         v_blk[:, ci * c:(ci + 1) * c], qpos, kpos,
                                         causal, scale)
        if s + 1 < n_dev:
            # the last hop would bring the blocks home unused
            k_blk = C.ppermute_ring(k_blk, mesh)
            v_blk = C.ppermute_ring(v_blk, mesh)
    denom = torch.where(l > 0, l, torch.ones_like(l)).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)


def make_ring_attention(mesh: Mesh, seq_axis: str = SEQ_AXIS, causal: bool = False,
                        local_chunk: "int | None" = None):
    """fn(q, k, v) of this rank's sequence blocks over `seq_axis` of
    `mesh`. `local_chunk` bounds the per-hop score tile."""
    return functools.partial(ring_attention_local, mesh=mesh.axis(seq_axis), causal=causal,
                             local_chunk=local_chunk)


def ring_attention(q, k, v, mesh: Mesh, seq_axis: str = SEQ_AXIS, causal: bool = False,
                   local_chunk: "int | None" = None):
    return make_ring_attention(mesh, seq_axis, causal, local_chunk)(q, k, v)


def ulysses_attention_local(q, k, v, mesh: Mesh, causal: bool = False,
                            local_chunk: "int | None" = None):
    """This rank's block of exact attention through two all-to-alls over
    the 1-D mesh `mesh`: (B, T/n, H, D) -> heads -> (B, T, H/n, D) ->
    attention -> back. The head count must divide over the ranks."""
    if local_chunk is not None and local_chunk < 1:
        raise ValueError(f"local_chunk={local_chunk} must be >= 1")
    if q.shape[2] % mesh.size:
        raise ValueError(f"{q.shape[2]} heads do not divide over {mesh.size} ranks")

    def to_heads(x):
        return C.all_to_all(x, mesh, split_axis=2, concat_axis=1)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    if local_chunk:
        from ..nn.attention import chunked_attention

        out = chunked_attention(qh, kh, vh, causal=causal, q_chunk=local_chunk,
                                k_chunk=local_chunk)
    else:
        out = dense_attention(qh, kh, vh, causal=causal)
    return C.all_to_all(out, mesh, split_axis=1, concat_axis=2)


def make_ulysses_attention(mesh: Mesh, seq_axis: str = SEQ_AXIS, causal: bool = False,
                           local_chunk: "int | None" = None):
    """fn(q, k, v) of this rank's sequence blocks: Ulysses attention over
    `seq_axis` of `mesh`. `local_chunk` bounds the post-all-to-all score
    tile."""
    return functools.partial(ulysses_attention_local, mesh=mesh.axis(seq_axis),
                             causal=causal, local_chunk=local_chunk)


def ulysses_attention(q, k, v, mesh: Mesh, seq_axis: str = SEQ_AXIS, causal: bool = False,
                      local_chunk: "int | None" = None):
    return make_ulysses_attention(mesh, seq_axis, causal, local_chunk)(q, k, v)
