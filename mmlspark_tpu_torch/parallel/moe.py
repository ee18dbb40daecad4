"""Expert parallelism: a mixture-of-experts feed-forward layer with
capacity-based top-1 routing and all-to-all dispatch over a mesh axis.

Counterpart of mmlspark_tpu/parallel/moe.py (Switch-Transformer style).
Tokens are sharded over the same axis that shards the experts; routing
builds a fixed-capacity (tokens, experts, capacity) dispatch tensor
(overflow tokens drop, the standard capacity_factor trade), and two
`collectives.all_to_all`s move token slabs to their experts' ranks and
back. `moe_ffn_sharded` runs on each rank of a 1-D expert mesh (a process
group) with its own tokens and its own experts' weights.

`init_moe` draws from a `torch.Generator`: its weights are not the JAX
package's `jax.random` ones (tests carry those across).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import collectives as C
from .mesh import Mesh

__all__ = ["EXPERT_AXIS", "MoEParams", "init_moe", "moe_ffn_local", "moe_ffn_sharded"]

EXPERT_AXIS = "expert"


class MoEParams(NamedTuple):
    w_gate: torch.Tensor   # (d, E)
    w1: torch.Tensor       # (E, d, h)
    b1: torch.Tensor       # (E, h)
    w2: torch.Tensor       # (E, h, d)
    b2: torch.Tensor       # (E, d)


def init_moe(gen: torch.Generator, d: int, h: int, n_experts: int,
             dtype=torch.float32, device: "str | torch.device" = "cpu") -> MoEParams:
    """He-scaled normal weights (the reference's scales), zero biases."""
    s1, s2 = (2.0 / d) ** 0.5, (2.0 / h) ** 0.5

    def normal(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float32).to(device, dtype)

    return MoEParams(
        w_gate=normal(d, n_experts) * s1,
        w1=normal(n_experts, d, h) * s1,
        b1=torch.zeros((n_experts, h), dtype=dtype, device=device),
        w2=normal(n_experts, h, d) * s2,
        b2=torch.zeros((n_experts, d), dtype=dtype, device=device),
    )


def _route(x, w_gate, n_experts: int, capacity: int):
    """Top-1 routing -> (dispatch (T, E, C) 0/1, combine (T, E, C)
    gate-weighted). A token's slot in its expert's capacity is its rank
    among that expert's tokens (a cumsum of the one-hot); ranks at or past
    the capacity drop. The ranks count in int32, never in x's dtype: a
    bf16 cumsum cannot count past 256 and would merge two tokens into one
    slot."""
    scores = torch.softmax(x @ w_gate, dim=-1)                     # (T, E)
    expert = torch.argmax(scores, dim=-1)                          # (T,)
    onehot_i = F.one_hot(expert, n_experts).to(torch.int32)       # (T, E)
    pos = torch.cumsum(onehot_i, dim=0, dtype=torch.int32) * onehot_i - 1
    keep = (pos >= 0) & (pos < capacity)
    onehot = onehot_i.to(x.dtype)
    # one_hot of a position outside [0, capacity) is all zeros, as jax's
    pos_oh = F.one_hot(torch.where(keep, pos, capacity).long(), capacity + 1)[..., :capacity]
    dispatch = onehot[:, :, None] * pos_oh.to(x.dtype) * keep.to(x.dtype)[:, :, None]
    gate = torch.sum(scores * onehot, dim=-1)                      # (T,) top-1 prob
    combine = dispatch * gate[:, None, None]
    return dispatch, combine


def _gelu(t):
    return F.gelu(t, approximate="tanh")          # jax.nn.gelu's default


def _expert_ffn(params: MoEParams, slabs):
    """slabs (E_local, C, d) -> (E_local, C, d) through the local experts."""
    hid = _gelu(torch.einsum("ecd,edh->ech", slabs, params.w1) + params.b1[:, None, :])
    return torch.einsum("ech,ehd->ecd", hid, params.w2) + params.b2[:, None, :]


def moe_ffn_local(params: MoEParams, x, capacity_factor: float = 1.25):
    """One device, the full expert set, no collectives."""
    t, _ = x.shape
    e = params.w_gate.shape[1]
    cap = max(int(capacity_factor * t / e), 1)
    dispatch, combine = _route(x, params.w_gate, e, cap)
    slabs = torch.einsum("tec,td->ecd", dispatch, x)               # (E, C, d)
    out = _expert_ffn(params, slabs)
    return torch.einsum("tec,ecd->td", combine, out)


def moe_ffn_sharded(params: MoEParams, x, mesh: Mesh, capacity_factor: float = 1.25):
    """This rank's tokens through the experts of the 1-D mesh `mesh`.

    x: (T_local, d), this rank's tokens. params: LOCAL experts — w1, b1,
    w2, b2 with leading dim E_local = E / mesh.size — and the whole w_gate
    (scores need every expert). The first all-to-all regroups the
    (E, C, d) dispatch slabs so each rank holds its experts' tokens from
    every rank; the second sends the expert outputs back."""
    n_shards = mesh.size
    t_local, d = x.shape
    e_local = params.w1.shape[0]
    e = e_local * n_shards
    cap = max(int(capacity_factor * t_local / e), 1)

    dispatch, combine = _route(x, params.w_gate, e, cap)           # (T_l, E, C)
    slabs = torch.einsum("tec,td->ecd", dispatch, x)               # (E, C, d)
    slabs = slabs.reshape(n_shards, e_local, cap, d)
    inbound = C.all_to_all(slabs.contiguous(), mesh, split_axis=0, concat_axis=0)
    inbound = inbound.permute(1, 0, 2, 3).reshape(e_local, n_shards * cap, d)
    out = _expert_ffn(params, inbound)                             # (E_l, S*C, d)
    out = out.reshape(e_local, n_shards, cap, d).permute(1, 0, 2, 3).contiguous()
    outbound = C.all_to_all(out, mesh, split_axis=0, concat_axis=0)  # (S, E_l, C, d)
    outbound = outbound.reshape(e, cap, d)
    return torch.einsum("tec,ecd->td", combine, outbound)
