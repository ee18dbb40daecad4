"""Single-device attention: dense, chunked, and the flash forward (K2).

Counterpart of mmlspark_tpu/nn/attention.py, with its public names and
its (B, T, H, D) layout: q (B, Tq, H, D), k and v (B, Tk, H, D), output
(B, Tq, H, D).

- `dense_attention`: full (Tq, Tk) scores, -inf masking, fully masked rows
  give zeros; follows the input dtype throughout. The port's own copy of
  mmlspark_tpu/parallel/ring_attention.py:49-63.
- `chunked_attention`: online softmax over key chunks, scores and
  accumulator in f32 (attention.py:63).
- `flash_attention`: the wrapper of K2, the hand-written CUDA kernel in
  csrc/flash_attn.cu that replaces the Pallas TPU kernel
  `_flash_fwd_lse`. On a CUDA tensor it launches the kernel `flash_plan`
  names or raises; on a CPU tensor it runs `flash_attention_torch`.
  `flash_attention.launches` counts kernel launches,
  `flash_attention.launches_by_path` counts them by kernel, and
  `flash_attention.last_path` names the kernel of the last one ("tf32x3",
  "wgmma", "mma" or "wide"). Forward only: the backward comes with the
  trainer (ROADMAP Queue 1, P4 trainer item).
- `flash_plan`: which kernel a (dtype, head dim, shape) takes on a card,
  at which built head dim, whether the inputs need a pad copy, and its
  query rows a block or work item.
- `flash_attention_torch`: the plain version of K2, a transcription of
  `_flash_kernel` (attention.py:139-189) over key blocks; returns
  (out, lse). The CPU tests use it, and chip_smoke.py holds the kernel
  against it on the card.
- `SelfAttention`: the param-compatible self-attention module (query, key,
  value, out with flax DenseGeneral layouts) with a selectable core.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch import nn

from ..core import kernels
from .layers import Dense

__all__ = ["dense_attention", "chunked_attention", "flash_attention",
           "flash_attention_torch", "flash_plan", "FlashPlan", "SelfAttention",
           "HEAD_DIMS"]

_NEG_INF = -1e30          # the TPU kernel's mask value: keeps exp/max NaN-free
HEAD_DIMS = (8, 16, 32, 64, 128)      # head dims K2 is built for; D <= 128 pads up
WGMMA_WIDE_DIMS = (192, 256)      # bf16 head dims in (128, 256] run at these, unpadded
IMPLS = ("dense", "chunked", "flash")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = ("mma", "wgmma", "tf32x3", "wide")      # the kernel's path codes
# the "wide" kernel: 64-column chunks a block holds at most (shared memory),
# and warps a block at most (csrc/flash_attn.cu, WideTiling, kWideMaxWarps)
_WIDE_MAX_COLS = {torch.float32: 5, torch.bfloat16: 10}
_WIDE_MAX_WARPS = 12


def dense_attention(q, k, v, causal: bool = False, q_offset: int = 0,
                    k_offset: int = 0):
    """Reference math: full softmax attention in the input dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device) + k_offset
        mask = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    # fully masked rows (causal with every key in the future) -> zeros
    p = torch.where(torch.isfinite(s).any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def chunked_attention(q, k, v, causal: bool = False, q_chunk: int = 128,
                      k_chunk: int = 128):
    """Online-softmax attention over key chunks; scores and accumulator in
    f32, output in q's dtype. Same contract as `dense_attention`."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    q_chunk = min(q_chunk, max(tq, 1))
    k_chunk = min(k_chunk, max(tk, 1))
    scale = d ** -0.5
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, tq, q_chunk):
        qb = q[:, q0:q0 + q_chunk].float()
        qpos = q0 + torch.arange(qb.shape[1], device=q.device)
        m = torch.full((b, h, qb.shape[1]), _NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, qb.shape[1], d), device=q.device)
        for k0 in range(0, tk, k_chunk):
            kb, vb = kf[:, k0:k0 + k_chunk], vf[:, k0:k0 + k_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            kpos = k0 + torch.arange(kb.shape[1], device=q.device)
            ok = qpos[:, None] >= kpos[None, :] if causal else None
            if ok is not None:
                s = torch.where(ok, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            if ok is not None:
                # masked entries contribute 0 even when the whole row is masked
                p = torch.where(ok, p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        out = torch.where((l > 0)[..., None], out, 0.0)
        outs.append(out.permute(0, 2, 1, 3))
    if not outs:
        return q.new_zeros(q.shape)
    return torch.cat(outs, dim=1).to(q.dtype)


def flash_attention_torch(q, k, v, causal: bool = False, block_q: int = 128,
                          block_k: int = 128):
    """Plain version of K2: `_flash_kernel` over key blocks of `block_k`
    (the query blocks of the TPU grid are independent, so all rows go at
    once; `block_q` changes nothing). Returns (out (B, Tq, H, D) in q's
    dtype, lse (B, H, Tq) f32)."""
    del block_q
    b, tq, h, d = q.shape
    tk = k.shape[1]
    block_k = min(block_k, max(tk, 1))
    scale = d ** -0.5
    qf = q.permute(0, 2, 1, 3).float()                  # (B, H, Tq, D)
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3)
    m = torch.full((b, h, tq), _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, tq, d), device=q.device)
    qpos = torch.arange(tq, device=q.device)
    for k0 in range(0, tk, block_k):
        kb = kf[:, :, k0:k0 + block_k]
        vb = vf[:, :, k0:k0 + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        kpos = k0 + torch.arange(kb.shape[2], device=q.device)
        ok = (kpos < tk)[None, :].expand(tq, -1)
        if causal:
            ok = ok & (qpos[:, None] >= kpos[None, :])
        s = torch.where(ok, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # masked entries contribute 0 even when the whole row is masked
        # (then m_new == _NEG_INF and exp(s - m_new) == 1, not 0)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        # the PV product sees p in v's dtype, accumulated in f32
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where((l > 0)[..., None], out, 0.0)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      float("inf"))
    return out.to(q.dtype).permute(0, 2, 1, 3).contiguous(), lse


def _check(q, k, v) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in the port: its backward comes "
            "with the trainer (ROADMAP Queue 1, 'P4: DNN' — trainer and the "
            "K2 backward); call it under torch.no_grad()")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, T, H, D)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k and v must be (B, Tk, H, D) with q's B, H, D: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d < 1:
        raise ValueError(f"head dim {d} is not a head dim: q, k, v need D >= 1")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k, v must have a contiguous last (head) dim")


def _lib() -> ctypes.CDLL:
    lib = kernels.load("flash_attn")
    if not getattr(lib, "_mmlspark_bound", False):
        lib.mmlspark_flash_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.mmlspark_flash_fwd.restype = ctypes.c_int
        lib.mmlspark_flash_error_string.argtypes = [ctypes.c_int]
        lib.mmlspark_flash_error_string.restype = ctypes.c_char_p
        lib._mmlspark_bound = True
    return lib


class FlashPlan(NamedTuple):
    """How K2 runs on a card: the kernel (`path`), its built head dim
    (`d_kernel`), the head dim of the tensors it reads (`width`: the true D,
    or the D they are zero-padded to), whether that takes a pad copy
    (`pad`), and the query rows of a block or work item (`rows`)."""
    path: str
    d_kernel: int
    width: int
    pad: bool
    rows: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flash_plan(dtype, d: int, b: int, h: int, tq: int, sms: int) -> FlashPlan:
    """The plan of a K2 launch on a card with `sms` SMs for q (b, tq, h, d).

    - f32 up to D 128: "tf32x3", zero-padded to the next built head dim
      (HEAD_DIMS), 128 rows a block.
    - bf16 up to D 32: "mma" at 8, 16 or 32, padded likewise; 128 rows (8
      warps) a block where 128-row blocks give every SM one, else 32 (2
      warps).
    - bf16 above 32 and up to 256: "wgmma" at 64 or 128 (padded up to
      them), or at 192 or 256 (WGMMA_WIDE_DIMS) on the tensors' true D,
      whose columns past D the tensor maps read as zeros: a pad copy only
      where D is no multiple of 8 (rows must be 16 bytes), to the next
      multiple. 128 rows (two consumer warpgroups) a work item; at D 192,
      where 128-row items would leave SMs idle, 64 (one warpgroup), twice
      the items; at D 256 always 64 (two warpgroups ran slower there at
      any fill, and at D 64 the 64-row items did).
    - f32 above 128 and bf16 above 256: "wide" on the true D (a pad copy
      only to the next multiple of 4 in f32, 8 in bf16); its column warps
      are the D's 64-column chunks (at most 5 in f32, 10 in bf16), and a
      block takes 16 rows a row group, as many row groups (up to 4) as 12
      warps allow."""
    if d < 1:
        raise ValueError(f"head dim {d} is not a head dim: q, k, v need D >= 1")
    f32 = dtype == torch.float32
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"K2 takes float32 or bfloat16, not {dtype}")
    fills = b * h * -(-tq // 128) >= sms           # 128-row tiles give every SM one
    if f32 and d <= HEAD_DIMS[-1] or not f32 and d <= 32:
        dk = next(x for x in HEAD_DIMS if x >= d)
        rows = 128 if f32 or fills else 32
        return FlashPlan("tf32x3" if f32 else "mma", dk, dk, dk != d, rows)
    if not f32 and d <= WGMMA_WIDE_DIMS[-1]:
        if d <= HEAD_DIMS[-1]:
            dk = width = next(x for x in HEAD_DIMS if x >= d)
        else:
            dk = next(x for x in WGMMA_WIDE_DIMS if x >= d)
            width = _round_up(d, 8)
        rows = 64 if dk == 256 or dk == 192 and not fills else 128
        return FlashPlan("wgmma", dk, width, width != d, rows)
    width = _round_up(d, 4 if f32 else 8)
    cols = min(-(-width // 64), _WIDE_MAX_COLS[dtype])
    return FlashPlan("wide", width, width, width != d, 16 * min(4, _WIDE_MAX_WARPS // cols))


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _flash_fwd_lse(q, k, v, causal: bool = False, block_q: int = 128,
                   block_k: int = 128):
    """K2 forward: (out (B, Tq, H, D) in q's dtype, lse (B, H, Tq) f32).

    A CPU tensor runs `flash_attention_torch` (with these block sizes). A
    CUDA tensor launches the kernel `flash_plan` names, whose own tiles
    replace the block sizes, or raises; `flash_attention.last_path` then
    names it: "tf32x3" (f32 up to D 128, 3xTF32 on the tensor cores),
    "mma" (bf16, D up to 32), "wgmma" (bf16, D above 32 up to 256) or
    "wide" (f32 above D 128, bf16 above 256). A head dim up to 128 between
    the built ones runs zero-padded to the next one (D 24 on "mma" at 32,
    D 96 on "wgmma" at 128), above 128 on its true D unless its rows
    cannot be 16 bytes (then padded to the next multiple of 4 in f32, 8 in
    bf16); always at the true D's scale. Every path runs on the tensor
    cores and needs 16-byte aligned rows; a CUDA tensor without them
    raises."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal, block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    plan = flash_plan(q.dtype, d, b, h, tq, _sms(dev))
    # zero columns leave every score, and so lse, unchanged as long as the
    # scale stays the true D's; the padded copies are fresh, so aligned
    if plan.pad:
        q, k, v = (torch.nn.functional.pad(t, (0, plan.width - d)) for t in (q, k, v))
    # every path copies rows to shared memory 16 bytes at a time (tf32x3,
    # mma, wide) or through TMA tensor maps (wgmma): 16-byte aligned base
    # and strides
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(st % per16 for st in t.stride()[:3]):
            raise ValueError(f"{str(q.dtype).replace('torch.', '')} {name} must have "
                             "16-byte aligned rows (data pointer and strides in "
                             f"multiples of {per16} elements)")
    out = torch.empty((b, tq, h, plan.width), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out[..., :d], lse
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    lib = _lib()
    code = lib.mmlspark_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h, tq, tk, plan.width, int(bool(causal)), d ** -0.5,
        strides, dev, torch.cuda.current_stream(dev).cuda_stream,
        _PATHS.index(plan.path), plan.d_kernel, plan.rows)
    if code != 0:
        raise RuntimeError(f"flash attention kernel launch failed ({plan}): "
                           + lib.mmlspark_flash_error_string(code).decode())
    flash_attention.launches += 1
    flash_attention.last_path = plan.path
    by_path = flash_attention.launches_by_path
    by_path[plan.path] = by_path.get(plan.path, 0) + 1
    return (out[..., :d] if plan.pad else out), lse


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128,
                    block_k: int = 128):
    """Flash attention forward, same contract as `dense_attention`: K2 on a
    CUDA tensor, its plain version on a CPU tensor. Inputs that require
    grad under grad mode raise NotImplementedError."""
    return _flash_fwd_lse(q, k, v, causal, block_q, block_k)[0]


flash_attention.launches = 0
flash_attention.launches_by_path = {}
flash_attention.last_path = None


class SelfAttention(nn.Module):
    """Multi-head self-attention with a selectable core.

    Submodules query, key, value (flax DenseGeneral (D, H, D/H)) and out
    ((H, D/H, D)): the parameter tree of flax's MultiHeadDotProductAttention
    and of the JAX package's SelfAttention, for every impl.

    impl: "dense", "chunked" or "flash". "flash" is K2 on a CUDA tensor and
    its plain version on a CPU tensor; it never turns into chunked."""

    def __init__(self, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, impl: str = "dense",
                 causal: bool = False):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}")
        if d_model % num_heads:
            raise ValueError(f"d_model={d_model} not divisible by num_heads={num_heads}")
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.impl = impl
        self.causal = causal
        self.dtype = dtype
        hd = (num_heads, self.head_dim)
        for name in ("query", "key", "value"):
            setattr(self, name, Dense(d_model, d_model, dtype,
                                      kernel_shape=(d_model, *hd), bias_shape=hd))
        self.out = Dense(d_model, d_model, dtype, kernel_shape=(*hd, d_model))

    def _heads(self, proj: Dense, x: torch.Tensor) -> torch.Tensor:
        return proj(x).unflatten(-1, (self.num_heads, self.head_dim))

    def attend(self, q, k, v):
        if self.impl == "dense":
            return dense_attention(q, k, v, causal=self.causal)
        if self.impl == "chunked":
            return chunked_attention(q, k, v, causal=self.causal)
        return flash_attention(q, k, v, causal=self.causal)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self._heads(self.query, x)
        k = self._heads(self.key, x)
        v = self._heads(self.value, x)
        return self.out(self.attend(q, k, v).flatten(-2))


class MultiHeadDotProductAttention(SelfAttention):
    """flax `nn.MultiHeadDotProductAttention` without mask or dropout: the
    query is divided by sqrt(depth) before the score product and the softmax
    runs in the compute dtype. TransformerEncoder(attention_impl="dense")
    uses it; its parameters are SelfAttention's."""

    def __init__(self, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(d_model, num_heads, dtype, impl="dense")

    def attend(self, q, k, v):
        depth = torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32)
        q = q / depth.to(q.dtype)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)
