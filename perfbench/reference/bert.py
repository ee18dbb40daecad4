"""Plain PyTorch reference of the pre-LN encoder classifier, in float32
with TF32 off. It imports nothing of the program under test.

The architecture is the port's `TransformerEncoder` as its docstrings
state it (and BERT-base's widths): token embedding plus a learned
position table; per layer x + Attn(LN(x)), then x + MLP(LN(x)) with a
tanh-approximated GELU; a final LayerNorm (epsilon 1e-6, scale and bias),
the mean over tokens and a dense head. BERT itself is post-LN; the
configuration file states the departure. Attention is softmax(q k^T /
sqrt(D)) v over all keys, no mask.

`gemm` swaps the matrix product: `fp8_gemm` is the control, every product
with both operands rounded to float8 e4m3 under a per-tensor scale, the
step below bfloat16 that a faster program could take."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def f32_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, batched over leading dimensions."""
    return a @ b


def fp8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    def q(t):
        scale = t.abs().amax().clamp(min=1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return q(a) @ q(b)


def _ln(x, w, b, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def forward(w: dict, cfg: dict, ids: torch.Tensor, gemm=f32_gemm) -> torch.Tensor:
    """Logits (rows, num_outputs) f32 of token ids (rows, tokens)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(w, cfg, ids, gemm)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _dense(x, w, b, gemm):
    shape = x.shape
    return (gemm(x.reshape(-1, shape[-1]), w.t()) + b).reshape(*shape[:-1], w.shape[0])


def _forward(w, cfg, ids, gemm):
    rows, t = ids.shape
    hds = cfg["num_heads"]
    dh = cfg["d_model"] // hds
    h = w["embed.weight"][ids] + w["pos_embed"][:t][None]
    for i in range(cfg["num_layers"]):
        x = _ln(h, w[f"ln_attn_{i}.weight"], w[f"ln_attn_{i}.bias"])
        q, k, v = (_dense(x, w[f"attn_{i}.{p}.weight"], w[f"attn_{i}.{p}.bias"], gemm)
                   .view(rows, t, hds, dh).transpose(1, 2) for p in ("query", "key", "value"))
        p = torch.softmax(gemm(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        o = gemm(p, v).transpose(1, 2).reshape(rows, t, hds * dh)
        h = h + _dense(o, w[f"attn_{i}.out.weight"], w[f"attn_{i}.out.bias"], gemm)
        x = _ln(h, w[f"ln_mlp_{i}.weight"], w[f"ln_mlp_{i}.bias"])
        x = F.gelu(_dense(x, w[f"mlp_up_{i}.weight"], w[f"mlp_up_{i}.bias"], gemm),
                   approximate="tanh")
        h = h + _dense(x, w[f"mlp_down_{i}.weight"], w[f"mlp_down_{i}.bias"], gemm)
    pooled = _ln(h, w["ln_final.weight"], w["ln_final.bias"]).mean(dim=1)
    return _dense(pooled, w["head.weight"], w["head.bias"], gemm)
