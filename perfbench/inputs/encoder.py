"""Weights and token ids of the pre-LN encoder classifier, made on the
device from a seed.

`param_spec` names every parameter as `TransformerEncoder` of the port
names it (torch layout: a dense weight is (out, in)), so the harness can
load them into the port by name and the reference can read them by the
same names. Every weight and bias is N(0, std) and every LayerNorm scale
1 + N(0, std) (BERT's initializer range, std 0.02), drawn by one
`torch.randn` of all parameters on the device's generator."""

from __future__ import annotations

import torch


def param_spec(cfg: dict) -> list[tuple[str, tuple]]:
    d, ff, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    spec = [("embed.weight", (v, d)), ("pos_embed", (cfg["max_len"], d))]
    for i in range(cfg["num_layers"]):
        spec += [(f"ln_attn_{i}.weight", (d,)), (f"ln_attn_{i}.bias", (d,))]
        for proj in ("query", "key", "value", "out"):
            spec += [(f"attn_{i}.{proj}.weight", (d, d)), (f"attn_{i}.{proj}.bias", (d,))]
        spec += [(f"ln_mlp_{i}.weight", (d,)), (f"ln_mlp_{i}.bias", (d,)),
                 (f"mlp_up_{i}.weight", (ff, d)), (f"mlp_up_{i}.bias", (ff,)),
                 (f"mlp_down_{i}.weight", (d, ff)), (f"mlp_down_{i}.bias", (d,))]
    spec += [("ln_final.weight", (d,)), ("ln_final.bias", (d,)),
             ("head.weight", (cfg["num_outputs"], d)), ("head.bias", (cfg["num_outputs"],))]
    return spec


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> f32 tensor on `device`, views of one flat draw."""
    spec = param_spec(cfg)
    total = sum(torch.Size(s).numel() for _, s in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device).mul_(cfg["init_std"])
    out, at = {}, 0
    for name, shape in spec:
        n = torch.Size(shape).numel()
        w = flat[at:at + n].view(shape)
        if name.startswith("ln_") and name.endswith(".weight"):
            w.add_(1.0)
        out[name] = w
        at += n
    return out


def token_ids(calls: int, rows: int, tokens: int, vocab: int, seed: int, device) -> torch.Tensor:
    """(calls, rows, tokens) int64 ids, uniform over the vocabulary."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 1) % (2 ** 63))
    return torch.randint(0, vocab, (calls, rows, tokens), generator=gen, device=device)
