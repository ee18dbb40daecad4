"""Layers with flax.linen's numerics, in PyTorch.

The JAX package builds its models from flax layers (`nn.Dense`,
`nn.DenseGeneral`, `nn.Embed`, `nn.LayerNorm`, `nn.Conv`, `nn.BatchNorm`).
These modules compute what those compute, in the same order and the same
dtypes, so that the same weights give the same outputs:

- parameters stay in their stored dtype (float32 from `init`, bfloat16
  after the runner's `bfloat16=True` cast) and are cast to the layer's
  compute `dtype` at each use, as flax's `promote_dtype` does;
- `LayerNorm` is flax's, not torch's: epsilon 1e-6, variance
  E[x^2] - E[x]^2 clipped at 0, statistics in f32 whatever the input;
- `BatchNorm` normalises by the stored statistics (epsilon 1e-5), or
  under a `TrainMode` by the batch's, as flax's
  `BatchNorm(use_running_average=False)` does;
- `Embed` gathers like `jnp.take`'s default "fill" mode: ids in
  [-V, 0) wrap, ids outside [-V, V) give NaN rows instead of raising;
- `Conv` takes and returns NHWC (the JAX package's layout) and keeps
  its weight OIHW inside; 'SAME' padding is XLA's, lower half first.

Torch's promotion rules match JAX's for every mix used here (bf16 op f32
-> f32, bf16 op python float -> bf16), so the expressions follow flax's
term for term.

Each layer names its flax leaves: `flax_leaves()` gives them in the flax
layout (numpy) and `load_flax_leaves()` installs them, and `flax_names`
maps its parameters to their leaves. nn/carry.py walks a model with these;
it is the one place that converts layouts.

`TrainMode` is the counterpart of flax's `train=True` with
`mutable=["batch_stats"]` and a "dropout" rng: while one is active
(`with TrainMode(model, key):`), `BatchNorm` normalises by the batch's
moments and records its new running statistics in `mode.stats` instead of
changing its buffers, and attention dropout draws its masks from
`mode.make_rng`. A forward recomputed under torch.utils.checkpoint runs in
a mode of its own, with the same key, so it draws the same masks and
leaves the first run's statistics alone.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..core import prng

__all__ = ["Dense", "LayerNorm", "Embed", "Conv", "BatchNorm", "same_padding",
           "max_pool", "TrainMode", "current_train_mode"]

_ACTIVE = threading.local()


class TrainMode:
    """A train-mode forward's state: the step's "dropout" key, the mesh
    whose shards hold the global batch (None: one device), and the new
    BatchNorm statistics it records (`stats`: module -> (mean, var), f32,
    detached)."""

    def __init__(self, model: nn.Module, key, mesh=None):
        self.model = model
        self.key = key
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.stats: dict = {}
        self._paths: "dict | None" = None
        self._rng_calls: dict = {}

    def make_rng(self, module: nn.Module):
        """flax's `make_rng("dropout")` in `module`: the step's key folded
        (`fold_in_static`) with the module's path and its count of calls."""
        if self._paths is None:
            self._paths = {id(m): tuple(n.split(".")) if n else ()
                           for n, m in self.model.named_modules()}
        path = self._paths[id(module)]
        calls = self._rng_calls[path] = self._rng_calls.get(path, 0) + 1
        return prng.fold_in_static(self.key, path + (calls,))

    def __enter__(self) -> "TrainMode":
        self._prior = getattr(_ACTIVE, "mode", None)
        _ACTIVE.mode = self
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.mode = self._prior


def current_train_mode() -> "TrainMode | None":
    return getattr(_ACTIVE, "mode", None)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _as_tensor(a, like: torch.Tensor) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device=like.device)


class Dense(nn.Module):
    """flax `nn.Dense` and `nn.DenseGeneral`: y = x @ W + b in `dtype`.

    The weight is (out, in), torch's layout. `kernel_shape`/`bias_shape`
    are the flax leaves' shapes (a DenseGeneral's (D, H, D/H) or
    (H, D/H, D)), which the carry reshapes to and from."""

    flax_names = {"weight": "kernel", "bias": "bias"}

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, use_bias: bool = True,
                 kernel_shape: tuple | None = None, bias_shape: tuple | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.kernel_shape = tuple(kernel_shape or (in_features, out_features))
        self.bias_shape = tuple(bias_shape or (out_features,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y

    def flax_leaves(self) -> dict:
        leaves = {("params", "kernel"): _to_numpy(self.weight.t().reshape(self.kernel_shape))}
        if self.bias is not None:
            leaves[("params", "bias")] = _to_numpy(self.bias.reshape(self.bias_shape))
        return leaves

    def load_flax_leaves(self, leaves: dict) -> None:
        out_f, in_f = self.weight.shape
        kernel = _as_tensor(leaves[("params", "kernel")], self.weight)
        self.weight.data = kernel.reshape(in_f, out_f).t().contiguous()
        if self.bias is not None:
            self.bias.data = _as_tensor(leaves[("params", "bias")], self.bias).reshape(out_f)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis (epsilon 1e-6, fast variance,
    f32 statistics); the output is cast to `dtype`."""

    flax_names = {"weight": "scale", "bias": "bias"}

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 epsilon: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        mu2 = (xf * xf).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        y = x - mu
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = y * mul + self.bias
        return y.to(self.dtype)

    def flax_leaves(self) -> dict:
        return {("params", "scale"): _to_numpy(self.weight),
                ("params", "bias"): _to_numpy(self.bias)}

    def load_flax_leaves(self, leaves: dict) -> None:
        self.weight.data = _as_tensor(leaves[("params", "scale")], self.weight)
        self.bias.data = _as_tensor(leaves[("params", "bias")], self.bias)


class Embed(nn.Module):
    """flax `nn.Embed`: rows of the (V, D) table cast to `dtype`, gathered
    as `jnp.take` does by default (see the module docstring)."""

    flax_names = {"weight": "embedding"}

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if ids.is_floating_point():
            raise ValueError("Input type must be an integer or unsigned integer.")
        table = self.weight.to(self.dtype)
        v = table.shape[0]
        if v == 1:
            return table.expand(*ids.shape, table.shape[1])
        idx = ids.long()
        inside = (idx >= -v) & (idx < v)
        idx = torch.where(idx < 0, idx + v, idx).clamp(0, v - 1)
        rows = F.embedding(idx, table)
        return torch.where(inside[..., None], rows, torch.full((), float("nan"),
                                                               dtype=rows.dtype,
                                                               device=rows.device))

    def flax_leaves(self) -> dict:
        return {("params", "embedding"): _to_numpy(self.weight)}

    def load_flax_leaves(self, leaves: dict) -> None:
        self.weight.data = _as_tensor(leaves[("params", "embedding")], self.weight)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's 'SAME' padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax `nn.Conv` with 'SAME' padding on NHWC input; weight OIHW."""

    flax_names = {"weight": "kernel", "bias": "bias"}

    def __init__(self, in_features: int, features: int, kernel_size: tuple[int, int],
                 strides: tuple[int, int] = (1, 1), use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.strides = tuple(strides)
        self.weight = nn.Parameter(torch.empty(features, in_features, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        kh, kw = self.weight.shape[2:]
        (ht, hb) = same_padding(x.shape[1], kh, self.strides[0])
        (wl, wr) = same_padding(x.shape[2], kw, self.strides[1])
        xc = x.to(dt).permute(0, 3, 1, 2)
        if ht == hb and wl == wr:
            y = F.conv2d(xc, self.weight.to(dt), None, self.strides, (ht, wl))
        else:
            y = F.conv2d(F.pad(xc, (wl, wr, ht, hb)), self.weight.to(dt), None,
                         self.strides)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y

    def flax_leaves(self) -> dict:
        leaves = {("params", "kernel"): _to_numpy(self.weight.permute(2, 3, 1, 0))}
        if self.bias is not None:
            leaves[("params", "bias")] = _to_numpy(self.bias)
        return leaves

    def load_flax_leaves(self, leaves: dict) -> None:
        hwio = _as_tensor(leaves[("params", "kernel")], self.weight)
        self.weight.data = hwio.permute(3, 2, 0, 1).contiguous()
        if self.bias is not None:
            self.bias.data = _as_tensor(leaves[("params", "bias")], self.bias)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the last axis: `use_running_average=True`
    outside a `TrainMode`, False inside one.

    In train mode the moments are flax's `_compute_stats`: E[x] and E[x^2]
    over every axis but the last, in f32, var = max(0, E[x^2] - E[x]^2);
    under a mesh of several shards the sums cover the global batch (one
    `psum_autograd` of both). The new running statistics, momentum *
    stored + (1 - momentum) * batch, go to `mode.stats`; the buffers stay
    as they are until the trainer installs them."""

    flax_names = {"weight": "scale", "bias": "bias"}

    momentum = 0.99          # flax's default, which the JAX package's models keep

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 epsilon: float = 1e-5, scale_init_zero: bool = False):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.zeros(features) if scale_init_zero
                                   else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = current_train_mode()
        if mode is None:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = self._batch_moments(x, mode.mesh)
            m = self.momentum
            mode.stats[self] = (m * self.running_mean + (1 - m) * mean.detach(),
                                m * self.running_var + (1 - m) * var.detach())
        y = x - mean
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = y * mul + self.bias
        return y.to(self.dtype)

    @staticmethod
    def _batch_moments(x: torch.Tensor, mesh) -> tuple:
        xf = x.float()
        axes = tuple(range(x.dim() - 1))
        if mesh is None:
            mu, mu2 = xf.mean(axes), (xf * xf).mean(axes)
        else:
            from ..parallel.collectives import psum_autograd

            count = x.numel() // x.shape[-1] * mesh.size
            sums = psum_autograd(torch.stack([xf.sum(axes), (xf * xf).sum(axes)]), mesh)
            mu, mu2 = sums[0] / count, sums[1] / count
        return mu, torch.clamp(mu2 - mu * mu, min=0.0)

    def flax_leaves(self) -> dict:
        return {("params", "scale"): _to_numpy(self.weight),
                ("params", "bias"): _to_numpy(self.bias),
                ("batch_stats", "mean"): _to_numpy(self.running_mean),
                ("batch_stats", "var"): _to_numpy(self.running_var)}

    def load_flax_leaves(self, leaves: dict) -> None:
        self.weight.data = _as_tensor(leaves[("params", "scale")], self.weight)
        self.bias.data = _as_tensor(leaves[("params", "bias")], self.bias)
        self.running_mean = _as_tensor(leaves[("batch_stats", "mean")], self.running_mean)
        self.running_var = _as_tensor(leaves[("batch_stats", "var")], self.running_var)


def max_pool(x: torch.Tensor, window: tuple[int, int], strides: tuple[int, int],
             same: bool = False) -> torch.Tensor:
    """flax `nn.max_pool` on NHWC: 'VALID', or 'SAME' with -inf padding."""
    xc = x.permute(0, 3, 1, 2)
    if same:
        (ht, hb) = same_padding(x.shape[1], window[0], strides[0])
        (wl, wr) = same_padding(x.shape[2], window[1], strides[1])
        xc = F.pad(xc, (wl, wr, ht, hb), value=float("-inf"))
    return F.max_pool2d(xc, window, strides).permute(0, 2, 3, 1)
