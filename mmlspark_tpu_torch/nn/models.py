"""Model architectures + the ModelBundle container, in PyTorch.

Counterpart of mmlspark_tpu/nn/models.py. Every architecture of its
`ARCHITECTURES` registry is an `nn.Module` here whose submodules carry the
flax module names (`dense_0`, `stage0_block0.conv1`, `attn_0.query`, ...),
so that the flax parameter tree maps onto it one to one (nn/carry.py) and
layer paths address the same layers. Layers follow flax's numerics
(nn/layers.py): parameters stay float32 and are cast to the model's
`dtype` at each use. Images are NHWC at the API.

Torch needs input widths when a module is built, where flax infers them
at the first call, so every architecture takes the per-example
`input_shape` first.

`ModelBundle` keeps `variables` as the flax-layout tree of numpy arrays,
and `save`/`load` write and read the JAX package's bundle file (an 8-byte
header length, a JSON header, then the flax msgpack blob; nn/flax_blob.py)
with no flax at runtime. Its `module` is built from that tree.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from . import flax_blob
from .attention import MultiHeadDotProductAttention, SelfAttention
from .layers import BatchNorm, Conv, Dense, Embed, LayerNorm, _to_numpy, max_pool

__all__ = [
    "MLP",
    "SimpleCNN",
    "ResNetBlock",
    "BottleneckBlock",
    "ResNet",
    "TransformerEncoder",
    "resnet20_cifar",
    "resnet50",
    "ARCHITECTURES",
    "make_model",
    "ModelBundle",
    "Capture",
    "resolve_dtype",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype: Any) -> torch.dtype:
    """A model config's dtype ("float32" / "bfloat16", as bundles store it,
    or a torch dtype) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported model dtype {dtype!r}; use one of {sorted(_DTYPES)}")
    return _DTYPES[dtype]


class Capture:
    """Records what flax's `capture_intermediates=True` records: the output
    of every named submodule (or of `names` only), in the order the calls
    return, and the values a model sows. Used as a context manager around
    a forward; `values` maps dotted path -> first output."""

    def __init__(self, model: "_Model", names: "set[str] | None" = None):
        self.model = model
        self.names = names
        self.values: dict[str, torch.Tensor] = {}
        self._handles = []

    def record(self, name: str, value: torch.Tensor) -> None:
        if self.names is None or name in self.names:
            self.values.setdefault(name, value)

    def __enter__(self) -> "Capture":
        for name, mod in self.model.named_modules():
            if name and (self.names is None or name in self.names):
                self._handles.append(mod.register_forward_hook(
                    lambda _m, _i, out, name=name: self.record(name, out)))
        self.model._capture = self
        return self

    def __exit__(self, *exc) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
        self.model._capture = None


class _Model(nn.Module):
    _capture: "Capture | None" = None

    def sow(self, name: str, value: torch.Tensor) -> None:
        """flax `self.sow("intermediates", name, value)`."""
        if self._capture is not None:
            self._capture.record(name, value)


def _prod(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


class MLP(_Model):
    """Plain fully-connected classifier/regressor."""

    def __init__(self, input_shape: Sequence[int], features: Sequence[int] = (128, 64),
                 num_outputs: int = 2, dtype: Any = torch.float32):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        width = _prod(input_shape)
        self.num_layers = len(features)
        for i, f in enumerate(features):
            setattr(self, f"dense_{i}", Dense(width, f, self.dtype))
            width = f
        self.head = Dense(width, num_outputs, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x)


class SimpleCNN(_Model):
    """Small conv net over NHWC images: three conv+relu+2x2 max-pool
    stages, then dense_0 and head."""

    def __init__(self, input_shape: Sequence[int], num_outputs: int = 10,
                 dtype: Any = torch.float32):
        super().__init__()
        self.dtype = resolve_dtype(dtype)
        h, w, c = input_shape
        for i, f in enumerate((64, 128, 256)):
            setattr(self, f"conv_{i}", Conv(c, f, (3, 3), dtype=self.dtype))
            h, w, c = h // 2, w // 2, f
        self.dense_0 = Dense(h * w * c, 256, self.dtype)
        self.head = Dense(256, num_outputs, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(3):
            x = F.relu(getattr(self, f"conv_{i}")(x))
            x = max_pool(x, (2, 2), (2, 2))
        x = x.reshape(x.shape[0], -1)
        return self.head(F.relu(self.dense_0(x)))


def _out_size(size: int, stride: int) -> int:
    return -(-size // stride)         # 'SAME' convolution


class ResNetBlock(nn.Module):
    """Basic block; the 1x1 projection exists where the residual's shape
    differs from the block's output, as flax decides at its first call."""

    def __init__(self, in_shape: tuple[int, int, int], filters: int,
                 strides: tuple[int, int] = (1, 1), dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w, c = in_shape
        self.conv1 = Conv(c, filters, (3, 3), strides, use_bias=False, dtype=dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, filters, (3, 3), use_bias=False, dtype=dtype)
        self.bn2 = BatchNorm(filters, dtype, scale_init_zero=True)
        self.out_shape = (_out_size(h, strides[0]), _out_size(w, strides[1]), filters)
        if self.out_shape != tuple(in_shape):
            self.proj_conv = Conv(c, filters, (1, 1), strides, use_bias=False, dtype=dtype)
            self.proj_bn = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if hasattr(self, "proj_conv"):
            residual = self.proj_bn(self.proj_conv(residual))
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 x4 bottleneck block."""

    def __init__(self, in_shape: tuple[int, int, int], filters: int,
                 strides: tuple[int, int] = (1, 1), dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w, c = in_shape
        self.conv1 = Conv(c, filters, (1, 1), use_bias=False, dtype=dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, filters, (3, 3), strides, use_bias=False, dtype=dtype)
        self.bn2 = BatchNorm(filters, dtype)
        self.conv3 = Conv(filters, filters * 4, (1, 1), use_bias=False, dtype=dtype)
        self.bn3 = BatchNorm(filters * 4, dtype, scale_init_zero=True)
        self.out_shape = (_out_size(h, strides[0]), _out_size(w, strides[1]), filters * 4)
        if self.out_shape != tuple(in_shape):
            self.proj_conv = Conv(c, filters * 4, (1, 1), strides, use_bias=False, dtype=dtype)
            self.proj_bn = BatchNorm(filters * 4, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "proj_conv"):
            residual = self.proj_bn(self.proj_conv(residual))
        return F.relu(residual + y)


class ResNet(_Model):
    """ResNet family over NHWC images: resnet20 CIFAR (3,3,3 basic),
    resnet50 (3,4,6,3 bottleneck), ... Sows `pooled_features`."""

    def __init__(self, input_shape: Sequence[int], stage_sizes: Sequence[int] = (3, 3, 3),
                 num_outputs: int = 10, num_filters: int = 16, bottleneck: bool = False,
                 stem_strides: int = 1, dtype: Any = torch.float32):
        super().__init__()
        self.dtype = dt = resolve_dtype(dtype)
        self.stem_strides = stem_strides
        h, w, c = input_shape
        if stem_strides == 1:
            self.stem_conv = Conv(c, num_filters, (3, 3), use_bias=False, dtype=dt)
        else:
            self.stem_conv = Conv(c, num_filters, (7, 7), (2, 2), use_bias=False, dtype=dt)
            h, w = _out_size(h, 2), _out_size(w, 2)
        self.stem_bn = BatchNorm(num_filters, dt)
        if stem_strides != 1:
            h, w = _out_size(h, 2), _out_size(w, 2)       # the 'SAME' max-pool
        shape = (h, w, num_filters)
        block = BottleneckBlock if bottleneck else ResNetBlock
        self.block_names = []
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"stage{i}_block{j}"
                mod = block(shape, num_filters * 2 ** i, strides, dt)
                setattr(self, name, mod)
                self.block_names.append(name)
                shape = mod.out_shape
        self.head = Dense(shape[2], num_outputs, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_bn(self.stem_conv(x.to(self.dtype))))
        if self.stem_strides != 1:
            x = max_pool(x, (3, 3), (2, 2), same=True)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # jnp.mean: f32 accumulation, result in the input dtype
        x = x.float().mean(dim=(1, 2)).to(x.dtype)
        self.sow("pooled_features", x)
        return self.head(x)


class TransformerEncoder(_Model):
    """Pre-LN transformer encoder classifier over (batch, seq[, feat])
    inputs. Token ids embed through `embed` (vocab_size > 0); continuous
    inputs project through the `stem` Dense. attention_impl: "dense"
    (flax MultiHeadDotProductAttention), "chunked", or "flash" (K2).
    Sows `pooled_features`."""

    def __init__(self, input_shape: Sequence[int] = (), num_layers: int = 2,
                 d_model: int = 64, num_heads: int = 4, d_ff: int = 128,
                 num_outputs: int = 2, vocab_size: int = 0, max_len: int = 512,
                 dropout_rate: float = 0.0, attention_impl: str = "dense",
                 dtype: Any = torch.float32):
        super().__init__()
        if attention_impl != "dense" and dropout_rate > 0:
            raise ValueError(
                "attention dropout is only implemented for the dense core; "
                f"got attention_impl={attention_impl!r} with "
                f"dropout_rate={dropout_rate}")
        self.dtype = dt = resolve_dtype(dtype)
        self.num_layers = num_layers
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.dropout_rate = dropout_rate     # serving is eval: dropout is off
        if vocab_size > 0:
            self.embed = Embed(vocab_size, d_model, dt)
        else:
            width = input_shape[-1] if len(input_shape) >= 2 else 1
            self.stem = Dense(width, d_model, dt)
        # float32 whatever the dtype, cast at the add (models.py:210-214)
        self.pos_embed = nn.Parameter(torch.empty(max_len, d_model))
        for i in range(num_layers):
            setattr(self, f"ln_attn_{i}", LayerNorm(d_model, dt))
            if attention_impl == "dense":
                attn = MultiHeadDotProductAttention(d_model, num_heads, dt)
            else:
                attn = SelfAttention(d_model, num_heads, dt, impl=attention_impl)
            setattr(self, f"attn_{i}", attn)
            setattr(self, f"ln_mlp_{i}", LayerNorm(d_model, dt))
            setattr(self, f"mlp_up_{i}", Dense(d_model, d_ff, dt))
            setattr(self, f"mlp_down_{i}", Dense(d_ff, d_model, dt))
        self.ln_final = LayerNorm(d_model, dt)
        self.head = Dense(d_model, num_outputs, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.vocab_size > 0:
            h = self.embed(x.to(torch.int32))
        else:
            if x.dim() == 2:          # (batch, seq) scalars -> (batch, seq, 1)
                x = x[:, :, None]
            h = self.stem(x.to(self.dtype))
        if h.shape[1] > self.max_len:
            raise ValueError(
                f"sequence length {h.shape[1]} exceeds max_len={self.max_len}; "
                "raise max_len in the model config")
        h = h + self.pos_embed[: h.shape[1]][None].to(self.dtype)
        for i in range(self.num_layers):
            y = getattr(self, f"attn_{i}")(getattr(self, f"ln_attn_{i}")(h))
            h = h + y
            y = getattr(self, f"mlp_up_{i}")(getattr(self, f"ln_mlp_{i}")(h))
            y = getattr(self, f"mlp_down_{i}")(F.gelu(y, approximate="tanh"))
            h = h + y
        h = self.ln_final(h)
        pooled = h.float().mean(dim=1).to(h.dtype)
        self.sow("pooled_features", pooled)
        return self.head(pooled)

    def flax_leaves(self) -> dict:
        return {("params", "pos_embed"): _to_numpy(self.pos_embed)}

    def load_flax_leaves(self, leaves: dict) -> None:
        t = leaves[("params", "pos_embed")]
        t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
        self.pos_embed.data = t.to(self.pos_embed.device)


def resnet20_cifar(input_shape: Sequence[int], num_outputs: int = 10,
                   dtype: Any = torch.float32) -> ResNet:
    return ResNet(input_shape, stage_sizes=(3, 3, 3), num_filters=16,
                  num_outputs=num_outputs, dtype=dtype)


def resnet50(input_shape: Sequence[int], num_outputs: int = 1000,
             dtype: Any = torch.float32) -> ResNet:
    return ResNet(input_shape, stage_sizes=(3, 4, 6, 3), num_filters=64,
                  bottleneck=True, stem_strides=2, num_outputs=num_outputs,
                  dtype=dtype)


# name -> factory(input_shape, **config), the JAX package's registry
ARCHITECTURES: dict[str, Callable[..., nn.Module]] = {
    "mlp": lambda input_shape, **kw: MLP(input_shape, **kw),
    "simple_cnn": lambda input_shape, **kw: SimpleCNN(input_shape, **kw),
    "resnet20_cifar": lambda input_shape, **kw: resnet20_cifar(input_shape, **kw),
    "resnet50": lambda input_shape, **kw: resnet50(input_shape, **kw),
    "resnet": lambda input_shape, **kw: ResNet(input_shape, **kw),
    "transformer": lambda input_shape, **kw: TransformerEncoder(input_shape, **kw),
}


def make_model(architecture: str, input_shape: Sequence[int] = (), **config) -> nn.Module:
    if architecture not in ARCHITECTURES:
        raise ValueError(
            f"unknown architecture {architecture!r}; have {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[architecture](tuple(input_shape), **config)


def _init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """flax's default initialisers, drawn from `gen`: lecun-normal kernels
    (truncated at two deviations), N(0, 1/features) embeddings, N(0, 0.02)
    position table; biases, norms and batch statistics keep the values the
    layers were built with (zeros, ones, flax's zero-init scales)."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (Dense, Conv)):
                fan_in = mod.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            elif isinstance(mod, Embed):
                nn.init.normal_(mod.weight, 0.0, mod.weight.shape[1] ** -0.5, generator=gen)
            elif isinstance(mod, TransformerEncoder):
                nn.init.normal_(mod.pos_embed, 0.0, 0.02, generator=gen)


@dataclass
class ModelBundle:
    """A saved/loadable model: architecture name + config + variables
    (the flax-layout tree {"params": ..., "batch_stats": ...} of numpy
    arrays) + per-example input shape, class labels and preprocessing."""

    architecture: str
    config: dict[str, Any]
    variables: dict[str, Any]
    input_shape: tuple[int, ...] = ()
    class_labels: list | None = None
    preprocess: dict[str, Any] = field(default_factory=dict)

    _module: nn.Module | None = None

    @property
    def module(self) -> nn.Module:
        """The torch model (on the CPU, eval mode) built from `variables`;
        building it validates the tree leaf for leaf."""
        if self._module is None:
            from .carry import load_variables

            module = make_model(self.architecture, self.input_shape, **self.config)
            load_variables(module, self.variables)
            self._module = module.eval()
        return self._module

    @staticmethod
    def init(architecture: str, input_shape: tuple[int, ...], seed: int = 0,
             class_labels=None, preprocess=None, **config) -> "ModelBundle":
        """Random weights from `seed` through a torch.Generator. They are
        not the JAX package's init weights (tests carry those across)."""
        from .carry import module_variables

        module = make_model(architecture, input_shape, **config)
        _init_weights(module, torch.Generator().manual_seed(int(seed)))
        bundle = ModelBundle(
            architecture=architecture, config=config,
            variables=module_variables(module), input_shape=tuple(input_shape),
            class_labels=class_labels, preprocess=dict(preprocess or {}))
        bundle._module = module.eval()
        return bundle

    def _header(self) -> bytes:
        def plain(v):
            if isinstance(v, torch.dtype):
                return {torch.bfloat16: "bfloat16", torch.float32: "float32"}[v]
            return v

        return json.dumps({
            "architecture": self.architecture,
            "config": {k: plain(v) for k, v in self.config.items()},
            "input_shape": list(self.input_shape),
            "class_labels": self.class_labels,
            "preprocess": self.preprocess,
        }).encode()

    def to_bytes(self) -> bytes:
        """The bundle file's bytes: an 8-byte little-endian header length,
        the JSON header, then the flax variables blob."""
        header = self._header()
        return len(header).to_bytes(8, "little") + header + flax_blob.to_bytes(self.variables)

    @staticmethod
    def from_bytes(data: bytes) -> "ModelBundle":
        hlen = int.from_bytes(data[:8], "little")
        header = json.loads(data[8:8 + hlen].decode())
        bundle = ModelBundle(
            architecture=header["architecture"],
            config=header["config"],
            variables=flax_blob.from_bytes(data[8 + hlen:]),
            input_shape=tuple(header["input_shape"]),
            class_labels=header.get("class_labels"),
            preprocess=header.get("preprocess", {}),
        )
        bundle.module          # validates the tree against the architecture
        return bundle

    def save(self, path: str) -> None:
        with open(path, "wb") as fh:
            fh.write(self.to_bytes())

    @staticmethod
    def load(path: str) -> "ModelBundle":
        with open(path, "rb") as fh:
            return ModelBundle.from_bytes(fh.read())

    def layer_names(self) -> list[str]:
        """Dotted paths of every layer a forward calls, and of what the
        model sows, in flax's order (children before their parent)."""
        module = self.module
        x = torch.zeros((1, *self.input_shape), dtype=torch.float32)
        with torch.no_grad(), Capture(module) as cap:
            module(x)
        return list(cap.values)
