"""Pixel ops: torch functions over (..., H, W, C) images.

Counterpart of mmlspark_tpu/image/ops.py (reference: the OpenCV-backed
stage classes in src/image-transformer/src/main/scala/
ImageTransformer.scala:35-206). Every op takes a float image or a batch of
them, (H, W, C) or (N, H, W, C), and runs on the tensor's own device, so an
NHWC batch on the card runs the whole op chain there in one pass.

The resize is a port of JAX's own `jax.image.resize`
(jax/_src/image/scale.py in JAX 0.9.0), not `F.interpolate`, whose
antialiasing filter and edge handling differ: one f32 weight matrix per
resized dimension (`compute_weight_mat`, scale.py:54-85), applied as an
f32 contraction, dimensions of unchanged size skipped; "nearest" is
scale.py's gather. The box and Gaussian blurs are depthwise convolutions
with XLA's SAME padding, padded explicitly.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "resize_nhwc",
    "resize_image",
    "crop_image",
    "flip_image",
    "to_grayscale",
    "box_blur",
    "threshold_image",
    "gaussian_blur",
]


# -- the resize (jax/_src/image/scale.py) --------------------------------- #

def _lanczos(radius: float, x: torch.Tensor) -> torch.Tensor:
    """scale.py:33-37."""
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    out = torch.where(x > 1e-3,
                      y / torch.where(x != 0, math.pi ** 2 * (x * x), torch.ones_like(x)),
                      torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, scale.py:40-47."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """scale.py:50-51."""
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


_KERNELS = {
    "linear": _triangle,
    "lanczos3": functools.partial(_lanczos, 3.0),
    "lanczos5": functools.partial(_lanczos, 5.0),
    "cubic": _keys_cubic,
}


def _method(name: str) -> str:
    """`ResizeMethod.from_string` (scale.py): the kernel's canonical name."""
    if name == "nearest":
        return "nearest"
    if name in ("linear", "bilinear", "trilinear", "triangle"):
        return "linear"
    if name in ("lanczos3", "lanczos5"):
        return name
    if name in ("cubic", "bicubic", "tricubic"):
        return "cubic"
    raise ValueError(f'Unknown resize method "{name}"')


def compute_weight_mat(input_size: int, output_size: int, method: str,
                       antialias: bool, device) -> torch.Tensor:
    """The (input_size, output_size) f32 resampling matrix of one dimension,
    `compute_weight_mat` (scale.py:54-85) with a zero translation. The
    scale and its inverse are Python floats, rounded to f32 where they meet
    f32 arrays, as JAX's weak types are.

    The sample positions `(i + 0.5) * inv_scale - 0.5` are rounded to f32
    once, as the fused multiply-add that XLA compiles `jax.image.resize`'s
    weights into gives them (an exact f64 product and difference, then one
    rounding). Rounded twice, as the expression reads, a position near 256
    moves by an f32 ulp (1.5e-5) and its weights by up to 1.2e-5, which the
    contraction over hundreds of 0-255 pixels turns into ~5e-3."""
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (output_size / input_size)
    # downsampling scales the kernel (a low-pass filter); upsampling only
    # interpolates
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    f32 = torch.float32
    centers = torch.arange(output_size, dtype=f32, device=device) + 0.5
    sample_f = (centers.double() * float(np.float32(inv_scale)) - 0.5).to(f32)
    x = torch.abs(sample_f[None, :]
                  - torch.arange(input_size, dtype=f32, device=device)[:, None]) / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    # zero the columns whose sample lies wholly outside the input
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_nhwc(x: torch.Tensor, height: int, width: int, method: str = "linear",
                antialias: bool = True) -> torch.Tensor:
    """`jax.image.resize` of an (N, H, W, C) batch to (N, height, width, C)
    on `x`'s device. Integer (and f64) images become f32 first, as
    `promote_dtypes_inexact` does with 64-bit types off; "nearest" keeps the
    input's dtype (scale.py:256-271)."""
    if x.dim() != 4:
        raise ValueError(f"expected an (N, H, W, C) batch, got shape {tuple(x.shape)}")
    method = _method(method)
    height, width = int(height), int(width)
    if method == "nearest":
        for dim, n in ((1, height), (2, width)):
            m = x.shape[dim]
            if m == n:
                continue
            offsets = torch.floor(
                (torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * m / n
            ).to(torch.int64)
            x = x.index_select(dim, offsets)
        return x
    if not x.is_floating_point() or x.dtype == torch.float64:
        x = x.float()
    if x.shape[1] != height:
        w = compute_weight_mat(x.shape[1], height, method, antialias, x.device)
        x = torch.einsum("nhwc,hp->npwc", x, w.to(x.dtype))
    if x.shape[2] != width:
        w = compute_weight_mat(x.shape[2], width, method, antialias, x.device)
        x = torch.einsum("nhwc,wq->nhqc", x, w.to(x.dtype))
    return x


def resize_image(img: torch.Tensor, height: int, width: int, method: str = "linear"):
    """ResizeImage (ImageTransformer.scala:57-75): one (H, W, C) image."""
    return resize_nhwc(img[None], height, width, method)[0]


# -- the other ops ------------------------------------------------------- #

def crop_image(img: torch.Tensor, x: int, y: int, height: int, width: int):
    """CropImage (ImageTransformer.scala:77-93): (x, y) top-left corner.
    As `jax.lax.dynamic_slice`, a negative start counts from the end, and
    the start is then clamped so that the window fits: a crop past the edge
    shifts back inside instead of raising."""
    h, w = img.shape[-3], img.shape[-2]
    if height > h or width > w:
        raise ValueError(
            f"crop of {height}x{width} does not fit an image of {h}x{w}")

    def start(i: int, size: int, window: int) -> int:
        i = int(i) + size if int(i) < 0 else int(i)
        return min(max(i, 0), size - window)

    y0, x0 = start(y, h, height), start(x, w, width)
    return img[..., y0:y0 + height, x0:x0 + width, :]


def flip_image(img: torch.Tensor, flip_code: int = 1):
    """Flip (ImageTransformer.scala:126-142), OpenCV flipCode semantics:
    0 = around x-axis (vertical flip), >0 = around y-axis (horizontal),
    <0 = both."""
    if flip_code == 0:
        return torch.flip(img, dims=(-3,))
    if flip_code > 0:
        return torch.flip(img, dims=(-2,))
    return torch.flip(img, dims=(-3, -2))


def to_grayscale(img: torch.Tensor, keep_channels: bool = False):
    """ColorFormat(COLOR_BGR2GRAY) (ImageTransformer.scala:95-124). Uses the
    standard luminance weights; input channel order is RGB (see io.py)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    gray = torch.tensordot(img[..., :3], w, dims=([-1], [0]))[..., None]
    if keep_channels:
        return gray.expand(img.shape).contiguous()
    return gray


def _depthwise_conv2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """img (..., H, W, C), kernel (kh, kw) applied per channel with XLA's
    SAME edges: for a stride of 1, (k - 1) // 2 zeros before and the rest
    after, along each axis."""
    lead, (h, w, c) = img.shape[:-3], img.shape[-3:]
    kh, kw = kernel.shape
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    x = F.pad(x, ((kw - 1) // 2, kw - 1 - (kw - 1) // 2,
                  (kh - 1) // 2, kh - 1 - (kh - 1) // 2))
    weight = kernel.to(img.dtype).expand(c, 1, kh, kw).contiguous()
    out = F.conv2d(x, weight, groups=c)
    return out.permute(0, 2, 3, 1).reshape(*lead, h, w, c)


def box_blur(img: torch.Tensor, height: int = 3, width: int = 3):
    """Blur (ImageTransformer.scala:144-161): normalized box filter."""
    kernel = torch.full((height, width), 1.0 / (height * width), dtype=img.dtype,
                        device=img.device)
    return _depthwise_conv2d(img, kernel)


def threshold_image(img: torch.Tensor, threshold: float, max_val: float = 255.0,
                    threshold_type: str = "binary"):
    """Threshold (ImageTransformer.scala:163-184), OpenCV types."""
    full = torch.full_like(img, max_val)
    zero = torch.zeros_like(img)
    if threshold_type == "binary":
        return torch.where(img > threshold, full, zero)
    if threshold_type == "binary_inv":
        return torch.where(img > threshold, zero, full)
    if threshold_type == "trunc":
        return torch.clamp(img, max=threshold)
    if threshold_type == "tozero":
        return torch.where(img > threshold, img, zero)
    if threshold_type == "tozero_inv":
        return torch.where(img > threshold, zero, img)
    raise ValueError(f"unknown threshold_type {threshold_type!r}")


@functools.lru_cache(maxsize=64)
def _gaussian_kernel_np(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, aperture_size: int = 3, sigma: float = 1.0):
    """GaussianKernel (ImageTransformer.scala:186-206)."""
    kernel = torch.from_numpy(_gaussian_kernel_np(aperture_size, float(sigma)))
    return _depthwise_conv2d(img, kernel.to(img.device))
