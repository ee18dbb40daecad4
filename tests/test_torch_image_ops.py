"""The port's pixel ops (mmlspark_tpu_torch/image/ops.py) held against the
JAX package's (mmlspark_tpu/image/ops.py), each run as `ImageTransformer`
runs it there: jitted and vmapped over a batch of seeded 0-255 images.

The resize is a port of `jax.image.resize`'s own arithmetic: the same f32
weight matrices, contracted in f32. XLA compiles the weights' sample
positions into one fused multiply-add, which the port reproduces, but at
300 -> 224 it sums the linear weights' columns from positions rounded twice
(JAX's eager and jitted `compute_weight_mat` differ by 7.7e-6 there), so
the jitted weights are held at 1e-5 and the resize, whose contraction over
up to 300 pixels of up to 255 turns such gaps into ~3e-3, at atol 5e-3 on
0-255 values. "nearest" is a gather, equal bit for bit. The blurs and the
grayscale sum in another order than XLA's: atol 1e-4 on 0-255 (a few f32
ulps at 255). Crop (a negative start counts from the end, then the window
is clamped inside, as `jax.lax.dynamic_slice` does), flip and threshold are
equal bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from jax._src.image import scale as jax_scale  # noqa: E402

from mmlspark_tpu.image import ops as jops  # noqa: E402
from mmlspark_tpu_torch.image import ops  # noqa: E402

RESIZE_ATOL = 5e-3
CONV_ATOL = 1e-4

# (in H, in W, out H, out W): 256 -> 224 (the ImageNet crop), 24 -> 16,
# an upsample to an odd shape, 300 -> 224, and one dimension unchanged
RATIOS = [(256, 256, 224, 224), (24, 24, 16, 16), (16, 16, 37, 23),
          (300, 300, 224, 224), (16, 20, 16, 9)]
METHODS = ["linear", "bilinear", "cubic", "lanczos3", "lanczos5"]


def _images(n, h, w, c=3, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, h, w, c)).astype(dtype)


def _jax_batch(fn, x):
    """fn over each image of x, jitted and vmapped as ImageTransformer runs
    its op chain (mmlspark_tpu/image/transformer.py:104-125)."""
    return np.asarray(jax.jit(jax.vmap(fn))(x))


def _port(fn, x):
    return fn(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("h,w,oh,ow", RATIOS, ids=[f"{r[0]}x{r[1]}to{r[2]}x{r[3]}"
                                                   for r in RATIOS])
def test_resize_matches_jax_image_resize(h, w, oh, ow, method):
    x = _images(2, h, w)
    want = _jax_batch(lambda im: jops.resize_image(im, oh, ow, method), x)
    got = _port(lambda t: ops.resize_nhwc(t, oh, ow, method), x)
    assert got.shape == want.shape == (2, oh, ow, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("h,w,oh,ow", RATIOS, ids=[f"{r[0]}x{r[1]}to{r[2]}x{r[3]}"
                                                   for r in RATIOS])
def test_resize_nearest_bit_for_bit(h, w, oh, ow):
    x = _images(2, h, w, seed=1)
    want = _jax_batch(lambda im: jops.resize_image(im, oh, ow, "nearest"), x)
    got = _port(lambda t: ops.resize_nhwc(t, oh, ow, "nearest"), x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
def test_resize_uint8_input(method):
    """Integer images become f32 before the contraction, as
    promote_dtypes_inexact does; "nearest" gathers the input's dtype."""
    x = _images(2, 24, 24, seed=2, dtype=np.uint8)
    want = _jax_batch(lambda im: jops.resize_image(im, 16, 20, method), x)
    got = _port(lambda t: ops.resize_nhwc(t, 16, 20, method), x)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL if method != "nearest" else 0)


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3", "lanczos5"])
@pytest.mark.parametrize("m,n", [(256, 224), (300, 224), (24, 16), (16, 37)])
def test_weight_matrix_matches_jax(m, n, method, antialias):
    kernel = jax_scale._kernels[jax_scale.ResizeMethod.from_string(method)]
    want = np.asarray(jax.jit(
        lambda: jax_scale.compute_weight_mat(m, n, n / m, 0.0, kernel, antialias))())
    got = ops.compute_weight_mat(m, n, method, antialias, "cpu").numpy()
    assert got.shape == want.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_image_is_one_image_of_the_batch():
    x = _images(1, 24, 24)
    got = ops.resize_image(torch.from_numpy(x[0]), 16, 16).numpy()
    want = np.asarray(jax.jit(lambda im: jops.resize_image(im, 16, 16))(x[0]))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_resize_rejects_an_unknown_method_and_a_single_image():
    with pytest.raises(ValueError, match="Unknown resize method"):
        ops.resize_nhwc(torch.zeros(1, 4, 4, 3), 2, 2, "area")
    with pytest.raises(ValueError, match="N, H, W, C"):
        ops.resize_nhwc(torch.zeros(4, 4, 3), 2, 2)


@pytest.mark.parametrize("x0,y0,h,w", [(2, 4, 8, 6), (0, 0, 16, 16), (12, 3, 8, 6),
                                       (30, 40, 8, 6), (-3, 20, 5, 5)],
                         ids=["inside", "whole", "past_right", "past_both", "negative_x"])
def test_crop_clamps_like_dynamic_slice(x0, y0, h, w):
    """A window past the edge shifts back inside, as jax.lax.dynamic_slice
    clamps its start."""
    x = _images(2, 16, 16, seed=3)
    want = _jax_batch(lambda im: jops.crop_image(im, x0, y0, h, w), x)
    got = _port(lambda t: ops.crop_image(t, x0, y0, h, w), x)
    np.testing.assert_array_equal(got, want)


def test_crop_past_the_edge_shifts():
    x = _images(1, 16, 16, seed=3)
    got = _port(lambda t: ops.crop_image(t, 12, 3, 8, 6), x)
    np.testing.assert_array_equal(got[0], x[0, 3:11, 10:16])


def test_crop_larger_than_the_image_raises():
    with pytest.raises(ValueError, match="does not fit"):
        ops.crop_image(torch.zeros(1, 8, 8, 3), 0, 0, 9, 4)


@pytest.mark.parametrize("code", [0, 1, 2, -1])
def test_flip_bit_for_bit(code):
    x = _images(2, 7, 9, seed=4)
    want = _jax_batch(lambda im: jops.flip_image(im, code), x)
    got = _port(lambda t: ops.flip_image(t, code), x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keep", [False, True])
def test_grayscale(keep):
    x = _images(2, 9, 7, c=4, seed=5)
    want = _jax_batch(lambda im: jops.to_grayscale(im, keep), x)
    got = _port(lambda t: ops.to_grayscale(t, keep), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_ATOL)


@pytest.mark.parametrize("kh,kw", [(3, 3), (4, 4), (2, 5), (1, 1)])
def test_box_blur_same_padding(kh, kw):
    """Even kernels show XLA's SAME padding: (k - 1) // 2 zeros before."""
    x = _images(2, 11, 13, seed=6)
    want = _jax_batch(lambda im: jops.box_blur(im, kh, kw), x)
    got = _port(lambda t: ops.box_blur(t, kh, kw), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_ATOL)


def test_box_blur_4x4_pads_one_before_and_two_after():
    x = np.zeros((1, 6, 6, 1), np.float32)
    x[0, 0, 0, 0] = 16.0
    got = _port(lambda t: ops.box_blur(t, 4, 4), x)[0, :, :, 0]
    # the pixel at (0, 0) reaches outputs whose window [i-1, i+2] holds it
    want = np.zeros((6, 6), np.float32)
    want[:2, :2] = 1.0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,sigma", [(3, 1.0), (5, 1.5), (4, 0.8)])
def test_gaussian_blur(size, sigma):
    x = _images(2, 12, 10, seed=7)
    want = _jax_batch(lambda im: jops.gaussian_blur(im, size, sigma), x)
    got = _port(lambda t: ops.gaussian_blur(t, size, sigma), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_ATOL)


@pytest.mark.parametrize("kind", ["binary", "binary_inv", "trunc", "tozero", "tozero_inv"])
def test_threshold_bit_for_bit(kind):
    x = _images(2, 8, 8, seed=8)
    x[0, 0, 0, 0] = 127.0          # exactly at the threshold: not above it
    want = _jax_batch(lambda im: jops.threshold_image(im, 127.0, 200.0, kind), x)
    got = _port(lambda t: ops.threshold_image(t, 127.0, 200.0, kind), x)
    np.testing.assert_array_equal(got, want)


def test_threshold_unknown_type_raises():
    with pytest.raises(ValueError, match="unknown threshold_type"):
        ops.threshold_image(torch.zeros(1, 2, 2, 1), 1.0, threshold_type="otsu")
