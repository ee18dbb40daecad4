"""Image pipeline subsystem of the port.

Counterpart of mmlspark_tpu/image/ (reference modules: src/image-transformer/
(ImageTransformer.scala:22-379), src/io/image/ + src/io/binary/ (file
readers), and the UnrollImage / ImageSetAugmenter stages). Decoding stays on
the host (PIL, imported only when an image is decoded or encoded); every
pixel op is a torch op over NHWC batches on the stage's device, the resize a
port of `jax.image.resize` (ops.py).
"""

from .ops import (
    resize_nhwc,
    resize_image,
    crop_image,
    flip_image,
    to_grayscale,
    box_blur,
    threshold_image,
    gaussian_blur,
)
from .transformer import ImageTransformer, ResizeImageTransformer
from .unroll import UnrollImage, UnrollBinaryImage
from .augmenter import ImageSetAugmenter
from .io import read_images, read_binary_files, write_binary_files

__all__ = [
    "resize_nhwc",
    "resize_image",
    "crop_image",
    "flip_image",
    "to_grayscale",
    "box_blur",
    "threshold_image",
    "gaussian_blur",
    "ImageTransformer",
    "ResizeImageTransformer",
    "UnrollImage",
    "UnrollBinaryImage",
    "ImageSetAugmenter",
    "read_images",
    "read_binary_files",
    "write_binary_files",
]
