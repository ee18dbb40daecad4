"""ImageTransformer — chained pixel ops as a pipeline stage.

Counterpart of mmlspark_tpu/image/transformer.py (reference:
`ImageTransformer`, src/image-transformer/src/main/scala/
ImageTransformer.scala:266-379, a list of named OpenCV stages applied per
row through JNI). A uniform NHWC batch goes to the stage's device once and
runs the whole op chain there in one pass over the batch; a ragged list of
images runs it once per distinct shape. The output is float32 either way.

`device_kernel` runs the op chain over a uniform NHWC batch in a fused
segment (core/fusion.py).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.kernels import resolve_device
from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import IMAGE_SPEC, Table
from ..core.serialize import register_stage
from . import ops as _ops

__all__ = ["ImageTransformer", "ResizeImageTransformer"]


_OP_FNS: dict[str, Callable] = {
    "resize": lambda img, p: _ops.resize_nhwc(
        img, int(p["height"]), int(p["width"]), p.get("method", "linear")
    ),
    "crop": lambda img, p: _ops.crop_image(
        img, int(p["x"]), int(p["y"]), int(p["height"]), int(p["width"])
    ),
    "flip": lambda img, p: _ops.flip_image(img, int(p.get("flip_code", 1))),
    "gray": lambda img, p: _ops.to_grayscale(img, bool(p.get("keep_channels", False))),
    "blur": lambda img, p: _ops.box_blur(
        img, int(p.get("height", 3)), int(p.get("width", 3))
    ),
    "threshold": lambda img, p: _ops.threshold_image(
        img, float(p["threshold"]), float(p.get("max_val", 255.0)),
        p.get("threshold_type", "binary"),
    ),
    "gaussian_kernel": lambda img, p: _ops.gaussian_blur(
        img, int(p.get("aperture_size", 3)), float(p.get("sigma", 1.0))
    ),
}


@register_stage
class ImageTransformer(HasInputCol, HasOutputCol, Transformer):
    """Apply a chain of pixel ops to an image column.

    `stages` is a list of {"op": name, **params} dicts (the reference's
    `ImageTransformerStage` list). Builder methods mirror the reference's
    fluent API: .resize(h, w).crop(...).flip(...)…"""

    input_col = Param("image", "input image column", ptype=str)
    output_col = Param("image_out", "output image column", ptype=str)
    stages = Param([], "list of {'op': ..., **params} op descriptors")
    device = Param("cuda", "torch device of the op chain: cuda | cpu", ptype=str)

    # -- fluent builders (reference ImageTransformer.scala:286-343) ------ #

    def _add(self, **stage) -> "ImageTransformer":
        self.set(stages=[*self.get("stages"), stage])
        return self

    def resize(self, height: int, width: int, method: str = "linear"):
        return self._add(op="resize", height=height, width=width, method=method)

    def crop(self, x: int, y: int, height: int, width: int):
        return self._add(op="crop", x=x, y=y, height=height, width=width)

    def flip(self, flip_code: int = 1):
        return self._add(op="flip", flip_code=flip_code)

    def gray(self, keep_channels: bool = False):
        return self._add(op="gray", keep_channels=keep_channels)

    def blur(self, height: int = 3, width: int = 3):
        return self._add(op="blur", height=height, width=width)

    def threshold(self, threshold: float, max_val: float = 255.0,
                  threshold_type: str = "binary"):
        return self._add(op="threshold", threshold=threshold, max_val=max_val,
                         threshold_type=threshold_type)

    def gaussian_kernel(self, aperture_size: int = 3, sigma: float = 1.0):
        return self._add(op="gaussian_kernel", aperture_size=aperture_size,
                         sigma=sigma)

    # -------------------------------------------------------------------- #

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """The op chain over an (N, H, W, C) batch on its own device, as
        float32."""
        x = x.float()
        for stage in self.get("stages"):
            x = _OP_FNS[stage["op"]](x, stage)
        return x.contiguous()

    def _run(self, batch: np.ndarray, device: torch.device) -> np.ndarray:
        with torch.inference_mode():
            return self.apply(torch.from_numpy(np.ascontiguousarray(batch)).to(device)).cpu().numpy()

    def _transform(self, table: Table) -> Table:
        col = table[self.get("input_col")]
        device = resolve_device(self.get("device"))
        if isinstance(col, np.ndarray) and col.ndim == 4:
            out = self._run(col, device)
        else:
            # ragged: one pass per distinct shape
            imgs = [np.asarray(im) for im in col]
            results: list[np.ndarray | None] = [None] * len(imgs)
            by_shape: dict[tuple, list[int]] = {}
            for i, im in enumerate(imgs):
                by_shape.setdefault(im.shape, []).append(i)
            for idxs in by_shape.values():
                res = self._run(np.stack([imgs[i] for i in idxs]), device)
                for j, i in enumerate(idxs):
                    results[i] = res[j]
            shapes = {r.shape for r in results}  # type: ignore[union-attr]
            out = (np.stack(results) if len(shapes) == 1 else results)  # type: ignore[arg-type]
        meta = {}
        if isinstance(out, np.ndarray):
            meta[IMAGE_SPEC] = {
                "height": int(out.shape[1]), "width": int(out.shape[2]),
                "channels": int(out.shape[3]),
            }
        return table.with_column(self.get("output_col"), out, meta=meta)

    def device_kernel(self):
        """Fusion kernel (core/fusion.py): the op chain over a uniform NHWC
        batch — pixel math is float32 on both paths, so fused output
        matches the staged bytes. Ragged image lists fall back to the
        per-shape host path."""
        from ..core.fusion import DeviceKernel

        in_col, out_col = self.get("input_col"), self.get("output_col")

        def fn(params, cols):
            return {out_col: self.apply(cols[in_col])}

        def ready(table: Table):
            col = table[in_col]
            if not (isinstance(col, np.ndarray) and col.ndim == 4):
                return "ragged image column (grouped per-shape on host)"
            return True

        def image_meta(arr: np.ndarray) -> dict:
            return {IMAGE_SPEC: {
                "height": int(arr.shape[1]), "width": int(arr.shape[2]),
                "channels": int(arr.shape[3]),
            }}

        return DeviceKernel(
            fn=fn, input_cols=(in_col,), output_cols=(out_col,),
            name="ImageTransformer", out_dtypes={out_col: np.float32},
            out_meta={out_col: image_meta}, ready=ready)


@register_stage
class ResizeImageTransformer(HasInputCol, HasOutputCol, Transformer):
    """Reference: ResizeImageTransformer (ResizeImageTransformer.scala:54+)."""

    input_col = Param("image", "input image column", ptype=str)
    output_col = Param("image_out", "output image column", ptype=str)
    height = Param(None, "target height", ptype=int, required=True)
    width = Param(None, "target width", ptype=int, required=True)
    device = Param("cuda", "torch device of the resize: cuda | cpu", ptype=str)

    def _inner(self) -> ImageTransformer:
        return ImageTransformer(
            input_col=self.get("input_col"), output_col=self.get("output_col"),
            device=self.get("device"),
        ).resize(self.get("height"), self.get("width"))

    def _transform(self, table: Table) -> Table:
        return self._inner().transform(table)

    def device_kernel(self):
        return self._inner().device_kernel()
