"""ImageFeaturizer — transfer-learning featurization via a truncated forward.

Counterpart of mmlspark_tpu/nn/featurizer.py (reference: `ImageFeaturizer`,
src/image-featurizer/src/main/scala/ImageFeaturizer.scala:36-189: resize →
CHW unroll → CNTKModel cut at `layerNames(cutOutputLayers)`, :92-135).
Each minibatch is resized on the stage's device by image/ops.py's port of
`jax.image.resize` ("bilinear"), right before the forward, and the "cut"
output is the layer's output as `Capture` records it: no graph surgery on
a serialized model.

`device_kernel` runs resize -> truncated forward -> flatten as one fused
segment (core/fusion.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.params import Param
from ..core.schema import SCORE_KIND, Table
from ..core.serialize import register_stage
from ..image.ops import resize_nhwc
from .runner import DeepModelTransformer

__all__ = ["ImageFeaturizer"]


@register_stage
class ImageFeaturizer(DeepModelTransformer):
    """Featurize images with a truncated pretrained model.

    cut_output_layers=0 returns final logits (head on); >=1 returns the
    pooled features / deeper intermediate, counting back from the head —
    matching the reference's cutOutputLayers semantics
    (ImageFeaturizer.scala:92-135)."""

    cut_output_layers = Param(1, "how many layers to cut from the output", ptype=int)
    layer_name = Param(None, "explicit layer path (overrides cut_output_layers)", ptype=str)
    output_col = Param("features_out", "featurized output column", ptype=str)
    resize_to = Param(None, "(h, w) to resize inputs to the model's input size")

    def _fetch_name(self) -> str:
        if self.get("layer_name"):
            return self.get("layer_name")
        cut = int(self.get("cut_output_layers"))
        if cut <= 0:
            return "logits"
        names = self.bundle.layer_names()
        if not names:
            return "logits"
        # cut=k drops the last k layers: cut=1 skips the head and returns
        # the layer feeding it (reference cutOutputLayers default)
        idx = max(len(names) - 1 - cut, 0)
        return names[idx]

    def _forward(self, model: nn.Module, fetches: tuple[str, ...], x: torch.Tensor,
                 mean: torch.Tensor, std: torch.Tensor) -> tuple[torch.Tensor, ...]:
        target = self.get("resize_to") or self.bundle.input_shape[:2]
        if target and tuple(x.shape[1:3]) != tuple(target):
            x = resize_nhwc(x.float(), int(target[0]), int(target[1]), method="bilinear")
        return DeepModelTransformer._forward(self, model, fetches, x, mean, std)

    def _transform(self, table: Table) -> Table:
        if self.bundle is None:
            raise ValueError("ImageFeaturizer has no model; call set_model()")
        out_col = self.get("output_col")
        self.set(fetch_dict={out_col: self._fetch_name()})
        out = DeepModelTransformer._transform(self, table)
        # flatten features to (n, d); the image column is the caller's
        feats = np.asarray(out[out_col])
        if feats.ndim > 2:
            feats = feats.reshape(feats.shape[0], -1)
        return out.with_column(out_col, feats.astype(np.float64),
                               meta={SCORE_KIND: "features"})

    def device_kernel(self):
        """Fusion kernel: resize -> truncated forward -> flatten as ONE
        device program (the staged path already computes the resize and
        forward in float32, so the float64 output cast after read-back is
        an exact widening — fused and staged bytes match)."""
        from ..core.fusion import DeviceKernel

        if self.bundle is None:
            return "no model bundle attached (call set_model())"
        if self.get("use_mesh"):
            return "mesh-sharded apply manages its own device placement"
        in_col = self.get("input_col")
        out_col = self.get("output_col")
        fetches = (self._fetch_name(),)

        def fn(params, cols):
            (feats,) = self._forward(params["model"], fetches, cols[in_col],
                                     params["mean"], params["std"])
            if feats.ndim > 2:
                feats = feats.reshape(feats.shape[0], -1)
            return {out_col: feats}

        def ready(table: Table):
            col = table[in_col]
            if not (isinstance(col, np.ndarray) and col.ndim == 4):
                return f"column {in_col!r} is not a uniform NHWC batch"
            return True

        return DeviceKernel(
            fn=fn, input_cols=(in_col,), output_cols=(out_col,),
            params=self._device_params(), name="ImageFeaturizer",
            out_dtypes={out_col: np.float64},
            out_meta={out_col: {SCORE_KIND: "features"}}, ready=ready)
