"""UnrollImage — image column -> flat feature vector column.

A copy of mmlspark_tpu/image/unroll.py (host numpy code).

Reference: `UnrollImage` (src/image-transformer/src/main/scala/
UnrollImage.scala:145-167): unrolls (H, W, C) pixels into a DenseVector in
CHW order (channel-major), the layout CNTK models expect; `UnrollBinaryImage`
(:177+) decodes bytes first. Here the unroll is a transpose+reshape on the
whole batch at once.
"""

from __future__ import annotations

import numpy as np

from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["UnrollImage", "UnrollBinaryImage"]


def _unroll_batch(x: np.ndarray) -> np.ndarray:
    # (n, H, W, C) -> CHW order -> (n, C*H*W), float64 like the reference's
    # DenseVector
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2)).reshape(x.shape[0], -1).astype(np.float64)


@register_stage
class UnrollImage(HasInputCol, HasOutputCol, Transformer):
    input_col = Param("image", "image column ((n,H,W,C) or list)", ptype=str)
    output_col = Param("features", "unrolled vector column", ptype=str)

    def _transform(self, table: Table) -> Table:
        col = table[self.get("input_col")]
        x = np.stack(col) if isinstance(col, list) else np.asarray(col)
        if x.ndim != 4:
            raise ValueError(f"expected (n,H,W,C) images, got shape {x.shape}")
        return table.with_column(self.get("output_col"), _unroll_batch(x))


@register_stage
class UnrollBinaryImage(HasInputCol, HasOutputCol, Transformer):
    """Decode image bytes then unroll (reference UnrollImage.scala:177+)."""

    input_col = Param("bytes", "encoded image bytes column", ptype=str)
    output_col = Param("features", "unrolled vector column", ptype=str)
    height = Param(None, "resize height (optional)", ptype=int)
    width = Param(None, "resize width (optional)", ptype=int)

    def _transform(self, table: Table) -> Table:
        from .io import decode_image

        col = table[self.get("input_col")]
        h, w = self.get("height"), self.get("width")
        imgs = [decode_image(b, resize=(h, w) if h and w else None) for b in col]
        return table.with_column(self.get("output_col"), _unroll_batch(np.stack(imgs)))
