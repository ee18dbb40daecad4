"""ImageSetAugmenter — dataset expansion by flips.

A copy of mmlspark_tpu/image/augmenter.py (host numpy code).

Reference: `ImageSetAugmenter` (src/image-featurizer/src/main/scala/
ImageSetAugmenter.scala:15+): emits the original rows plus horizontally /
vertically flipped copies. Flips here are pure numpy slicing on the whole
batch (no per-row JNI)."""

from __future__ import annotations

import numpy as np

from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["ImageSetAugmenter"]


@register_stage
class ImageSetAugmenter(HasInputCol, HasOutputCol, Transformer):
    input_col = Param("image", "image column", ptype=str)
    output_col = Param("image", "output image column", ptype=str)
    flip_left_right = Param(True, "add horizontally flipped copies", ptype=bool)
    flip_up_down = Param(False, "add vertically flipped copies", ptype=bool)

    def _transform(self, table: Table) -> Table:
        col = table[self.get("input_col")]
        x = np.stack(col) if isinstance(col, list) else np.asarray(col)
        outs = [x]
        if self.get("flip_left_right"):
            outs.append(x[:, :, ::-1, :])
        if self.get("flip_up_down"):
            outs.append(x[:, ::-1, :, :])
        copies = len(outs)
        out_tbl_cols = {}
        for name in table.columns:
            if name == self.get("input_col"):
                continue
            c = table[name]
            if isinstance(c, list):
                out_tbl_cols[name] = list(c) * copies
            else:
                out_tbl_cols[name] = np.concatenate([np.asarray(c)] * copies)
        out_tbl_cols[self.get("output_col")] = np.concatenate(outs)
        meta = {name: table.meta(name) for name in table.columns if name in out_tbl_cols}
        return Table(out_tbl_cols, meta=meta)
