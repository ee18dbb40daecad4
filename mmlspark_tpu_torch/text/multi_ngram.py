"""MultiNGram — concatenate several n-gram ranges.

Reference: src/text-featurizer/src/main/scala/MultiNGram.scala:23+ —
emits the union of NGram(n) outputs for each n in `lengths`.

A copy of mmlspark_tpu/text/multi_ngram.py (host code).
"""

from __future__ import annotations

from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage
from .featurizer import NGram

__all__ = ["MultiNGram"]


@register_stage
class MultiNGram(HasInputCol, HasOutputCol, Transformer):
    input_col = Param("tokens", "token list column", ptype=str)
    output_col = Param("ngrams", "combined ngram column", ptype=str)
    lengths = Param([1, 2, 3], "ngram lengths to concatenate")

    def _transform(self, table: Table) -> Table:
        cols = []
        for n in self.get("lengths"):
            t = NGram(input_col=self.get("input_col"), output_col="__ng", n=int(n))
            cols.append(t.transform(table)["__ng"])
        merged = [sum((c[i] for c in cols), []) for i in range(table.num_rows)]
        return table.with_column(self.get("output_col"), merged)
