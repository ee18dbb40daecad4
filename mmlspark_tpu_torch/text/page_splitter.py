"""PageSplitter — split long strings into bounded-length pages.

Reference: src/text-featurizer/src/main/scala/PageSplitter.scala:19+ —
splits on whitespace/word boundaries so each page is within
[min_page_length, max_page_length] characters (the reference built it for
text-analytics request limits; SURVEY.md §5.7 notes it is the repo's only
"long input" handling).

A copy of mmlspark_tpu/text/page_splitter.py (host code).
"""

from __future__ import annotations

from ..core.params import HasInputCol, HasOutputCol, Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["PageSplitter"]


def _split_pages(text: str, max_len: int, min_len: int) -> list[str]:
    if len(text) <= max_len:
        return [text] if text else []
    pages: list[str] = []
    start = 0
    while start < len(text):
        end = min(start + max_len, len(text))
        if end < len(text):
            # prefer a whitespace boundary at or after min_len
            cut = text.rfind(" ", start + min_len, end)
            if cut > start:
                end = cut
        pages.append(text[start:end])
        start = end
        while start < len(text) and text[start] == " ":
            start += 1
    return pages


@register_stage
class PageSplitter(HasInputCol, HasOutputCol, Transformer):
    input_col = Param("text", "string column", ptype=str)
    output_col = Param("pages", "list-of-pages column", ptype=str)
    max_page_length = Param(5000, "max chars per page", ptype=int)
    min_page_length = Param(500, "min chars before a soft break", ptype=int)
    explode = Param(False, "one row per page instead of list column", ptype=bool)

    def _transform(self, table: Table) -> Table:
        pages = [
            _split_pages(str(s), self.get("max_page_length"),
                         min(self.get("min_page_length"), self.get("max_page_length") - 1))
            for s in table[self.get("input_col")]
        ]
        out = table.with_column(self.get("output_col"), pages)
        if self.get("explode"):
            from ..ops.stages import Explode

            return Explode(input_col=self.get("output_col")).transform(out)
        return out
