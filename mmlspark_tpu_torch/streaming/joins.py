"""Streaming joins: stream-stream interval join and stream-table

A copy of mmlspark_tpu/streaming/joins.py (host only).
(broadcast) join with watermark semantics.

Reference: Spark's stream-stream inner join — both sides buffer rows
per key, each arriving row probes the opposite buffer, and the
watermark bounds how long a buffered row can wait for a match before it
is evicted (`join_window_s` is the interval condition
`|t_left - t_right| <= window`). Stream-table joins are Spark's
broadcast join of a stream against a static DataFrame.

These are the first operators that REQUIRE the keyed shuffle: per-key
two-sided buffers only stay correct when every row of a key lands on
the same partition (`StreamStreamJoin.partition_key_col`). Determinism
under partitioning follows the same discipline as the aggregators —
state docs are key-sorted, watermarks advance on driver time hints, and
the per-batch output is canonically ordered (sorted by key, left time,
right time) so a P-way merge reconstructs the P=1 output byte-for-byte.

A joined pair is emitted in the batch that completes it (eager inner
join): whichever side arrives second finds the first in the buffer.
Rows older than the batch-start watermark are dropped as late; buffered
rows older than `watermark - join_window_s` can no longer match any
admissible future row and are evicted.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage
from .state import StatefulOperator

__all__ = ["StreamStreamJoin", "StreamTableJoin"]


@register_stage
class StreamStreamJoin(StatefulOperator):
    """Inner interval join of two event streams multiplexed in one table.

    Input rows carry a key, an event time, a side tag (`side_col` equal
    to `left_tag` or `right_tag`) and a value. Output rows are matched
    pairs: `key_col`, `left_time`, `right_time`, `left_<value_col>`,
    `right_<value_col>`, sorted by (key, left_time, right_time).
    """

    key_col = Param("key", "join key; rows sharing a value can match",
                    ptype=str)
    time_col = Param("time", "event-time column, in seconds", ptype=str)
    side_col = Param("side", "column tagging each row's stream",
                     ptype=str)
    left_tag = Param("left", "side_col value marking left-stream rows",
                     ptype=str)
    right_tag = Param("right", "side_col value marking right-stream rows",
                      ptype=str)
    value_col = Param("value", "numeric payload column carried through "
                      "the join", ptype=str)
    join_window_s = Param(60.0, "max |left_time - right_time| for a "
                          "match", ptype=float, validator=lambda v: v >= 0)
    watermark_delay_s = Param(0.0, "how long to admit out-of-order rows "
                              "past the max event time seen", ptype=float,
                              validator=lambda v: v >= 0)

    # class-level default: reconstruction via load_stage skips __init__
    # and only load_state_doc runs, which never carries a pending hint
    _time_hint: "float | None" = None

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        # {key: [[time, value], ...]} in arrival order, per side
        self._left: dict[str, list] = {}
        self._right: dict[str, list] = {}
        self._max_t: "float | None" = None
        self._time_hint: "float | None" = None
        self.late_rows_dropped = 0

    # -- state ------------------------------------------------------------- #

    def state_doc(self) -> dict:
        return {
            "left": {k: [list(r) for r in self._left[k]]
                     for k in sorted(self._left)},
            "right": {k: [list(r) for r in self._right[k]]
                      for k in sorted(self._right)},
            "max_t": self._max_t,
            "late": self.late_rows_dropped,
        }

    def load_state_doc(self, doc: dict) -> None:
        self._left = {str(k): [list(r) for r in v]
                      for k, v in (doc.get("left") or {}).items()}
        self._right = {str(k): [list(r) for r in v]
                       for k, v in (doc.get("right") or {}).items()}
        self._max_t = doc.get("max_t")
        self.late_rows_dropped = int(doc.get("late") or 0)

    def reset_state(self) -> None:
        self._left, self._right = {}, {}
        self._max_t = None
        self.late_rows_dropped = 0

    def watermark(self) -> "float | None":
        if self._max_t is None:
            return None
        return self._max_t - self.get("watermark_delay_s")

    def set_time_hint(self, t: "float | None") -> None:
        self._time_hint = t

    def merge_sort_cols(self) -> "list[str] | None":
        return [self.get("key_col"), "left_time", "right_time"]

    def partition_key_col(self) -> "str | None":
        return self.get("key_col")

    @property
    def buffered_rows(self) -> int:
        return (sum(len(v) for v in self._left.values())
                + sum(len(v) for v in self._right.values()))

    # -- one batch ---------------------------------------------------------- #

    def _evict(self, low: "float | None") -> None:
        """Drop buffered rows that can no longer match: any future row
        has t >= watermark, so a buffered row older than
        `watermark - join_window_s` is out of every admissible interval."""
        if low is None:
            return
        horizon = low - self.get("join_window_s")
        for buf in (self._left, self._right):
            for k in list(buf):
                kept = [r for r in buf[k] if r[0] >= horizon]
                if kept:
                    buf[k] = kept
                else:
                    del buf[k]

    def _transform(self, table: Table) -> Table:
        win = self.get("join_window_s")
        low = self.watermark()          # watermark BEFORE this batch
        self._evict(low)
        left_tag = self.get("left_tag")
        out: list[tuple] = []           # (key, lt, rt, lv, rv)
        if table.num_rows:
            times = np.asarray(table[self.get("time_col")],
                               dtype=np.float64)
            keys = [str(k) for k in table[self.get("key_col")]]
            sides = [str(s) for s in table[self.get("side_col")]]
            values = np.asarray(table[self.get("value_col")],
                                dtype=np.float64)
            for t, k, side, v in zip(times, keys, sides, values):
                t, v = float(t), float(v)
                if low is not None and t < low:
                    self.late_rows_dropped += 1
                    continue
                is_left = side == left_tag
                own = self._left if is_left else self._right
                other = self._right if is_left else self._left
                for t2, v2 in other.get(k, ()):
                    if abs(t - t2) <= win:
                        out.append((k, t, t2, v, v2) if is_left
                                   else (k, t2, t, v2, v))
                own.setdefault(k, []).append([t, v])
                if self._max_t is None or t > self._max_t:
                    self._max_t = t
        hint, self._time_hint = self._time_hint, None
        if hint is not None and (self._max_t is None or hint > self._max_t):
            self._max_t = hint
        # canonical order: a P-way merge stable-sorts by the same triple,
        # and ties (same key+times) keep per-key emission order, which is
        # arrival order and thus partition-invariant
        out.sort(key=lambda e: (e[0], e[1], e[2]))
        vc = self.get("value_col")
        return Table({
            self.get("key_col"): [e[0] for e in out],
            "left_time": np.array([e[1] for e in out], dtype=np.float64),
            "right_time": np.array([e[2] for e in out], dtype=np.float64),
            f"left_{vc}": np.array([e[3] for e in out], dtype=np.float64),
            f"right_{vc}": np.array([e[4] for e in out], dtype=np.float64),
        })


@register_stage
class StreamTableJoin(Transformer):
    """Broadcast join of a stream against a static table on disk.

    The static side (csv or parquet, keyed uniquely by `key_col`) loads
    lazily once and every batch row looks up its match: `how="left"`
    keeps all batch rows (unmatched static columns become NaN / ""),
    `how="inner"` drops unmatched rows. Stateless, so it runs anywhere
    in a partition chain — or before the shuffle on the driver."""

    key_col = Param("key", "join key present in both sides", ptype=str)
    table_path = Param(None, "csv or parquet file holding the static "
                       "side", ptype=str)
    how = Param("left", "'left' keeps unmatched stream rows, 'inner' "
                "drops them", ptype=str,
                validator=lambda v: v in ("left", "inner"))

    # class-level defaults so a blob-reconstructed instance (no __init__)
    # lazy-loads the static side exactly like a fresh one
    _static: "Table | None" = None
    _index: "dict[str, int] | None" = None

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        self._static: "Table | None" = None
        self._index: "dict[str, int] | None" = None

    def _load_static(self) -> Table:
        if self._static is None:
            path = self.get("table_path")
            if not path:
                raise ValueError("StreamTableJoin requires table_path")
            if path.endswith(".parquet"):
                from ..core.table_io import read_parquet

                self._static = read_parquet(path)
            else:
                from ..core.table_io import read_csv

                self._static = read_csv(path)
            key = self.get("key_col")
            index: dict[str, int] = {}
            for i, k in enumerate(self._static[key]):
                k = str(k)
                if k in index:
                    raise ValueError(
                        f"static table {path!r} has duplicate key {k!r}")
                index[k] = i
            self._index = index
        return self._static

    def _transform(self, table: Table) -> Table:
        static = self._load_static()
        key = self.get("key_col")
        hits = [self._index.get(str(k), -1) for k in table[key]]
        if self.get("how") == "inner":
            keep = np.array([h >= 0 for h in hits], dtype=bool)
            table = table.gather(keep)
            hits = [h for h in hits if h >= 0]
        out = table
        for name in static.columns:
            if name == key:
                continue
            col = static[name]
            numeric = isinstance(col, np.ndarray) and \
                np.issubdtype(col.dtype, np.number)
            if numeric:
                vals = np.array(
                    [float(col[h]) if h >= 0 else np.nan for h in hits],
                    dtype=np.float64)
            else:
                vals = [str(col[h]) if h >= 0 else "" for h in hits]
            dest = name if name not in out.columns else f"right_{name}"
            out = out.with_column(dest, vals)
        return out
