"""Stateful streaming operators: running and windowed aggregation with

A copy of mmlspark_tpu/streaming/state.py (host only; `SpillingStateBackend`
needs pyarrow, imported when it spills).
watermarks.

Reference: Spark's `groupBy().agg()` on a stream (complete output mode)
and `groupBy(window(...)).agg()` with `withWatermark` — the engine keeps
per-group running state across micro-batches, drops rows older than the
watermark, and finalizes a window only once the watermark passes its
end, at which point its state is evicted. The reference's serving and
anomaly pipelines run exactly these shapes over HTTP sources.

TPU redesign: the operators are ordinary registered Transformer stages —
`transform(batch)` folds the batch into held state and returns that
batch's output — so a StreamingQuery can put them inside any
PipelineModel and the registry machinery (fuzzing, R wrappers, api docs)
picks them up like any other stage. State is a JSON-able doc exposed via
`state_doc`/`load_state_doc`: the StreamingQuery snapshots it through
the commit log before every sink write (and restores the pre-batch doc
if the batch fails), which is what makes replay after kill-and-restart
produce identical output. The same doc flows through `_save_state`, so
`save/load` round-trips mid-stream state too.

Aggregates are kept as (count, sum, min, max) tuples — every supported
agg ("count", "sum", "mean", "min", "max") is derivable, and merging a
batch is O(rows) python regardless of which agg is requested.

Distributed additions (streaming/partition.py): state docs are key-order
DETERMINISTIC (sorted), so two runs that folded the same rows in a
different arrival order still checkpoint byte-identical docs — the
per-partition incremental-checkpoint diff depends on it. Accumulator
storage is pluggable through `StateBackend` (in-memory dict, or a
bounded hot set spilling cold keys to parquet), and operators accept a
driver-supplied `set_time_hint` so watermarks in a P-way run advance on
the GLOBAL batch rather than each partition's slice of it.
"""

from __future__ import annotations

import os
import uuid
from typing import Any

import numpy as np

from ..core.params import Param
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..core.serialize import register_stage

__all__ = ["StatefulOperator", "GroupedAggregator", "WindowedAggregator",
           "StateBackend", "MemoryStateBackend", "SpillingStateBackend"]

_AGGS = ("count", "sum", "mean", "min", "max")


def _new_acc() -> list:
    return [0, 0.0, None, None]          # [count, sum, min, max]


def _fold(acc: list, v: float) -> None:
    acc[0] += 1
    acc[1] += v
    acc[2] = v if acc[2] is None else min(acc[2], v)
    acc[3] = v if acc[3] is None else max(acc[3], v)


def _emit(acc: list, agg: str) -> float:
    if agg == "count":
        return float(acc[0])
    if agg == "sum":
        return float(acc[1])
    if agg == "mean":
        return float(acc[1]) / acc[0] if acc[0] else float("nan")
    if agg == "min":
        return float(acc[2]) if acc[2] is not None else float("nan")
    return float(acc[3]) if acc[3] is not None else float("nan")


class StateBackend:
    """Storage contract for per-key accumulator state.

    A stateful operator folds into mutable per-key accumulator lists via
    `acc(key)` and reads everything back — sorted by key — for emission
    and checkpointing. Backends trade memory for IO: `MemoryStateBackend`
    is a plain dict; `SpillingStateBackend` keeps a bounded hot set and
    spills cold keys to parquet, faulting them back on access.
    `end_batch()` is the operator's signal that a batch's folds are done;
    the spill backend enforces its hot-key bound there so mid-batch folds
    never thrash the spill file.
    """

    spilled_bytes = 0

    def acc(self, key: str) -> list:
        """Get-or-create the accumulator for `key` (mutated in place)."""
        raise NotImplementedError

    def items(self) -> "list[tuple[str, list]]":
        """Every (key, accumulator), sorted by key."""
        raise NotImplementedError

    def doc(self) -> dict:
        """Sorted-key JSON-able materialization of the full state."""
        return {k: list(v) for k, v in self.items()}

    def load(self, doc: dict) -> None:
        raise NotImplementedError

    def end_batch(self) -> None:
        """Called once per batch after the fold loop."""

    def __len__(self) -> int:
        raise NotImplementedError


class MemoryStateBackend(StateBackend):
    """All accumulators in one dict — the default, zero-IO backend."""

    def __init__(self) -> None:
        self._state: dict[str, list] = {}

    def acc(self, key: str) -> list:
        return self._state.setdefault(key, _new_acc())

    def items(self) -> "list[tuple[str, list]]":
        return sorted(self._state.items())

    def load(self, doc: dict) -> None:
        self._state = {str(k): list(v) for k, v in (doc or {}).items()}

    def __len__(self) -> int:
        return len(self._state)


class SpillingStateBackend(StateBackend):
    """Bounded-memory backend: at most `hot_keys` accumulators stay
    resident; the rest live in one parquet spill file under `spill_dir`
    and fault back on access. Faults are read-only (the cold index, not
    the file, is authoritative — stale rows are dropped at the next
    spill rewrite), so a fault costs one file read. `items()`/`doc()`
    read the file once WITHOUT promoting cold keys, so complete-mode
    emission and checkpointing leave the hot set untouched.
    """

    def __init__(self, spill_dir: str, hot_keys: int = 1024):
        os.makedirs(spill_dir, exist_ok=True)
        self.dir = spill_dir
        self.hot_keys = int(hot_keys)
        self.path = os.path.join(
            spill_dir, f"spill-{uuid.uuid4().hex}.parquet")
        self._hot: dict[str, list] = {}
        self._cold: set[str] = set()
        self.spilled_bytes = 0
        self.faults = 0

    def _read_cold(self) -> dict[str, list]:
        if not self._cold:
            return {}
        from ..core.table_io import read_parquet

        t = read_parquet(self.path)
        keys, cnt = t["key"], t["count"]
        sm, mn, mx = t["sum"], t["min"], t["max"]
        return {
            str(k): [int(cnt[i]), float(sm[i]),
                     None if np.isnan(mn[i]) else float(mn[i]),
                     None if np.isnan(mx[i]) else float(mx[i])]
            for i, k in enumerate(keys) if str(k) in self._cold}

    def _write_cold(self, cold: dict[str, list]) -> None:
        self._cold = set(cold)
        if not cold:
            if os.path.exists(self.path):
                os.unlink(self.path)
            self.spilled_bytes = 0
            return
        from ..core.table_io import write_parquet

        keys = sorted(cold)
        write_parquet(Table({
            "key": [str(k) for k in keys],
            "count": np.array([cold[k][0] for k in keys], dtype=np.float64),
            "sum": np.array([cold[k][1] for k in keys], dtype=np.float64),
            "min": np.array(
                [np.nan if cold[k][2] is None else cold[k][2]
                 for k in keys], dtype=np.float64),
            "max": np.array(
                [np.nan if cold[k][3] is None else cold[k][3]
                 for k in keys], dtype=np.float64),
        }), self.path)
        self.spilled_bytes = os.path.getsize(self.path)

    def acc(self, key: str) -> list:
        a = self._hot.get(key)
        if a is not None:
            # refresh recency: end_batch evicts least-recently-touched
            del self._hot[key]
        elif key in self._cold:
            a = self._read_cold()[key]
            self._cold.discard(key)
            self.faults += 1
        else:
            a = _new_acc()
        self._hot[key] = a
        return a

    def end_batch(self) -> None:
        over = len(self._hot) - self.hot_keys
        if over <= 0:
            return
        cold = self._read_cold()
        for k in list(self._hot)[:over]:
            cold[k] = self._hot.pop(k)
        self._write_cold(cold)

    def items(self) -> "list[tuple[str, list]]":
        merged = self._read_cold()
        merged.update(self._hot)
        return sorted(merged.items())

    def load(self, doc: dict) -> None:
        self._hot = {str(k): list(v) for k, v in (doc or {}).items()}
        self._write_cold({})
        self.end_batch()

    def __len__(self) -> int:
        return len(self._hot) + len(self._cold)


class StatefulOperator(Transformer):
    """Marker + contract for operators whose output depends on state folded
    across batches. StreamingQuery walks its transform for instances and
    checkpoints `state_doc()` per batch."""

    def state_doc(self) -> dict:
        """JSON-able snapshot of the held state. MUST be key-order
        deterministic (sorted) so identical state serializes to identical
        bytes regardless of arrival order."""
        raise NotImplementedError

    def load_state_doc(self, doc: dict) -> None:
        raise NotImplementedError

    def reset_state(self) -> None:
        self.load_state_doc({})

    # -- distributed-run contract (streaming/partition.py) ----------------- #

    def set_time_hint(self, t: "float | None") -> None:
        """Driver-supplied max event time of the GLOBAL batch about to
        transform. A partition folding only its slice would otherwise
        advance its watermark on the slice's max — time hints keep every
        partition's watermark equal to the single-partition run's, which
        is what makes P-way output byte-identical. No-op for operators
        without event-time semantics."""

    def merge_sort_cols(self) -> "list[str] | None":
        """Output columns a P-way merge must stable-sort by to
        reconstruct the single-partition output; None = the output has
        no canonical order (the merge restores original row order by a
        hidden row tag instead)."""
        return None

    def partition_key_col(self) -> "str | None":
        """Column this operator's state is keyed by — a keyed shuffle on
        exactly this column makes the operator partitionable. None =
        unkeyed state (single-partition only)."""
        return None

    # checkpoint doc doubles as the save/load persistence payload
    def _save_state(self) -> dict[str, Any]:
        return {"stream_state": self.state_doc()}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.load_state_doc(state.get("stream_state") or {})


def _values_of(table: Table, col: "str | None") -> "np.ndarray":
    """The numeric column to aggregate; all-ones when counting rows."""
    if col is None:
        return np.ones(table.num_rows, dtype=np.float64)
    return np.asarray(table[col], dtype=np.float64)


def _groups_of(table: Table, col: "str | None") -> list:
    if col is None:
        return [""] * table.num_rows    # single implicit group
    return [str(g) for g in table[col]]


@register_stage
class GroupedAggregator(StatefulOperator):
    """Running grouped aggregation in complete output mode: each batch
    folds into per-group accumulators and `transform` returns the CURRENT
    aggregate for every group seen so far, sorted by group key."""

    group_col = Param("key", "grouping column; rows sharing a value share "
                      "an accumulator", ptype=str)
    value_col = Param(None, "numeric column to aggregate; None counts rows",
                      ptype=str)
    agg = Param("count", "one of count|sum|mean|min|max", ptype=str,
                validator=lambda v: v in _AGGS)
    output_col = Param("aggregate", "output column holding the aggregate",
                       ptype=str)
    state_backend = Param("memory", "accumulator storage: 'memory' (one "
                          "dict) or 'spill' (bounded hot set + parquet "
                          "spill file)", ptype=str,
                          validator=lambda v: v in ("memory", "spill"))
    spill_dir = Param(None, "spill-file directory (required by the "
                      "'spill' backend)", ptype=str)
    spill_hot_keys = Param(1024, "max in-memory keys before the 'spill' "
                           "backend evicts cold keys to parquet",
                           ptype=int, validator=lambda v: v >= 1)

    # class-level default: blob/file reconstruction (`load_stage`) builds
    # via cls.__new__ and restores through load_state_doc without __init__
    _backend: "StateBackend | None" = None

    def backend(self) -> StateBackend:
        if self._backend is None:
            if self.get("state_backend") == "spill":
                d = self.get("spill_dir")
                if not d:
                    raise ValueError(
                        "state_backend='spill' requires spill_dir")
                self._backend = SpillingStateBackend(
                    d, self.get("spill_hot_keys"))
            else:
                self._backend = MemoryStateBackend()
        return self._backend

    @property
    def spilled_bytes(self) -> int:
        return self.backend().spilled_bytes

    def state_doc(self) -> dict:
        return {"groups": self.backend().doc()}

    def load_state_doc(self, doc: dict) -> None:
        self.backend().load(doc.get("groups") or {})

    def reset_state(self) -> None:
        self.backend().load({})

    def merge_sort_cols(self) -> "list[str] | None":
        return [self.get("group_col")]

    def partition_key_col(self) -> "str | None":
        return self.get("group_col")

    def _transform(self, table: Table) -> Table:
        b = self.backend()
        if table.num_rows:
            groups = _groups_of(table, self.get("group_col"))
            values = _values_of(table, self.get("value_col"))
            for g, v in zip(groups, values):
                _fold(b.acc(g), float(v))
            b.end_batch()
        agg = self.get("agg")
        items = b.items()
        return Table({
            self.get("group_col"): [k for k, _ in items],
            self.get("output_col"):
                np.array([_emit(acc, agg) for _, acc in items],
                         dtype=np.float64),
        })


@register_stage
class WindowedAggregator(StatefulOperator):
    """Tumbling-window aggregation with a watermark: rows are bucketed by
    `floor(time / window_s)`, rows older than the watermark are DROPPED
    (counted in `late_rows_dropped`), and a window is emitted exactly once
    — when the watermark (max event time seen minus `watermark_delay_s`)
    passes its end — then its state is evicted.

    Late-drop uses the watermark as of the START of the batch (the
    previous batches' event times), matching Spark: a batch cannot
    retroactively declare its own rows late. Emission uses the watermark
    AFTER folding the batch, so a single batch whose max event time
    clears `window_end + delay` finalizes that window immediately.
    `transform` returns only the windows finalized by that batch (append
    output mode), sorted by window start then group."""

    time_col = Param("time", "event-time column, in seconds", ptype=str)
    window_s = Param(60.0, "tumbling window length in seconds", ptype=float,
                     validator=lambda v: v > 0)
    group_col = Param(None, "optional sub-grouping column within windows",
                      ptype=str)
    value_col = Param(None, "numeric column to aggregate; None counts rows",
                      ptype=str)
    agg = Param("count", "one of count|sum|mean|min|max", ptype=str,
                validator=lambda v: v in _AGGS)
    output_col = Param("aggregate", "output column holding the aggregate",
                       ptype=str)
    watermark_delay_s = Param(0.0, "how long to admit out-of-order rows "
                              "past the max event time seen", ptype=float,
                              validator=lambda v: v >= 0)

    # class-level default: reconstruction via load_stage skips __init__
    # and only load_state_doc runs, which never carries a pending hint
    _time_hint: "float | None" = None

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        # {window_start(str): {group(str): [count, sum, min, max]}}
        self._windows: dict[str, dict[str, list]] = {}
        self._max_t: "float | None" = None
        self._time_hint: "float | None" = None
        self.late_rows_dropped = 0

    def state_doc(self) -> dict:
        return {
            "windows": {ws: {g: list(groups[g]) for g in sorted(groups)}
                        for ws, groups in sorted(self._windows.items(),
                                                 key=lambda kv:
                                                 float(kv[0]))},
            "max_t": self._max_t,
            "late": self.late_rows_dropped,
        }

    def load_state_doc(self, doc: dict) -> None:
        self._windows = {
            str(ws): {str(g): list(acc) for g, acc in groups.items()}
            for ws, groups in (doc.get("windows") or {}).items()}
        self._max_t = doc.get("max_t")
        self.late_rows_dropped = int(doc.get("late") or 0)

    def reset_state(self) -> None:
        self._windows = {}
        self._max_t = None
        self.late_rows_dropped = 0

    def watermark(self) -> "float | None":
        if self._max_t is None:
            return None
        return self._max_t - self.get("watermark_delay_s")

    def set_time_hint(self, t: "float | None") -> None:
        self._time_hint = t

    def merge_sort_cols(self) -> "list[str] | None":
        cols = ["window_start"]
        if self.get("group_col") is not None:
            cols.append(self.get("group_col"))
        return cols

    def partition_key_col(self) -> "str | None":
        return self.get("group_col")

    def _transform(self, table: Table) -> Table:
        win = self.get("window_s")
        low = self.watermark()          # watermark BEFORE this batch
        if table.num_rows:
            times = np.asarray(table[self.get("time_col")], dtype=np.float64)
            groups = _groups_of(table, self.get("group_col"))
            values = _values_of(table, self.get("value_col"))
            for t, g, v in zip(times, groups, values):
                t = float(t)
                if low is not None and t < low:
                    self.late_rows_dropped += 1
                    continue
                ws = float(np.floor(t / win) * win)
                bucket = self._windows.setdefault(repr(ws), {})
                _fold(bucket.setdefault(g, _new_acc()), float(v))
                if self._max_t is None or t > self._max_t:
                    self._max_t = t
        # the driver's time hint carries the GLOBAL batch max event time
        # (this partition's slice may be behind it — or empty); consumed
        # after the fold so late-drop still used the batch-START watermark
        hint, self._time_hint = self._time_hint, None
        if hint is not None and (self._max_t is None or hint > self._max_t):
            self._max_t = hint
        # finalize windows the post-batch watermark has passed
        high = self.watermark()
        agg = self.get("agg")
        done: list[tuple[float, str, list]] = []
        if high is not None:
            for ws_key in list(self._windows):
                ws = float(ws_key)
                if ws + win <= high:
                    for g, acc in self._windows.pop(ws_key).items():
                        done.append((ws, g, acc))
        done.sort(key=lambda x: (x[0], x[1]))
        cols: dict[str, Any] = {
            "window_start": np.array([d[0] for d in done], dtype=np.float64),
            "window_end": np.array([d[0] + win for d in done],
                                   dtype=np.float64),
        }
        if self.get("group_col") is not None:
            cols[self.get("group_col")] = [d[1] for d in done]
        cols[self.get("output_col")] = np.array(
            [_emit(d[2], agg) for d in done], dtype=np.float64)
        return Table(cols)

    def flush(self) -> Table:
        """Emit every still-open window regardless of watermark (end-of-
        stream drain); clears state."""
        win = self.get("window_s")
        agg = self.get("agg")
        done = [(float(ws), g, acc)
                for ws, groups in self._windows.items()
                for g, acc in groups.items()]
        done.sort(key=lambda x: (x[0], x[1]))
        self._windows = {}
        cols: dict[str, Any] = {
            "window_start": np.array([d[0] for d in done], dtype=np.float64),
            "window_end": np.array([d[0] + win for d in done],
                                   dtype=np.float64),
        }
        if self.get("group_col") is not None:
            cols[self.get("group_col")] = [d[1] for d in done]
        cols[self.get("output_col")] = np.array(
            [_emit(d[2], agg) for d in done], dtype=np.float64)
        return Table(cols)
