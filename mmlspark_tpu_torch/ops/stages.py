"""Utility pipeline stages.

Reference: `src/pipeline-stages/` — DropColumns.scala:19, SelectColumns.scala:21,
RenameColumn.scala:18, Repartition.scala:18, Explode.scala:15, Lambda.scala:20,
UDFTransformer.scala:21, Cacher.scala:12, CheckpointData.scala:49-78,
TextPreprocessor.scala:14-95, ClassBalancer.scala:25-81; `src/udf/udfs.scala:15-29`.

Device notes: `Repartition` has no meaning for a host-columnar Table (row
placement is decided by `shard_rows` at compute time), so it re-chunks only
as a sharding *hint*; `Cacher`/`CheckpointData` pin device buffers instead of
Spark block-manager persistence.

A copy of mmlspark_tpu/ops/stages.py (host numpy code); `Cacher` puts
columns on the card as torch tensors where the reference puts jax arrays.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ..core.params import Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import Table, as_scalar, host_array
from ..core.serialize import register_stage

__all__ = [
    "DropColumns",
    "SelectColumns",
    "RenameColumn",
    "Repartition",
    "Explode",
    "Lambda",
    "UDFTransformer",
    "Cacher",
    "CheckpointData",
    "TextPreprocessor",
    "ClassBalancer",
    "ClassBalancerModel",
    "get_value_at",
    "to_vector",
]


@register_stage
class DropColumns(Transformer):
    """Reference: pipeline-stages/DropColumns.scala:19."""

    cols = Param(None, "columns to drop", required=True, ptype=(list, tuple))
    ignore_missing = Param(False, "skip absent columns silently", ptype=bool)

    def _transform(self, table: Table) -> Table:
        missing = [c for c in self.get("cols") if c not in table]
        if missing and not self.get("ignore_missing"):
            raise KeyError(f"DropColumns: columns not found: {missing}")
        return table.drop(*[c for c in self.get("cols") if c in table])


@register_stage
class SelectColumns(Transformer):
    """Reference: pipeline-stages/SelectColumns.scala:21."""

    cols = Param(None, "columns to keep", required=True, ptype=(list, tuple))

    def _transform(self, table: Table) -> Table:
        return table.select(*self.get("cols"))


@register_stage
class RenameColumn(Transformer):
    """Reference: pipeline-stages/RenameColumn.scala:18."""

    input_col = Param(None, "column to rename", required=True, ptype=str)
    output_col = Param(None, "new name", required=True, ptype=str)

    def _transform(self, table: Table) -> Table:
        return table.rename({self.get("input_col"): self.get("output_col")})


@register_stage
class Repartition(Transformer):
    """Reference: pipeline-stages/Repartition.scala:18. On TPU, row placement
    is decided by `shard_rows` over the mesh at compute time, so this stage
    only records the requested parallelism as table-level metadata consumed
    by downstream sharded stages."""

    n = Param(None, "requested number of shards", required=True, ptype=int)

    def _transform(self, table: Table) -> Table:
        if self.get("n") < 1:
            raise ValueError("Repartition.n must be >= 1")
        if not table.columns:
            return table
        first = table.columns[0]
        meta = dict(table.meta(first))
        meta["requested_shards"] = self.get("n")
        return table.with_meta(first, meta)


@register_stage
class Explode(Transformer):
    """Explode a list/array column into one row per element.
    Reference: pipeline-stages/Explode.scala:15."""

    input_col = Param(None, "column holding sequences", required=True, ptype=str)
    output_col = Param(None, "output column (default: input col)", ptype=str)

    def _transform(self, table: Table) -> Table:
        col = table[self.get("input_col")]
        out_name = self.get("output_col") or self.get("input_col")
        counts = [len(v) for v in col]
        idx = np.repeat(np.arange(table.num_rows), counts)
        exploded: list[Any] = [x for v in col for x in v]
        base = table.drop(self.get("input_col")).gather(idx)
        return base.with_column(out_name, exploded)



def _fn_to_path(fn, owner: str) -> str:
    """Serialize an importable module-level function as "module:qualname"."""
    mod, name = getattr(fn, "__module__", None), getattr(fn, "__qualname__", None)
    if not mod or not name or "<" in (name or ""):
        raise TypeError(
            f"{owner} is only serializable when the function is an importable "
            "module-level function"
        )
    return f"{mod}:{name}"


def _fn_from_path(path: str):
    import importlib

    mod, name = path.split(":")
    fn = importlib.import_module(mod)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


@register_stage
class Lambda(Transformer):
    """Arbitrary Table -> Table function as a stage.
    Reference: pipeline-stages/Lambda.scala:20. Not serializable unless the
    function is importable (saved by dotted path)."""

    fn = Param(None, "callable Table -> Table", required=True)

    def __init__(self, fn: Callable[[Table], Table] | None = None, **kw):
        super().__init__(**kw)
        if fn is not None:
            self.set(fn=fn)

    def _transform(self, table: Table) -> Table:
        return self.get("fn")(table)

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("fn", None)
        return d

    def _save_state(self) -> dict[str, Any]:
        return {"fn_path": _fn_to_path(self.get("fn"), "Lambda")}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(fn=_fn_from_path(state["fn_path"]))


@register_stage
class UDFTransformer(Transformer):
    """Apply a per-row (or whole-column) function to one column.
    Reference: pipeline-stages/UDFTransformer.scala:21."""

    input_col = Param(None, "input column", required=True, ptype=str)
    output_col = Param(None, "output column", required=True, ptype=str)
    udf = Param(None, "callable applied per row", required=True)
    vectorized = Param(False, "if true, udf receives the whole column", ptype=bool)

    def _transform(self, table: Table) -> Table:
        col = table[self.get("input_col")]
        fn = self.get("udf")
        if self.get("vectorized"):
            out = fn(col)
        else:
            out = [fn(v) for v in col]
        return table.with_column(self.get("output_col"), out)

    def params_to_dict(self) -> dict[str, Any]:
        d = dict(self._values)
        d.pop("udf", None)
        return d

    def _save_state(self) -> dict[str, Any]:
        return {"fn_path": _fn_to_path(self.get("udf"), "UDFTransformer")}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.set(udf=_fn_from_path(state["fn_path"]))


@register_stage
class Cacher(Transformer):
    """Materialize numeric columns as device-resident tensors so downstream
    compute stages skip the host->device transfer. Reference:
    pipeline-stages/Cacher.scala:12 (Spark .cache()); the device analogue
    of a hot cached Dataset is buffers already resident in the card's
    memory. Each column uploads as `DeviceTable.from_host` uploads it, in
    the dtype the reference's `jax.device_put` gives it (x64 off: float64
    as float32, int64 as int32). Asking for "cuda" without a card raises
    RuntimeError."""

    disable = Param(False, "skip caching", ptype=bool)
    device = Param("cuda", "torch device the columns go to: cuda | cpu", ptype=str)

    def _transform(self, table: Table) -> Table:
        if self.get("disable"):
            return table
        from ..core.kernels import resolve_device
        from ..core.table_io import device_column

        device = resolve_device(self.get("device"))
        out = table
        for name in table.columns:
            col = table[name]
            if isinstance(col, np.ndarray) and col.dtype != object:
                out = out.with_column(name, device_column(col, device))
        return out


@register_stage
class CheckpointData(Transformer):
    """Persist the table to host storage and continue from the materialized
    copy. Reference: checkpoint-data/CheckpointData.scala:49-78 (MEMORY_ONLY
    vs MEMORY_AND_DISK persist)."""

    to_disk = Param(False, "write a npz snapshot to disk", ptype=bool)
    path = Param(None, "snapshot path when to_disk", ptype=str)
    remove_checkpoint = Param(False, "delete a prior snapshot at path first", ptype=bool)

    def _transform(self, table: Table) -> Table:
        import os

        if self.get("to_disk"):
            path = self.get("path")
            if not path:
                raise ValueError("CheckpointData: to_disk requires path")
            if not path.endswith(".npz"):
                path += ".npz"  # np.savez appends it anyway; keep names aligned
            if self.get("remove_checkpoint") and os.path.exists(path):
                os.remove(path)
            numeric = {
                k: v
                for k, v in table.to_dict().items()
                if isinstance(v, np.ndarray) and v.dtype != object
            }
            np.savez(path, **numeric)
        return table


@register_stage
class TextPreprocessor(Transformer):
    """Trie-based find-and-replace normalization.
    Reference: pipeline-stages/TextPreprocessor.scala:14-95 (Trie with
    putAll/mapText, longest-match-wins replacement)."""

    input_col = Param(None, "input text column", required=True, ptype=str)
    output_col = Param(None, "output text column", required=True, ptype=str)
    map = Param(None, "dict of substring -> replacement", required=True, ptype=dict)
    normalize_case = Param(True, "lowercase before matching", ptype=bool)

    def _build_trie(self) -> dict:
        root: dict = {}
        for key, val in self.get("map").items():
            k = key.lower() if self.get("normalize_case") else key
            node = root
            for ch in k:
                node = node.setdefault(ch, {})
            node["$"] = val
        return root

    def _transform(self, table: Table) -> Table:
        trie = self._build_trie()
        out = []
        for text in table[self.get("input_col")]:
            s = text.lower() if self.get("normalize_case") else text
            res: list[str] = []
            i = 0
            while i < len(s):
                node, j, best, best_end = trie, i, None, i
                while j < len(s) and s[j] in node:
                    node = node[s[j]]
                    j += 1
                    if "$" in node:
                        best, best_end = node["$"], j
                if best is not None:
                    res.append(best)
                    i = best_end
                else:
                    res.append(s[i])
                    i += 1
            out.append("".join(res))
        return table.with_column(self.get("output_col"), out)


@register_stage
class ClassBalancer(Estimator):
    """Compute inverse-frequency instance weights for label balance.
    Reference: pipeline-stages/ClassBalancer.scala:25-81."""

    input_col = Param(None, "label column", required=True, ptype=str)
    output_col = Param("weight", "weight output column", ptype=str)
    broadcast_join = Param(True, "kept for API parity (ignored)", ptype=bool)

    def _fit(self, table: Table) -> "ClassBalancerModel":
        col = table[self.get("input_col")]
        vals, counts = np.unique(host_array(col), return_counts=True)
        weights = counts.max() / counts.astype(np.float64)
        m = ClassBalancerModel()
        m.set(input_col=self.get("input_col"), output_col=self.get("output_col"))
        m.values = [as_scalar(v) for v in vals]
        m.weights = weights
        return m


@register_stage
class ClassBalancerModel(Model):
    input_col = Param(None, "label column", required=True, ptype=str)
    output_col = Param("weight", "weight output column", ptype=str)

    values: list = []
    weights: np.ndarray = np.zeros(0)

    def _transform(self, table: Table) -> Table:
        lookup = {v: w for v, w in zip(self.values, self.weights)}
        col = table[self.get("input_col")]
        w = np.asarray([lookup[as_scalar(v)] for v in col])
        return table.with_column(self.get("output_col"), w)

    def _save_state(self) -> dict[str, Any]:
        return {"values": list(self.values), "weights": self.weights}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.values = state["values"]
        self.weights = state["weights"]


def get_value_at(vector_col: np.ndarray, i: int) -> np.ndarray:
    """Reference: udf/udfs.scala:15-21 (get_value_at)."""
    return host_array(vector_col)[:, i]


def to_vector(list_col) -> np.ndarray:
    """Reference: udf/udfs.scala:23-29 (to_vector)."""
    return np.asarray([host_array(v, np.float64) for v in list_col])
