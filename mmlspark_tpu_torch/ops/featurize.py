"""Auto-featurization.

Reference: `src/featurize/` — Featurize.scala:24-100 (per-output-col
AssembleFeatures pipeline; hash-bit defaults: 2^18 general, 2^12 for
tree/NN learners, Featurize.scala:13-19), AssembleFeatures.scala:93-311
(per-dtype strategy: numeric passthrough/cast, categorical one-hot via
metadata, string hashing, vector assembly with FastVectorAssembler).

TPU-first: the assembled features column is a dense (n, d) float32 matrix —
the layout the MXU wants — built in one pass; string hashing uses a stable
crc32 (not process-salted hash()).

A copy of mmlspark_tpu/ops/featurize.py; `AssembleFeaturesModel`'s
`device_kernel` (the assembly in a fused segment, core/fusion.py) runs in
torch.
"""

from __future__ import annotations

import zlib
from typing import Any

import numpy as np

from ..core.params import Param
from ..core.pipeline import Estimator, Model
from ..core.schema import CATEGORY_VALUES, Table, host_array
from ..core.serialize import register_stage

__all__ = ["Featurize", "AssembleFeatures", "AssembleFeaturesModel"]

_NUM_FEATURES_DEFAULT = 1 << 18  # Featurize.scala:13-19
_NUM_FEATURES_TREE = 1 << 12


def _stable_hash(s: str, buckets: int) -> int:
    return zlib.crc32(s.encode("utf-8")) % buckets


def _is_numeric(col: Any) -> bool:
    return (
        isinstance(col, np.ndarray)
        and col.dtype != object
        and np.issubdtype(col.dtype, np.number)
    )


@register_stage
class AssembleFeatures(Estimator):
    """Assemble chosen columns into one dense feature matrix column."""

    columns_to_featurize = Param(None, "input columns (default: all)", ptype=(list, tuple))
    features_col = Param("features", "output features column", ptype=str)
    number_of_features = Param(
        _NUM_FEATURES_TREE, "hash buckets for string columns", ptype=int
    )
    one_hot_encode_categoricals = Param(True, "one-hot categorical columns", ptype=bool)
    # A low-cardinality string column is a categorical in disguise: hashing
    # it into number_of_features buckets (4096 for trees) explodes the
    # downstream feature width — for the GBDT engine that is O(leaves x
    # features x bins) of histogram state. The reference avoids this because
    # its pipelines attach categorical METADATA first (AssembleFeatures.scala
    # one-hots on metadata); here the levels are learned at fit time.
    max_one_hot_cardinality = Param(
        100, "string columns with <= this many distinct values one-hot "
             "instead of hash (0 = always hash)", ptype=int,
    )
    allow_images = Param(False, "kept for API parity (images via ImageFeaturizer)", ptype=bool)

    def _fit(self, table: Table) -> "AssembleFeaturesModel":
        cols = list(self.get("columns_to_featurize") or table.columns)
        specs: list[dict] = []
        for name in cols:
            col = table[name]
            meta = table.meta(name)
            if CATEGORY_VALUES in meta:
                n_levels = len(meta[CATEGORY_VALUES])
                if self.get("one_hot_encode_categoricals"):
                    specs.append({"col": name, "kind": "onehot", "dim": n_levels})
                else:
                    specs.append({"col": name, "kind": "numeric", "dim": 1})
            elif _is_numeric(col):
                dim = 1 if col.ndim == 1 else int(col.shape[1])
                specs.append(
                    {"col": name, "kind": "numeric" if col.ndim == 1 else "vector", "dim": dim}
                )
            elif isinstance(col, list) and all(
                isinstance(v, str) or v is None for v in col
            ):
                specs.append(self._string_spec(name, col))
            else:
                raise TypeError(
                    f"AssembleFeatures: cannot featurize column {name!r} "
                    f"({type(col).__name__})"
                )
        m = AssembleFeaturesModel()
        m.set(features_col=self.get("features_col"))
        m.specs = specs
        return m

    def _string_spec(self, name: str, col: list) -> dict:
        """Single-token low-cardinality string columns are a categorical in
        disguise: one-hot them as learned levels (hashing them into
        `number_of_features` buckets explodes the downstream feature width —
        O(leaves x features x bins) of GBDT histogram state). Free text
        (multi-token values) and high-cardinality columns hash as before."""
        hash_spec = {"col": name, "kind": "hash",
                     "dim": self.get("number_of_features")}
        cap = int(self.get("max_one_hot_cardinality") or 0)
        # levels ARE one-hot encoding, so the explicit opt-outs win
        if cap <= 0 or not self.get("one_hot_encode_categoricals"):
            return hash_spec
        # short-circuit the distinct scan once the cap is exceeded; plain
        # str, not np.str_ (numpy scalars serialize as unhashable 0-d arrays)
        distinct: set[str] = set()
        for v in col:
            if v is None:
                continue
            s = str(v)
            if len(s.split()) > 1:      # free text -> bag-of-words hashing
                return hash_spec
            distinct.add(s)
            if len(distinct) > cap:
                return hash_spec
        if not distinct:
            return hash_spec
        levels = sorted(distinct)
        return {"col": name, "kind": "levels", "dim": len(levels),
                "levels": levels}


@register_stage
class AssembleFeaturesModel(Model):
    features_col = Param("features", "output features column", ptype=str)

    specs: list = []

    def _transform(self, table: Table) -> Table:
        n = table.num_rows
        parts: list[np.ndarray] = []
        names: list[str] = []
        for spec in self.specs:
            col = table[spec["col"]]
            kind, dim = spec["kind"], spec["dim"]
            if kind == "numeric":
                arr = host_array(col, np.float32).reshape(n, 1)
                names.append(spec["col"])
            elif kind == "vector":
                arr = host_array(col, np.float32).reshape(n, dim)
                names.extend(f"{spec['col']}_{i}" for i in range(dim))
            elif kind == "onehot":
                idx = host_array(col, np.int64)
                arr = np.zeros((n, dim), dtype=np.float32)
                valid = (idx >= 0) & (idx < dim)
                arr[np.arange(n)[valid], idx[valid]] = 1.0
                names.extend(f"{spec['col']}={i}" for i in range(dim))
            elif kind == "levels":
                level_of = {str(v): i for i, v in enumerate(spec["levels"])}
                arr = np.zeros((n, dim), dtype=np.float32)
                for i, v in enumerate(col):
                    j = None if v is None else level_of.get(str(v))
                    if j is not None:   # unseen/None -> all-zeros row
                        arr[i, j] = 1.0
                names.extend(f"{spec['col']}={v}" for v in spec["levels"])
            elif kind == "hash":
                arr = np.zeros((n, dim), dtype=np.float32)
                for i, v in enumerate(col):
                    if v is None:
                        continue
                    for token in str(v).split():
                        arr[i, _stable_hash(token, dim)] += 1.0
                names.extend(f"{spec['col']}#{i}" for i in range(dim))
            else:
                raise ValueError(f"unknown spec kind {kind!r}")
            parts.append(arr)
        features = (
            np.concatenate(parts, axis=1) if parts else np.zeros((n, 0), np.float32)
        )
        return table.with_column(
            self.get("features_col"), features, meta={"feature_names": names}
        )

    def device_kernel(self):
        """Fusion kernel (core/fusion.py): numeric/vector/onehot assembly is
        pure gather/compare/concat, byte-identical to the staged path
        (float->float32 rounds to nearest in both numpy and torch;
        float->int category indices truncate toward zero in both). String
        kinds (levels/hash) need host string processing, so any such spec
        keeps the whole stage on the host path."""
        import torch

        from ..core.fusion import DeviceKernel

        specs = list(self.specs)
        if not specs:
            return "no feature specs (empty assembly)"
        for s in specs:
            if s["kind"] not in ("numeric", "vector", "onehot"):
                return f"spec kind {s['kind']!r} needs host string processing"
        out_col = self.get("features_col")
        in_cols = tuple(dict.fromkeys(s["col"] for s in specs))
        names: list[str] = []
        for s in specs:
            if s["kind"] == "numeric":
                names.append(s["col"])
            elif s["kind"] == "vector":
                names.extend(f"{s['col']}_{i}" for i in range(s["dim"]))
            else:
                names.extend(f"{s['col']}={i}" for i in range(s["dim"]))

        def fn(params, cols):
            n = cols[specs[0]["col"]].shape[0]
            parts = []
            for s in specs:
                x = cols[s["col"]]
                if s["kind"] == "numeric":
                    parts.append(x.to(torch.float32).reshape(n, 1))
                elif s["kind"] == "vector":
                    parts.append(x.to(torch.float32).reshape(n, s["dim"]))
                else:  # onehot
                    idx = x.to(torch.int32)
                    valid = (idx >= 0) & (idx < s["dim"])
                    oh = idx[:, None] == torch.arange(s["dim"], device=x.device)[None, :]
                    parts.append((oh & valid[:, None]).to(torch.float32))
            return {out_col: torch.cat(parts, dim=1)}

        def ready(table: Table):
            for s in specs:
                col = table[s["col"]]
                if (s["kind"] == "onehot"
                        and np.issubdtype(col.dtype, np.floating)
                        and not np.isfinite(col).all()):
                    # host int64-cast of NaN/inf is a huge sentinel (-> zero
                    # row); a device float->int cast of them is undefined
                    return f"non-finite category indices in {s['col']!r}"
                if (np.issubdtype(col.dtype, np.integer) and col.size
                        and (col.min() < -(2 ** 31) or col.max() >= 2 ** 31)):
                    return f"values in {s['col']!r} exceed device int32"
            return True

        return DeviceKernel(
            fn=fn, input_cols=in_cols, output_cols=(out_col,),
            name="AssembleFeatures", out_dtypes={out_col: np.float32},
            out_meta={out_col: {"feature_names": names}}, ready=ready)

    def _save_state(self) -> dict[str, Any]:
        return {"specs": self.specs}

    def _load_state(self, state: dict[str, Any]) -> None:
        self.specs = state["specs"]


@register_stage
class Featurize(Estimator):
    """Auto-featurize columns into feature vector column(s).
    Reference: featurize/Featurize.scala:24-100 (feature_columns maps each
    output column to the set of input columns assembled into it)."""

    feature_columns = Param(
        None, "dict: output features col -> list of input cols", required=True, ptype=dict
    )
    number_of_features = Param(_NUM_FEATURES_TREE, "hash buckets", ptype=int)
    one_hot_encode_categoricals = Param(True, "one-hot categoricals", ptype=bool)
    max_one_hot_cardinality = Param(
        100, "low-cardinality string columns one-hot instead of hash", ptype=int,
    )
    allow_images = Param(False, "kept for API parity", ptype=bool)

    def _fit(self, table: Table) -> "Model":
        from ..core.pipeline import PipelineModel

        models = []
        for out_col, in_cols in self.get("feature_columns").items():
            asm = AssembleFeatures(
                columns_to_featurize=list(in_cols),
                features_col=out_col,
                number_of_features=self.get("number_of_features"),
                one_hot_encode_categoricals=self.get("one_hot_encode_categoricals"),
                max_one_hot_cardinality=self.get("max_one_hot_cardinality"),
            )
            models.append(asm.fit(table))
        return PipelineModel(models)
