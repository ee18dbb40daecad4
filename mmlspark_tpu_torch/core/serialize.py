"""Stage save/load + global stage registry.

Reference: `core/serialize/` (ComplexParam, ConstructorWritable/Readable used
by LightGBM models, 17 typed params) and `core/utils/JarLoadingUtils` +
`codegen/` (reflection over all Wrappable stages). A copy of
mmlspark_tpu/core/serialize.py with its own registry: no JVM
reflection or codegen — a decorator registry makes every stage enumerable
(feeds the fuzzing harness, role of FuzzingTest.scala:27-100) and provides
load-by-name. Arrays (including nested pytrees of arrays, e.g. flax params)
go to `.npz`; nested stages recurse into subdirectories; everything else is
JSON. No pickle — saved stages are plain JSON + npz, portable across hosts.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

import numpy as np

__all__ = ["register_stage", "registry", "own_stages", "save_stage", "load_stage", "stage_class", "stage_to_blob", "stage_from_blob"]

_REGISTRY: dict[str, type] = {}          # qualified "module.ClassName" -> class
_BARE: dict[str, type | None] = {}       # bare ClassName -> class, None if ambiguous


def register_stage(cls: type) -> type:
    """Class decorator: adds the stage to the global registry under its
    qualified name `module.ClassName`; the bare name also resolves unless two
    registered classes share it (then bare lookup raises)."""
    qual = f"{cls.__module__}.{cls.__name__}"
    _REGISTRY[qual] = cls
    bare = cls.__name__
    if bare in _BARE and _BARE[bare] is not cls:
        _BARE[bare] = None  # ambiguous
    else:
        _BARE[bare] = cls
    return cls


def registry() -> dict[str, type]:
    return dict(_REGISTRY)


def own_stages() -> dict[str, type]:
    """The package's OWN registered stages. The registry is process-global,
    so a host process (notably the test suite's fixture stages) may have
    registered extras; completeness-style consumers — wrapper/doc
    generation, the fuzzing coverage walk — must enumerate only these."""
    return {q: c for q, c in _REGISTRY.items()
            if c.__module__ == "mmlspark_tpu_torch"
            or c.__module__.startswith("mmlspark_tpu_torch.")}


_REFERENCE_PREFIX = "mmlspark_tpu."


def stage_class(name: str) -> type:
    """Registered class by qualified or bare name. A qualified name of the
    JAX package (`mmlspark_tpu.<module>.<Class>`, as its blobs may carry)
    resolves to the port's class of the same module path."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name.startswith(_REFERENCE_PREFIX):
        ported = "mmlspark_tpu_torch." + name[len(_REFERENCE_PREFIX):]
        if ported in _REGISTRY:
            return _REGISTRY[ported]
        name = name.rsplit(".", 1)[-1]
    if name in _BARE:
        cls = _BARE[name]
        if cls is None:
            matches = sorted(q for q, c in _REGISTRY.items() if c.__name__ == name)
            raise KeyError(f"stage name {name!r} is ambiguous: {matches}")
        return cls
    raise KeyError(f"unknown stage class {name!r}; registered: {sorted(_REGISTRY)}")


# ---------------------------------------------------------------------------
# encoding


def _is_stage(v: Any) -> bool:
    from .pipeline import PipelineStage

    return isinstance(v, PipelineStage)


def _encode(value: Any, path: str, key: str, arrays: dict[str, np.ndarray]) -> Any:
    """Encode a state value into a JSON-able descriptor; side effects: nested
    stages saved under `path/key/`, arrays accumulated into `arrays`."""
    if _is_stage(value):
        sub = os.path.join(path, key)
        save_stage(value, sub)
        return {"__stage__": key}
    if isinstance(value, (np.integer, np.floating, np.bool_)):
        return value.item()
    if isinstance(value, np.ndarray):
        arrays[key] = value
        return {"__array__": key}
    if hasattr(value, "__array__") and not isinstance(value, (list, tuple, dict)):
        arrays[key] = np.asarray(value)
        return {"__array__": key}
    if isinstance(value, dict):
        return {
            "__dict__": {
                str(k): _encode(v, path, f"{key}.{k}", arrays) for k, v in value.items()
            }
        }
    if isinstance(value, (list, tuple)):
        return {
            "__list__": [
                _encode(v, path, f"{key}.{i}", arrays) for i, v in enumerate(value)
            ],
            "__tuple__": isinstance(value, tuple),
        }
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    raise TypeError(
        f"cannot serialize state value of type {type(value).__name__} (key {key!r})"
    )


def _decode(desc: Any, path: str, arrays: dict[str, np.ndarray]) -> Any:
    if isinstance(desc, dict):
        if "__stage__" in desc:
            return load_stage(os.path.join(path, desc["__stage__"]))
        if "__array__" in desc:
            return arrays[desc["__array__"]]
        if "__dict__" in desc:
            return {k: _decode(v, path, arrays) for k, v in desc["__dict__"].items()}
        if "__list__" in desc:
            vals = [_decode(v, path, arrays) for v in desc["__list__"]]
            return tuple(vals) if desc.get("__tuple__") else vals
    return desc


def save_stage(stage: Any, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    state_desc = {
        k: _encode(v, path, k, arrays) for k, v in stage._save_state().items()
    }
    doc = {
        "format_version": 1,
        "class": type(stage).__name__,
        "params": _jsonable_params(stage),
        "vector_cols": dict(stage._vector_cols),
        "state": state_desc,
    }
    with open(os.path.join(path, "stage.json"), "w") as f:
        json.dump(doc, f, indent=1, default=_json_default)
    if arrays:
        np.savez(os.path.join(path, "arrays.npz"), **arrays)


def _json_default(o: Any) -> Any:
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-able: {type(o).__name__}")


def _jsonable_params(stage: Any) -> dict[str, Any]:
    out = {}
    for k, v in stage.params_to_dict().items():
        try:
            json.dumps(v, default=_json_default)
            out[k] = v
        except TypeError:
            raise TypeError(
                f"{type(stage).__name__}.{k} holds non-JSON value {type(v).__name__}; "
                "move it to _save_state()/params_to_dict() exclusion"
            )
    return out


def load_stage(path: str) -> Any:
    with open(os.path.join(path, "stage.json")) as f:
        doc = json.load(f)
    cls = stage_class(doc["class"])
    from .params import Params

    stage = cls.__new__(cls)
    Params.__init__(stage)
    if doc["params"]:
        stage.set(**doc["params"])
    stage._vector_cols = dict(doc.get("vector_cols", {}))
    arrays: dict[str, np.ndarray] = {}
    npz_path = os.path.join(path, "arrays.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    state = {k: _decode(v, path, arrays) for k, v in doc["state"].items()}
    stage._load_state(state)
    return stage


def stage_to_blob(stage: Any) -> str:
    """Serialize a stage (directory format) into one base64 string — used by
    composite models (TrainedClassifierModel, TuneHyperparametersModel, …)
    to embed sub-stages in their own state, the role of the reference's
    ConstructorWritable nesting (core/serialize/ConstructorWriter.scala).

    The archive is deterministic: members are sorted and stamped with a
    fixed epoch, so two fits that produce the same stage produce the same
    blob — equal models compare equal as strings, across processes and
    across wall-clock time (the elastic-training byte-identity contract
    leans on this)."""
    import base64
    import io
    import tempfile
    import zipfile

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "stage")
        save_stage(stage, p)
        members = []
        for root, dirs, files in os.walk(p):
            dirs.sort()
            for fname in sorted(files):
                full = os.path.join(root, fname)
                members.append((os.path.relpath(full, p), full))
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as zf:
            for arcname, full in members:
                info = zipfile.ZipInfo(arcname, date_time=(1980, 1, 1,
                                                           0, 0, 0))
                with open(full, "rb") as fh:
                    zf.writestr(info, fh.read())
        return base64.b64encode(buf.getvalue()).decode()


def stage_from_blob(blob: str) -> Any:
    import base64
    import io
    import tempfile
    import zipfile

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "stage")
        with zipfile.ZipFile(io.BytesIO(base64.b64decode(blob))) as zf:
            zf.extractall(p)
        return load_stage(p)
