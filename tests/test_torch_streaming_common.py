"""Helpers shared by the port's streaming, partition, profiler and stage
tests: one namespace a package (the JAX package's and the port's, the same
names), a canonical form that compares results across the two packages
byte for byte, and a runner that plays one scenario in both. No tests
here."""

from __future__ import annotations

import importlib
import types

import numpy as np
import pytest

pytest.importorskip("torch")

REF, PORT = "mmlspark_tpu", "mmlspark_tpu_torch"

_MODULES = {
    "schema": "core.schema", "pipeline": "core.pipeline", "table_io": "core.table_io",
    "fusion": "core.fusion", "serialize": "core.serialize", "st": "streaming",
    "partition_mod": "streaming.partition", "io_http": "io_http",
    "serving": "io_http.serving", "http_schema": "io_http.schema", "wire": "io_http.wire",
    "profiler": "observability.profiler", "metrics": "observability.metrics",
    "tracing": "observability.tracing", "recorder": "observability.recorder",
    "fleet": "observability.fleet", "stage": "observability.stage", "plot": "plot",
}


def ns(pkg: str) -> types.SimpleNamespace:
    """The modules a scenario needs, from one package, plus the keyword
    arguments its device entry points take (the port's run on the CPU)."""
    out = types.SimpleNamespace(
        name=pkg, is_port=pkg == PORT,
        dev={"device": "cpu"} if pkg == PORT else {})
    for attr, mod in _MODULES.items():
        setattr(out, attr, importlib.import_module(f"{pkg}.{mod}"))
    out.Table = out.schema.Table
    return out


def canon(x):
    """A comparable form of a result: tables as their columns (dtype,
    shape and bytes of every array), arrays likewise, floats by repr."""
    if hasattr(x, "columns") and hasattr(x, "num_rows"):
        return ("table", x.num_rows, [(c, canon(x[c])) for c in x.columns])
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            return ("objarray", x.shape, [canon(v) for v in x.tolist()])
        return ("array", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return canon(x.item())
    if isinstance(x, float):
        return ("float", repr(x))
    if isinstance(x, dict):
        return ("dict", sorted((str(k), canon(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [canon(v) for v in x])
    if hasattr(x, "entity") and hasattr(x, "status_code"):
        return ("reply", x.status_code, bytes(x.entity or b""))
    return x


def both(scenario, tmp_path=None):
    """Run `scenario(m)` (or `scenario(m, dir)`) once with each package and
    assert the two results are the same; return the port's."""
    results = {}
    for pkg in (REF, PORT):
        m = ns(pkg)
        if tmp_path is None:
            results[pkg] = scenario(m)
        else:
            d = tmp_path / pkg
            d.mkdir()
            results[pkg] = scenario(m, d)
    assert canon(results[PORT]) == canon(results[REF])
    return results[PORT]


def assert_byte_identical(a, b) -> None:
    """Exact equality of two tables of one package."""
    assert sorted(a.columns) == sorted(b.columns)
    assert a.num_rows == b.num_rows
    for c in a.columns:
        ca, cb = a[c], b[c]
        if isinstance(ca, np.ndarray) or isinstance(cb, np.ndarray):
            np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))
        else:
            assert list(ca) == list(cb)
