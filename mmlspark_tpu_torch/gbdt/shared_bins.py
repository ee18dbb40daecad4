"""Shared binned dataset for AutoML sweeps — bins build once, boosters vary.

Every GBDT trial of a hyperparameter sweep re-bins the SAME feature
matrix: `Booster.train` fits a fresh `BinMapper` and re-transforms its
fold slice per fit, so a 20-trial × 3-fold sweep pays the quantile
sketch and the host binning 60 times for one dataset (the reference has
the same shape: each LightGBM trial rebuilds its Dataset from the
shared DataFrame). Binning is row-wise — `bins(x[idx]) == bins(x)[idx]`
— so a sweep can bin the FULL table once, keep the binned matrix
device-resident, and serve every fold of every trial by a device gather.

`SharedBinContext` is that cache. A sweep worker seeds it with the full
feature matrix per binning config; `Booster.train` consults the ambient
context (`lookup`) before fitting a mapper — a hit returns the shared
mapper plus the trial's rows gathered on device, a miss falls back to
the normal per-fit build. Hits and builds are counted
(`mmlspark_tpu_gbdt_bin_builds_total` / `..._bin_cache_hits_total`), so
a sweep can PROVE bins built exactly once. The shared mapper is fit on
the full table, so CV folds share the full-data bin boundaries
(LightGBM-style sweep semantics); a sweep is byte-identical across
worker counts because every worker applies the same rule.

Skipped (normal build, counted): sparse inputs, warm starts (the warm
model owns its mapper), `device_binning` (its f32-snapped boundaries
are a different contract), and any binning-config mismatch — a trial
sweeping `max_bin` must re-bin, not inherit the wrong boundaries.

Counterpart of mmlspark_tpu/gbdt/shared_bins.py. The full binned matrix
lives on a torch device as an int32 tensor (the seeding estimator's
`device`, "cuda" by default); a hit gathers its rows there with
`index_select` and the fit hands them to the fused loop and K1 as they
are, with no host re-binning. The device is part of the binning config:
a fit on another device misses and builds its own bins (counted).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

import numpy as np
import torch

from ..observability.sanitizer import make_lock

__all__ = ["SharedBinContext", "get_shared_bin_context",
           "set_shared_bin_context", "bin_counters", "mapper_digest"]

_COUNTERS = (
    ("mmlspark_tpu_gbdt_bin_builds_total",
     "BinMapper fits (quantile sketch + full binning passes)"),
    ("mmlspark_tpu_gbdt_bin_cache_hits_total",
     "Booster.train fits served from a SharedBinContext device gather"),
)


def _count(name: str, n: float = 1) -> None:
    try:
        from ..observability.metrics import get_registry

        doc = dict(_COUNTERS)[name]
        get_registry().counter(name, doc).inc(n)
    except Exception:  # noqa: BLE001 — telemetry never blocks training
        pass


def bin_counters() -> dict[str, float]:
    """Current process-wide build/hit counts (the sweep proof reads
    these through the worker status op)."""
    from ..observability.metrics import get_registry

    reg = get_registry()
    (builds_name, builds_doc), (hits_name, hits_doc) = _COUNTERS
    return {"builds": reg.counter(builds_name, builds_doc).value,
            "hits": reg.counter(hits_name, hits_doc).value}


def _row_digest(row: np.ndarray) -> bytes:
    return hashlib.blake2b(row.tobytes(), digest_size=16).digest()


def _config_key(max_bin: int, categorical_indexes: tuple,
                bin_construct_sample_cnt: int, device: str) -> tuple:
    return (int(max_bin), tuple(int(c) for c in categorical_indexes),
            int(bin_construct_sample_cnt), str(device))


class _Entry:
    """One (binning config, full matrix) build: the fitted mapper, the
    full binned matrix resident on device, and a row-content index so a
    fold slice maps back to full-table rows by value, not by trust."""

    def __init__(self, mapper, bins_full: np.ndarray, device):
        self.mapper = mapper
        self.bins_dev = torch.as_tensor(
            np.ascontiguousarray(bins_full, np.int32), device=device)
        self.num_features = bins_full.shape[1]


class _SharedHit:
    """A successful lookup: the shared mapper + a device gather of the
    requesting fit's rows from the resident full matrix."""

    def __init__(self, entry: _Entry, idx: np.ndarray):
        self.mapper = entry.mapper
        self._entry = entry
        self._idx = idx

    def device_bins(self, lo: int = 0, hi: "int | None" = None):
        """Rows [lo, hi) of the requesting fit, gathered on the device
        from the resident full matrix (int32)."""
        bins = self._entry.bins_dev
        idx = torch.as_tensor(self._idx[lo:hi], device=bins.device)
        return bins.index_select(0, idx)


class SharedBinContext:
    """Process-ambient cache of binned full-table feature matrices."""

    def __init__(self):
        self._lock = make_lock("SharedBinContext._lock")
        self._entries: dict[tuple, _Entry] = {}
        self._indexes: dict[tuple, dict[bytes, int]] = {}

    def seed(self, x: np.ndarray, *, max_bin: int = 255,
             categorical_indexes: tuple = (),
             bin_construct_sample_cnt: int = 200_000,
             device: str = "cuda") -> None:
        """Bin the FULL matrix once for this config and keep it on
        `device` (idempotent: a re-seed with the same config and shape is
        a no-op, so a worker may seed per trial without re-paying the
        build)."""
        from ..core.kernels import resolve_device
        from .binning import BinMapper
        from .sparse import as_features, is_sparse

        if is_sparse(x):
            return                     # sparse stays on the per-fit path
        dev = resolve_device(device)
        x = np.ascontiguousarray(np.asarray(as_features(x), np.float64))
        key = _config_key(max_bin, categorical_indexes,
                          bin_construct_sample_cnt, dev)
        with self._lock:
            if key in self._entries:
                return
        mapper = BinMapper(
            max_bin=int(max_bin),
            categorical_indexes=tuple(categorical_indexes),
            bin_construct_sample_cnt=int(bin_construct_sample_cnt),
        ).fit(x)
        bins_full = mapper.transform(x)
        _count("mmlspark_tpu_gbdt_bin_builds_total")
        index = {_row_digest(x[i]): i for i in range(x.shape[0])}
        entry = _Entry(mapper, bins_full, dev)
        with self._lock:
            self._entries.setdefault(key, entry)
            self._indexes.setdefault(key, index)

    def lookup(self, x: np.ndarray, *, max_bin: int,
               categorical_indexes: tuple,
               bin_construct_sample_cnt: int,
               device: str = "cuda") -> "_SharedHit | None":
        """Match every row of `x` (by content digest) against the seeded
        full matrix for this binning config on `device`; None on any
        mismatch."""
        key = _config_key(max_bin, categorical_indexes,
                          bin_construct_sample_cnt, torch.device(device))
        with self._lock:
            entry = self._entries.get(key)
            index = self._indexes.get(key)
        if entry is None or index is None:
            return None
        x = np.ascontiguousarray(np.asarray(x, np.float64))
        if x.ndim != 2 or x.shape[1] != entry.num_features:
            return None
        idx = np.empty(x.shape[0], np.int64)
        for i in range(x.shape[0]):
            j = index.get(_row_digest(x[i]))
            if j is None:
                return None
            idx[i] = j
        _count("mmlspark_tpu_gbdt_bin_cache_hits_total")
        return _SharedHit(entry, idx)


_ACTIVE_LOCK = make_lock("shared_bins._ACTIVE_LOCK")
_ACTIVE: "SharedBinContext | None" = None


def set_shared_bin_context(ctx: "SharedBinContext | None"
                           ) -> "SharedBinContext | None":
    """Install `ctx` as the process-ambient context; returns the
    previous one (None uninstalls)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        old, _ACTIVE = _ACTIVE, ctx
    return old


def get_shared_bin_context() -> "SharedBinContext | None":
    with _ACTIVE_LOCK:
        return _ACTIVE


def note_bin_build() -> None:
    """Count a normal (non-shared) in-train BinMapper build."""
    _count("mmlspark_tpu_gbdt_bin_builds_total")


def mapper_digest(mapper: Any) -> str:
    """Canonical digest of a BinMapper's boundaries. Elastic workers
    verify the mapper shipped in the training spec against this before
    binning locally: identical boundaries on every member are the
    precondition for the cross-process histogram merge to be exact."""
    doc = json.dumps(mapper.to_dict(), sort_keys=True)
    return hashlib.blake2b(doc.encode("utf-8"), digest_size=16).hexdigest()


def lookup_shared_bins(x: Any, opts: Any, device) -> "_SharedHit | None":
    """`Booster.train`'s hook: a hit iff a context is ambient, the input
    is dense, the caller did not opt into device binning, and the rows +
    binning config (the fit's `device` included) match a seeded build."""
    from .sparse import is_sparse

    ctx = get_shared_bin_context()
    if ctx is None or opts.device_binning or is_sparse(x):
        return None
    return ctx.lookup(
        x, max_bin=opts.max_bin,
        categorical_indexes=tuple(opts.categorical_indexes),
        bin_construct_sample_cnt=opts.bin_construct_sample_cnt,
        device=device)
