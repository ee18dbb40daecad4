"""Telemetry timeline: embedded metrics history, alerting, regression watch.

Every other observability layer — fleet `/metrics` aggregation, flight-
recorder dumps, the phase ledger, `diagnose.py` tables — is a point-in-
time snapshot: the instant a scrape is read, its history is gone. This
module turns those instants into a durable system of record:

`TimelineStore`
    Embedded append-only time-series store. Fleet scrape snapshots are
    flattened to `(series, labels) -> value` maps and persisted as
    delta-encoded, checksummed segment files (`seg-<seq>.bin`), written
    with `utils.storage.atomic_write` and recovered with the same
    torn-file tolerance as `resilience.elastic.TrainingCheckpointer`:
    a truncated or bit-flipped segment is quarantined and reads fall
    back to the newest intact one. Each segment is self-contained (a
    full base sample plus sparse deltas), so queries never need a
    segment that retention already pruned.

`TimelineRecorder`
    Sampling loop on the injectable clock: reads `MetricsAggregator`
    (or any registry-shaped `.snapshot()` source) at a configurable
    cadence, appends to the store, and drives the attached
    `AlertEngine`/`RegressionWatch`. Its own health series
    (`timeline_samples_total`, segment count, inter-sample gap) are
    overlaid into every appended snapshot so segments self-describe.

Query engine (on the store)
    `rate()`, `increase()`, windowed `quantile_over()` on histogram
    series, gauge `avg/max/min_over()` and `slope()` — all label-matcher
    selected and exact across segment boundaries and process restarts.

`AlertEngine`
    Declarative generalization of `SLOEngine`'s hard-coded burn alerts:
    rules are (`expr`, `for_s`, `severity`) over ANY recorded series.
    A rule firing records a `timeline.alert` flight-recorder event, can
    trigger a black-box dump, and exports pending/firing state as
    gauges into the fleet scrape (merge policy `max`: any replica
    firing means the fleet is firing).

`RegressionWatch`
    The runtime analogue of `tools/bench_gate.py`: continuously compares
    current phase-ledger attribution (compute/collective/d2h shares,
    shard skew) and serving p50/p99 against a recorded-baseline window
    and raises a `timeline.regression` alert when a series drifts
    outside its historical noise band (mean ± k·std over the baseline).

See docs/observability.md ("Telemetry timeline & alerting").

A copy of mmlspark_tpu/observability/timeline.py.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import struct
import threading
import time
from typing import Any, Callable, Iterator

from ..utils.storage import atomic_write
from .sanitizer import allow_blocking, make_lock

__all__ = [
    "TimelineStore", "TimelineRecorder", "AlertRule", "AlertEngine",
    "RegressionWatch", "SEGMENT_PREFIX", "TIMELINE_SERIES",
]

# --------------------------------------------------------------------- #
# segment file format                                                   #
# --------------------------------------------------------------------- #

# Mirrors the TrainingCheckpointer envelope: magic + blake2b-16 + length,
# then the JSON payload. A reader that finds a short header, wrong magic,
# truncated payload, or digest mismatch treats the file as torn and falls
# back to the newest intact segment.
_MAGIC = b"MMLTLSEG"
_DIGEST_SIZE = 16
_HEADER = struct.Struct(f">8s{_DIGEST_SIZE}sQ")
_FORMAT_VERSION = 1

SEGMENT_PREFIX = "seg-"
_SEGMENT_RE = re.compile(r"^seg-(\d{8})\.bin$")

# flat-key separator between series name and canonical label JSON
_SEP = "\x1f"

# the timeline's own series manifest (overlaid into every sample so the
# segments self-describe recorder health, alert state, and dump times)
TIMELINE_SERIES: dict[str, tuple[str, tuple[str, ...]]] = {
    "mmlspark_tpu_timeline_samples_total": ("counter", ()),
    "mmlspark_tpu_timeline_segments_count": ("gauge", ()),
    "mmlspark_tpu_timeline_last_sample_age_seconds": ("gauge", ()),
    "mmlspark_tpu_timeline_alert_state_count":
        ("gauge", ("rule", "severity", "series")),
    "mmlspark_tpu_timeline_dump_timestamp_seconds": ("gauge", ()),
}


def _flat_key(name: str, labels: "dict[str, str] | None") -> str:
    return name + _SEP + json.dumps(labels or {}, sort_keys=True)


def _split_key(key: str) -> "tuple[str, dict]":
    name, _, lbl = key.partition(_SEP)
    return name, json.loads(lbl or "{}")


def _flatten(snapshot: dict) -> "tuple[dict, dict]":
    """snapshot -> (flat map, kinds). Counter/gauge samples flatten to a
    float; histogram samples keep {count, sum, buckets} as one value so
    windowed quantiles can diff cumulative buckets exactly."""
    flat: dict[str, Any] = {}
    kinds: dict[str, str] = {}
    for name, fam in snapshot.items():
        kind = fam.get("kind", "gauge")
        kinds[name] = kind
        for s in fam.get("samples", []):
            key = _flat_key(name, s.get("labels"))
            if "buckets" in s:
                flat[key] = {"count": float(s.get("count", 0.0)),
                             "sum": float(s.get("sum", 0.0)),
                             "buckets": {str(k): float(v) for k, v
                                         in s.get("buckets", {}).items()}}
            else:
                flat[key] = float(s.get("value", 0.0))
    return flat, kinds


def _match(labels: dict, matchers: "dict[str, str] | None") -> bool:
    if not matchers:
        return True
    return all(labels.get(k) == v for k, v in matchers.items())


class _MonotonicClock:
    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


# --------------------------------------------------------------------- #
# TimelineStore                                                         #
# --------------------------------------------------------------------- #

class TimelineStore:
    """Append-only, delta-encoded, checksummed metrics history.

    dir              segment directory (created on first append)
    keep             sealed-segment retention; oldest files are unlinked
                     once more than `keep` segments exist
    segment_samples  samples per segment before rotation; each segment
                     is self-contained (full base + sparse deltas), so a
                     pruned prefix never breaks queries over the suffix

    The active segment is rewritten through `atomic_write` on every
    append — a reader (or a crash) sees either the previous or the new
    segment content, never a torn file. Corrupt files found during a
    scan are skipped, matching `TrainingCheckpointer.load_latest`'s
    fall-back-past-corruption contract.
    """

    def __init__(self, dir: str, *, keep: int = 8,
                 segment_samples: int = 64):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        if segment_samples < 2:
            raise ValueError("segment_samples must be >= 2")
        self.dir = str(dir)
        self.keep = int(keep)
        self.segment_samples = int(segment_samples)
        self._lock = make_lock("TimelineStore._lock")
        self._active: "dict | None" = None   # open segment doc
        self._last_flat: "dict | None" = None
        self._segments_pruned = 0
        seqs = [seq for seq, _path, ok in self._scan() if ok]
        self._next_seq = (max(seqs) + 1) if seqs else 1

    # -- file layer ----------------------------------------------------- #

    def _path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{SEGMENT_PREFIX}{seq:08d}.bin")

    def _scan(self) -> "list[tuple[int, str, bool]]":
        """(seq, path, intact) for every segment file, seq-ascending."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for fn in sorted(names):
            m = _SEGMENT_RE.match(fn)
            if not m:
                continue
            path = os.path.join(self.dir, fn)
            ok, _detail, _doc = self.verify_file(path)
            out.append((int(m.group(1)), path, ok))
        out.sort(key=lambda t: t[0])
        return out

    @staticmethod
    def verify_file(path: str) -> "tuple[bool, str, dict | None]":
        """(intact, detail, doc). detail on failure is one of: missing,
        short-header, bad-magic, truncated, checksum-mismatch,
        bad-payload — the same taxonomy the checkpoint store reports."""
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return False, "missing", None
        if len(raw) < _HEADER.size:
            return False, "short-header", None
        magic, digest, length = _HEADER.unpack_from(raw)
        if magic != _MAGIC:
            return False, "bad-magic", None
        payload = raw[_HEADER.size:]
        if len(payload) != length:
            return False, "truncated", None
        if hashlib.blake2b(payload, digest_size=_DIGEST_SIZE).digest() \
                != digest:
            return False, "checksum-mismatch", None
        try:
            doc = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return False, "bad-payload", None
        return True, "ok", doc

    def _write(self, doc: dict) -> None:
        payload = json.dumps(doc, sort_keys=True,
                             separators=(",", ":")).encode("utf-8")
        digest = hashlib.blake2b(payload,
                                 digest_size=_DIGEST_SIZE).digest()
        header = _HEADER.pack(_MAGIC, digest, len(payload))
        atomic_write(self._path(doc["seq"]), header + payload)

    # -- writing -------------------------------------------------------- #

    def append(self, t: float, snapshot: dict) -> None:
        """Record one sample. Flattens the snapshot, delta-encodes it
        against the previous sample, rewrites the active segment
        atomically, and rotates + prunes when the segment is full."""
        flat, kinds = _flatten(snapshot)
        with self._lock:
            if self._active is None:
                self._active = {"version": _FORMAT_VERSION,
                                "seq": self._next_seq,
                                "kinds": dict(kinds),
                                "t0": float(t), "base": flat,
                                "deltas": []}
                self._next_seq += 1
            else:
                prev = self._last_flat or {}
                delta: dict[str, Any] = {
                    k: v for k, v in flat.items()
                    if k not in prev or prev[k] != v}
                for k in prev:
                    if k not in flat:
                        delta[k] = None          # tombstone: series gone
                self._active["kinds"].update(kinds)
                self._active["deltas"].append([float(t), delta])
            self._last_flat = flat
            # the fsync'd rewrite must stay under the lock: it IS the
            # serialized mutation (a concurrent append racing the write
            # would interleave torn segment states), and it is bounded
            # by one segment's payload
            with allow_blocking("timeline segment rewrite on append"):
                self._write(self._active)
            if 1 + len(self._active["deltas"]) >= self.segment_samples:
                self._active = None              # sealed; next append rotates
                self._prune_locked()

    def _prune_locked(self) -> None:
        entries = self._scan()
        excess = len(entries) - self.keep
        for seq, path, _ok in entries[:max(excess, 0)]:
            try:
                os.unlink(path)
                self._segments_pruned += 1
            except OSError:
                pass

    def compact(self) -> int:
        """Merge every intact segment into one (re-delta-encoded against
        the oldest base) and unlink the originals. Returns the number of
        segments removed. Runs under an `allow_blocking` justification:
        the rewrite does O(history) disk work while holding the store
        lock, which is exactly the blocking-under-lock shape the
        sanitizer exists to flag — here it is the documented cost of
        bounding the file count."""
        with self._lock, allow_blocking(
                "timeline compaction rewrites the full history in place; "
                "bounded by keep*segment_samples samples"):
            entries = [(s, p) for s, p, ok in self._scan() if ok]
            if len(entries) <= 1:
                return 0
            merged: "dict | None" = None
            prev_flat: "dict | None" = None
            for _seq, path in entries:
                ok, _d, doc = self.verify_file(path)
                if not ok:
                    continue
                for t, flat in _replay(doc):
                    if merged is None:
                        merged = {"version": _FORMAT_VERSION,
                                  "seq": self._next_seq,
                                  "kinds": dict(doc["kinds"]),
                                  "t0": t, "base": dict(flat),
                                  "deltas": []}
                    else:
                        merged["kinds"].update(doc["kinds"])
                        delta = {k: v for k, v in flat.items()
                                 if k not in prev_flat
                                 or prev_flat[k] != v}
                        for k in prev_flat:
                            if k not in flat:
                                delta[k] = None
                        merged["deltas"].append([t, delta])
                    prev_flat = dict(flat)
            if merged is None:
                return 0
            self._next_seq += 1
            self._write(merged)
            removed = 0
            for _seq, path in entries:
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    pass
            # the merged segment stays open only on disk; in-memory
            # appends start a fresh segment after it
            self._active = None
            self._last_flat = prev_flat
            return removed

    # -- reading -------------------------------------------------------- #

    def segments(self) -> "list[dict]":
        """[{seq, path, intact, samples, t_first, t_last}] seq-ascending
        — the `diagnose.py --history` inventory, corrupt files included
        (flagged, never raised)."""
        out = []
        for seq, path, ok in self._scan():
            row = {"seq": seq, "path": path, "intact": ok,
                   "samples": 0, "t_first": None, "t_last": None}
            if ok:
                _ok, _d, doc = self.verify_file(path)
                row["samples"] = 1 + len(doc["deltas"])
                row["t_first"] = doc["t0"]
                row["t_last"] = (doc["deltas"][-1][0] if doc["deltas"]
                                 else doc["t0"])
            out.append(row)
        return out

    def samples(self, since: "float | None" = None,
                until: "float | None" = None
                ) -> "Iterator[tuple[float, dict]]":
        """Yield (t, flat) across every intact segment, time-ordered.
        The yielded dict is a fresh copy per sample. The in-memory
        active segment is already on disk (append rewrites it), so the
        disk scan alone is the complete, restart-safe view."""
        with self._lock:
            entries = [(s, p) for s, p, ok in self._scan() if ok]
        for _seq, path in entries:
            ok, _d, doc = self.verify_file(path)
            if not ok:
                continue            # raced a prune/compact: skip
            for t, flat in _replay(doc):
                if since is not None and t < since:
                    continue
                if until is not None and t > until:
                    return
                yield t, dict(flat)

    def kinds(self) -> "dict[str, str]":
        merged: dict[str, str] = {}
        for _seq, path, ok in self._scan():
            if not ok:
                continue
            ok2, _d, doc = self.verify_file(path)
            if ok2:
                merged.update(doc.get("kinds", {}))
        return merged

    def series(self, name: str,
               labels: "dict[str, str] | None" = None,
               since: "float | None" = None,
               until: "float | None" = None
               ) -> "dict[str, list[tuple[float, Any]]]":
        """{labels-json: [(t, value), ...]} for every labelset of `name`
        matching the (subset-equality) label matchers."""
        out: dict[str, list] = {}
        prefix = name + _SEP
        for t, flat in self.samples(since, until):
            for key, val in flat.items():
                if not key.startswith(prefix):
                    continue
                _n, lbl = _split_key(key)
                if not _match(lbl, labels):
                    continue
                out.setdefault(key[len(prefix):], []).append((t, val))
        return out

    def last_time(self) -> "float | None":
        t_last = None
        for row in self.segments():
            if row["intact"] and row["t_last"] is not None:
                t_last = (row["t_last"] if t_last is None
                          else max(t_last, row["t_last"]))
        return t_last

    # -- query engine --------------------------------------------------- #

    def _window(self, name: str, window_s: float,
                labels: "dict[str, str] | None",
                at: "float | None") -> "tuple[float, dict]":
        if at is None:
            at = self.last_time()
            if at is None:
                return 0.0, {}
        return at, self.series(name, labels, since=at - window_s,
                               until=at)

    def increase(self, name: str, window_s: float,
                 labels: "dict[str, str] | None" = None,
                 at: "float | None" = None) -> float:
        """Counter growth over [at - window_s, at], summed across
        matching labelsets. Counter resets (a replica restart drops the
        cumulative value) contribute only their post-reset growth — the
        sum of positive point-to-point deltas, never a negative spike."""
        _at, per = self._window(name, window_s, labels, at)
        total = 0.0
        for pts in per.values():
            for (t0, v0), (_t1, v1) in zip(pts, pts[1:]):
                d = _scalar(v1) - _scalar(v0)
                if d > 0:
                    total += d
        return total

    def rate(self, name: str, window_s: float,
             labels: "dict[str, str] | None" = None,
             at: "float | None" = None) -> float:
        """`increase / window_s` — per-second rate over the window."""
        if window_s <= 0:
            return 0.0
        return self.increase(name, window_s, labels, at) / window_s

    def _gauge_points(self, name: str, window_s: float,
                      labels: "dict[str, str] | None",
                      at: "float | None") -> "list[tuple[float, float]]":
        _at, per = self._window(name, window_s, labels, at)
        pts = [(t, _scalar(v)) for series in per.values()
               for t, v in series]
        pts.sort()
        return pts

    def avg_over(self, name: str, window_s: float,
                 labels: "dict[str, str] | None" = None,
                 at: "float | None" = None) -> float:
        pts = self._gauge_points(name, window_s, labels, at)
        return sum(v for _t, v in pts) / len(pts) if pts else 0.0

    def max_over(self, name: str, window_s: float,
                 labels: "dict[str, str] | None" = None,
                 at: "float | None" = None) -> float:
        pts = self._gauge_points(name, window_s, labels, at)
        return max((v for _t, v in pts), default=0.0)

    def min_over(self, name: str, window_s: float,
                 labels: "dict[str, str] | None" = None,
                 at: "float | None" = None) -> float:
        pts = self._gauge_points(name, window_s, labels, at)
        return min((v for _t, v in pts), default=0.0)

    def last_value(self, name: str,
                   labels: "dict[str, str] | None" = None,
                   at: "float | None" = None) -> float:
        pts = self._gauge_points(name, float("inf"), labels, at)
        return pts[-1][1] if pts else 0.0

    def slope(self, name: str, window_s: float,
              labels: "dict[str, str] | None" = None,
              at: "float | None" = None) -> float:
        """Least-squares slope (units/second) of a gauge over the window
        — the autoscaler's trend signal: a rising queue with headroom
        today still pages tomorrow."""
        pts = self._gauge_points(name, window_s, labels, at)
        if len(pts) < 2:
            return 0.0
        n = len(pts)
        mt = sum(t for t, _v in pts) / n
        mv = sum(v for _t, v in pts) / n
        den = sum((t - mt) ** 2 for t, _v in pts)
        if den <= 0:
            return 0.0
        return sum((t - mt) * (v - mv) for t, v in pts) / den

    def quantile_over(self, name: str, q: float, window_s: float,
                      labels: "dict[str, str] | None" = None,
                      at: "float | None" = None) -> float:
        """Windowed quantile of a histogram series: cumulative-bucket
        deltas between the first and last sample inside the window,
        merged across matching labelsets, then linearly interpolated
        within the winning bucket (SeriesReader.histogram_quantile's
        estimator, applied to a window instead of all-time)."""
        _at, per = self._window(name, window_s, labels, at)
        merged: dict[str, float] = {}
        for pts in per.values():
            hists = [(t, v) for t, v in pts if isinstance(v, dict)]
            if not hists:
                continue
            first, last = hists[0][1], hists[-1][1]
            for bound, cum in last.get("buckets", {}).items():
                d = cum - first.get("buckets", {}).get(bound, 0.0)
                if len(hists) == 1:
                    d = cum          # single sample: all-time histogram
                merged[bound] = merged.get(bound, 0.0) + max(d, 0.0)
        return _bucket_quantile(merged, q)

    # -- evaluation entry point for alert expressions ------------------- #

    def eval_func(self, func: str, name: str,
                  labels: "dict[str, str] | None", window_s: float,
                  q: "float | None" = None,
                  at: "float | None" = None) -> float:
        table: dict[str, Callable] = {
            "rate": self.rate, "increase": self.increase,
            "avg_over": self.avg_over, "max_over": self.max_over,
            "min_over": self.min_over,
        }
        if func == "last":
            return self.last_value(name, labels, at=at)
        if func == "quantile":
            return self.quantile_over(name, float(q or 0.5), window_s,
                                      labels, at=at)
        if func not in table:
            raise ValueError(f"unknown timeline function {func!r}")
        return table[func](name, window_s, labels, at=at)


def _replay(doc: dict) -> "Iterator[tuple[float, dict]]":
    """Yield (t, flat-state) for every sample of one segment doc. The
    yielded dict is the running state — callers copy if they retain."""
    state = dict(doc["base"])
    yield doc["t0"], state
    for t, delta in doc["deltas"]:
        for k, v in delta.items():
            if v is None:
                state.pop(k, None)
            else:
                state[k] = v
        yield t, state


def _scalar(v: Any) -> float:
    """Histogram values quantify as their cumulative count; scalars pass
    through — lets rate()/increase() work on `_seconds` histograms (the
    event rate) without a separate _count series."""
    if isinstance(v, dict):
        return float(v.get("count", 0.0))
    return float(v)


def _bucket_quantile(buckets: "dict[str, float]", q: float) -> float:
    """SeriesReader.histogram_quantile's linear-interpolation estimator
    over an explicit (already windowed/merged) cumulative-bucket dict."""
    if not buckets:
        return 0.0
    finite = sorted((float(b), c) for b, c in buckets.items()
                    if b not in ("+Inf", "inf", "Inf"))
    total = max((c for _b, c in buckets.items()), default=0.0)
    inf_c = buckets.get("+Inf", total)
    total = max(total, inf_c)
    if total <= 0:
        return 0.0
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in finite:
        if cum >= target:
            span = cum - prev_cum
            if span <= 0:
                return bound
            frac = (target - prev_cum) / span
            return prev_bound + (bound - prev_bound) * frac
    return finite[-1][0] if finite else 0.0


# --------------------------------------------------------------------- #
# alert rules                                                           #
# --------------------------------------------------------------------- #

_EXPR_RE = re.compile(
    r"""^\s*
    (?:(?P<func>rate|increase|avg_over|max_over|min_over|last|quantile)
       \(\s*(?:(?P<q>[0-9.]+)\s*,\s*)?)?
    (?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)
    (?:\{(?P<labels>[^}]*)\})?
    (?:\[(?P<window>[0-9.]+)s\])?
    (?(func)\s*\))
    \s*(?P<op><=|>=|<|>)\s*
    (?P<threshold>-?[0-9.eE+]+)
    \s*$""", re.VERBOSE)

_LABEL_RE = re.compile(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"([^"]*)"\s*')

_OPS: dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
}


def _parse_labels(text: "str | None") -> "dict[str, str]":
    out: dict[str, str] = {}
    if not text:
        return out
    for part in text.split(","):
        if not part.strip():
            continue
        m = _LABEL_RE.fullmatch(part)
        if not m:
            raise ValueError(f"bad label matcher {part!r} "
                             '(expected name="value")')
        out[m.group(1)] = m.group(2)
    return out


class AlertRule:
    """One declarative alert: `expr` over any recorded series, `for_s`
    debounce, severity, and optionally a black-box dump on firing.

    Expression grammar (one comparison per rule — paging logic stays
    declarative and diffable, like the SLO burn thresholds it
    generalizes)::

        rate(name{label="v"}[60s]) > 5
        increase(name[300s]) >= 10
        avg_over(name{x="y"}[30s]) < 0.5
        max_over(name[60s]) > 100
        quantile(0.99, name[120s]) > 0.25
        name{label="v"} > 3              # last recorded value
    """

    def __init__(self, name: str, expr: str, *, for_s: float = 0.0,
                 severity: str = "ticket", dump: bool = False):
        m = _EXPR_RE.match(expr)
        if m is None:
            raise ValueError(f"cannot parse alert expr {expr!r}")
        self.name = str(name)
        self.expr = expr
        self.for_s = float(for_s)
        self.severity = str(severity)
        self.dump = bool(dump)
        self.func = m.group("func") or "last"
        self.series = m.group("name")
        self.labels = _parse_labels(m.group("labels"))
        self.window_s = float(m.group("window") or 0.0)
        self.q = float(m.group("q")) if m.group("q") else None
        if self.func == "quantile" and self.q is None:
            raise ValueError("quantile(...) needs a q argument: "
                             "quantile(0.99, series[60s])")
        if self.func not in ("last",) and self.window_s <= 0.0:
            raise ValueError(
                f"{self.func}(...) needs a window: {self.series}[60s]")
        self._op = _OPS[m.group("op")]
        self.threshold = float(m.group("threshold"))

    def value(self, store: TimelineStore,
              at: "float | None" = None) -> float:
        return store.eval_func(self.func, self.series, self.labels,
                               self.window_s, self.q, at=at)

    def breached(self, store: TimelineStore,
                 at: "float | None" = None) -> "tuple[bool, float]":
        v = self.value(store, at)
        return self._op(v, self.threshold), v


_STATE_VALUE = {"ok": 0.0, "pending": 1.0, "firing": 2.0}


class AlertEngine:
    """Evaluates declarative rules against the timeline.

    State machine per rule: ok -> pending while the expression holds ->
    firing once it has held for `for_s` continuously (FakeClock-exact).
    The ok->firing edge records a `timeline.alert` flight-recorder event
    and, for `dump=True` rules, triggers a black-box dump; the state is
    exported as `timeline_alert_state_count{rule,severity,series}`
    (0/1/2) so the fleet scrape — and therefore the timeline itself —
    carries the alert history."""

    def __init__(self, store: TimelineStore,
                 rules: "list[AlertRule] | tuple[AlertRule, ...]" = (),
                 *, clock: Any = None, recorder: Any = None,
                 registry: Any = None):
        self.store = store
        self.rules: list[AlertRule] = list(rules)
        self._clock = clock if clock is not None else _MonotonicClock()
        self._recorder = recorder
        self._watch: "RegressionWatch | None" = None
        self._lock = make_lock("AlertEngine._lock")
        self._pending_since: dict[str, float] = {}
        self._state: dict[str, str] = {}
        self._reg = registry
        self._g_state = None
        self._g_dump_ts = None
        if registry is not None:
            self._init_gauges(registry)

    def _init_gauges(self, registry: Any) -> None:
        self._g_state = registry.gauge(
            "mmlspark_tpu_timeline_alert_state_count",
            "alert rule state: 0 ok, 1 pending, 2 firing",
            labels=("rule", "severity", "series"))
        self._g_dump_ts = registry.gauge(
            "mmlspark_tpu_timeline_dump_timestamp_seconds",
            "clock time of the last alert-triggered flight-recorder dump")

    def add(self, rule: AlertRule) -> None:
        with self._lock:
            self.rules.append(rule)

    def attach_recorder(self, recorder: Any) -> None:
        self._recorder = recorder

    def attach_watch(self, watch: "RegressionWatch") -> None:
        """Regression breaches surface through the same state machine as
        declarative rules (severity `regression`, no for_s debounce —
        the watch's own baseline window is the debounce)."""
        self._watch = watch

    def states(self) -> "dict[str, str]":
        with self._lock:
            return dict(self._state)

    def firing(self) -> "list[str]":
        with self._lock:
            return sorted(n for n, s in self._state.items()
                          if s == "firing")

    def evaluate(self, at: "float | None" = None) -> "dict[str, dict]":
        """One evaluation pass; `at` defaults to the clock (tests pin it
        to the sample time for exactness). Returns
        {rule: {state, value, since}}."""
        now = self._clock.monotonic() if at is None else at
        results: dict[str, dict] = {}
        with self._lock:
            rules = list(self.rules)
        for rule in rules:
            try:
                hit, value = rule.breached(self.store, at=now)
            except Exception:  # noqa: BLE001 — a bad series must not stop eval
                hit, value = False, float("nan")
            results[rule.name] = self._transition(
                rule.name, rule.severity, rule.series, hit, value, now,
                rule.for_s, dump=rule.dump, kind="timeline.alert",
                expr=rule.expr)
        if self._watch is not None:
            for b in self._watch.evaluate(self.store, at=now):
                rname = f"regression:{b['series']}"
                results[rname] = self._transition(
                    rname, "regression", b["series"], b["breached"],
                    b["current"], now, 0.0, dump=False,
                    kind="timeline.regression", band=b["band"],
                    baseline_mean=b["mean"])
        return results

    def _transition(self, name: str, severity: str, series: str,
                    hit: bool, value: float, now: float, for_s: float,
                    *, dump: bool, kind: str, **detail: Any) -> dict:
        with self._lock:
            prev = self._state.get(name, "ok")
            if not hit:
                self._pending_since.pop(name, None)
                state = "ok"
            else:
                since = self._pending_since.setdefault(name, now)
                state = ("firing" if now - since >= for_s else "pending")
            self._state[name] = state
            since = self._pending_since.get(name)
        if self._g_state is not None:
            self._g_state.labels(rule=name, severity=severity,
                                 series=series).set(_STATE_VALUE[state])
        if state == "firing" and prev != "firing":
            self._on_fire(name, severity, series, value, now, dump,
                          kind, detail)
        return {"state": state, "value": value, "since": since}

    def _on_fire(self, name: str, severity: str, series: str,
                 value: float, now: float, dump: bool, kind: str,
                 detail: dict) -> None:
        rec = self._recorder
        if rec is None:
            return
        try:
            rec.record(kind, rule=name, severity=severity,
                       series=series, value=value, **detail)
            if dump:
                path = rec.trigger_dump(f"{kind}:{name}", rule=name,
                                        severity=severity, series=series)
                if path is not None and self._g_dump_ts is not None:
                    self._g_dump_ts.set(now)
        except Exception:  # noqa: BLE001 — paging must not kill the loop
            pass


# --------------------------------------------------------------------- #
# regression watch                                                      #
# --------------------------------------------------------------------- #

# (series-key, kind) pairs the watch derives from the phase ledger and
# serving histograms; see _observe for how each value is computed.
_PHASE_SECONDS = "mmlspark_tpu_profiler_phase_seconds"
_SHARD_SECONDS = "mmlspark_tpu_profiler_shard_phase_seconds"
_SERVING_LATENCY = "mmlspark_tpu_serving_latency_seconds"
_WATCH_PHASES = ("compute", "collective", "d2h")


class RegressionWatch:
    """Live analogue of `tools/bench_gate.py`: drift detection against a
    recorded baseline instead of an offline round trajectory.

    Every evaluation derives the current value of each watched series
    over the last `current_s` seconds, then rebuilds the same value for
    each of the `baseline_chunks` preceding windows of the same width.
    The baseline band is mean ± max(k·std, abs_eps, rel_eps·|mean|) —
    the historical noise band; a current value outside it is a breach.
    Watched series:

      phase_share:<p>   phase p's share of total phase seconds
                        (compute / collective / d2h)
      shard_skew        slowest/fastest shard seconds over the window
      serving_p50/p99   windowed latency quantiles
    """

    def __init__(self, *, baseline_chunks: int = 5,
                 current_s: float = 60.0, k: float = 3.0,
                 abs_eps: float = 0.02, rel_eps: float = 0.10,
                 min_baseline_points: int = 3):
        if baseline_chunks < 2:
            raise ValueError("baseline_chunks must be >= 2")
        self.baseline_chunks = int(baseline_chunks)
        self.current_s = float(current_s)
        self.k = float(k)
        self.abs_eps = float(abs_eps)
        self.rel_eps = float(rel_eps)
        self.min_baseline_points = int(min_baseline_points)

    # -- derived observations ------------------------------------------- #

    def _observe(self, store: TimelineStore, at: float,
                 window_s: float) -> "dict[str, float | None]":
        out: "dict[str, float | None]" = {}
        per_phase: dict[str, float] = {}
        for p in _WATCH_PHASES:
            # histogram increase counts events; shares need seconds —
            # diff the per-labelset `sum` field directly
            per = store.series(_PHASE_SECONDS, {"phase": p},
                               since=at - window_s, until=at)
            secs = 0.0
            for pts in per.values():
                hists = [v for _t, v in pts if isinstance(v, dict)]
                if len(hists) >= 2:
                    secs += max(hists[-1]["sum"] - hists[0]["sum"], 0.0)
            per_phase[p] = secs
        all_per = store.series(_PHASE_SECONDS, None,
                               since=at - window_s, until=at)
        all_secs = 0.0
        for pts in all_per.values():
            hists = [v for _t, v in pts if isinstance(v, dict)]
            if len(hists) >= 2:
                all_secs += max(hists[-1]["sum"] - hists[0]["sum"], 0.0)
        for p in _WATCH_PHASES:
            out[f"phase_share:{p}"] = (per_phase[p] / all_secs
                                       if all_secs > 0 else None)
        shard = store.series(_SHARD_SECONDS, None,
                             since=at - window_s, until=at)
        per_shard: dict[str, float] = {}
        for lbl_json, pts in shard.items():
            lbl = json.loads(lbl_json or "{}")
            hists = [v for _t, v in pts if isinstance(v, dict)]
            if len(hists) >= 2:
                per_shard[lbl.get("shard", "?")] = \
                    per_shard.get(lbl.get("shard", "?"), 0.0) + \
                    max(hists[-1]["sum"] - hists[0]["sum"], 0.0)
        if len(per_shard) >= 2 and min(per_shard.values()) > 0:
            out["shard_skew"] = (max(per_shard.values())
                                 / min(per_shard.values()))
        else:
            out["shard_skew"] = None
        for label, q in (("serving_p50", 0.5), ("serving_p99", 0.99)):
            v = store.quantile_over(_SERVING_LATENCY, q, window_s, at=at)
            out[label] = v if v > 0 else None
        return out

    # -- evaluation ----------------------------------------------------- #

    def evaluate(self, store: TimelineStore,
                 at: "float | None" = None) -> "list[dict]":
        """[{series, breached, current, mean, std, band}] for every
        watched series with enough baseline history; silent (empty) when
        the store is still warming up."""
        if at is None:
            at = store.last_time()
            if at is None:
                return []
        w = self.current_s
        current = self._observe(store, at, w)
        baselines: dict[str, list[float]] = {}
        for i in range(1, self.baseline_chunks + 1):
            obs = self._observe(store, at - i * w, w)
            for key, v in obs.items():
                if v is not None:
                    baselines.setdefault(key, []).append(v)
        out = []
        for key, cur in sorted(current.items()):
            base = baselines.get(key, [])
            if cur is None or len(base) < self.min_baseline_points:
                continue
            mean = sum(base) / len(base)
            var = sum((b - mean) ** 2 for b in base) / len(base)
            band = max(self.k * math.sqrt(var), self.abs_eps,
                       self.rel_eps * abs(mean))
            out.append({"series": key, "current": cur, "mean": mean,
                        "std": math.sqrt(var), "band": band,
                        "breached": abs(cur - mean) > band})
        return out


# --------------------------------------------------------------------- #
# TimelineRecorder                                                      #
# --------------------------------------------------------------------- #

class TimelineRecorder:
    """Sampling loop: snapshot the source, append to the store, drive
    the alert engine / regression watch.

    store       a TimelineStore, or a directory to create one in
    source      anything with a snapshot-shaped `.snapshot()` —
                `MetricsRegistry`, `MetricsAggregator` — or a zero-arg
                callable returning a snapshot dict
    clock       duck-typed monotonic()/sleep(); FakeClock in tests
    interval_s  sampling cadence for the background loop
    alerts      optional AlertEngine (evaluated after every sample; its
                gauges are registered in this recorder's overlay
                registry so alert state lands in the segments)
    watch       optional RegressionWatch, attached to `alerts`
    recorder    optional FlightRecorder for alert events and dumps

    The recorder keeps a private overlay registry for the timeline's own
    health/alert series and merges it into every appended snapshot, so
    a segment directory alone (no live process, no scrape) reconstructs
    what was firing when — the `diagnose.py --history` contract."""

    def __init__(self, store: "TimelineStore | str", source: Any, *,
                 clock: Any = None, interval_s: float = 5.0,
                 keep: int = 8, segment_samples: int = 64,
                 alerts: "AlertEngine | None" = None,
                 watch: "RegressionWatch | None" = None,
                 recorder: Any = None):
        from .metrics import MetricsRegistry

        if isinstance(store, str):
            store = TimelineStore(store, keep=keep,
                                  segment_samples=segment_samples)
        self.store = store
        self._source = source
        self._clock = clock if clock is not None else _MonotonicClock()
        self.interval_s = float(interval_s)
        self._lock = make_lock("TimelineRecorder._lock")
        self._overlay = MetricsRegistry()
        self._c_samples = self._overlay.counter(
            "mmlspark_tpu_timeline_samples_total",
            "snapshots appended to the timeline store")
        self._g_segments = self._overlay.gauge(
            "mmlspark_tpu_timeline_segments_count",
            "intact segment files currently on disk")
        self._g_gap = self._overlay.gauge(
            "mmlspark_tpu_timeline_last_sample_age_seconds",
            "seconds between the last two samples (cadence health)")
        if alerts is None:
            alerts = AlertEngine(self.store, clock=self._clock,
                                 recorder=recorder)
        self.alerts = alerts
        alerts._init_gauges(self._overlay)
        if recorder is not None and alerts._recorder is None:
            alerts.attach_recorder(recorder)
        if watch is not None:
            alerts.attach_watch(watch)
        self._last_t: "float | None" = None
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()

    def _snapshot(self) -> dict:
        src = self._source
        snap = src() if callable(src) else src.snapshot()
        return dict(snap or {})

    def sample(self) -> float:
        """One tick: snapshot + overlay -> store.append -> alerts. The
        sample time is returned; tests advance FakeClock between calls
        and the recorded history is exact."""
        now = self._clock.monotonic()
        with self._lock:
            if self._last_t is not None:
                self._g_gap.set(max(now - self._last_t, 0.0))
            self._last_t = now
            self._c_samples.inc()
            snap = self._snapshot()
            # alert gauges reflect the PREVIOUS evaluation here; the
            # post-append evaluation below lands in the NEXT sample.
            # One-sample lag is the price of alert state that is itself
            # computed from the durable history.
            snap.update(self._overlay.snapshot())
            self.store.append(now, snap)
            self._g_segments.set(
                sum(1 for s in self.store.segments() if s["intact"]))
        if self.alerts is not None:
            self.alerts.evaluate(at=now)
        return now

    # -- background loop ------------------------------------------------ #

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.is_set():
                try:
                    self.sample()
                except Exception:  # noqa: BLE001 — sampling must not die
                    pass
                self._clock.sleep(self.interval_s)

        self._thread = threading.Thread(
            target=_loop, name="timeline-recorder", daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=timeout_s)
