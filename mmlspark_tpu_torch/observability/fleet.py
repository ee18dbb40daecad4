"""Fleet observability: cross-replica metric aggregation.

PR 4's telemetry is strictly single-process — each `ServingServer` scrapes
its own registry from `GET /metrics`. A replica fleet needs the federation
view: one exposition covering every replica, with per-replica series kept
apart by a `replica` label and fleet-wide series merged under
`replica="fleet"` (the Prometheus federation pattern, PAPERS.md).

Two layers, both dependency-free (stdlib only) so io_http/serving.py can
import this module without cycles (this module never imports io_http):

* `parse_prometheus` / `render_families` — a text-exposition 0.0.4 parser
  and renderer that round-trips the registry's own output byte-for-byte
  (`render → parse → render` identity is property-tested), built on the
  registry's exact escaping/value-formatting helpers.
* `MetricsAggregator` — scrapes every replica's `/metrics` (urls come from
  `ServingFleet.urls` or the rendezvous registry via a callable), merges
  families across replicas by per-family policy (counters/histograms sum;
  gauges sum/max/min/last via `GAUGE_MERGE_POLICIES` + suffix defaults),
  and re-renders the fleet exposition. Dead replicas (stale scrape or a
  final `push`) drop out of gauges but their counters are RETAINED, so
  fleet counter totals stay monotone across a replica death.

A copy of mmlspark_tpu/observability/fleet.py.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

from .sanitizer import make_lock
from .metrics import _escape_label, _fmt_value

__all__ = [
    "MetricSample", "MetricFamily", "FamilyList",
    "parse_prometheus", "render_families",
    "MetricsAggregator", "GAUGE_MERGE_POLICIES", "merge_policy_for",
    "FLEET_REPLICA", "REPLICA_LABEL",
]

# the label attached to every per-replica sample, and the sentinel value
# carried by fleet-merged samples
REPLICA_LABEL = "replica"
FLEET_REPLICA = "fleet"


@dataclass
class MetricSample:
    """One exposition line: `name{labels} value`. For histograms the name
    carries the `_bucket`/`_sum`/`_count` suffix and `le` rides in labels,
    exactly as the text format spells it. `exemplar` is the RAW OpenMetrics
    suffix after the line's ` # ` separator (`{trace_id="..."} 0.0042`),
    kept verbatim so exemplar lines round-trip byte-identically."""

    name: str
    labels: tuple[tuple[str, str], ...]
    value: float
    exemplar: "str | None" = None

    def labels_dict(self) -> dict[str, str]:
        return dict(self.labels)

    def exemplar_value(self) -> "float | None":
        """The exemplar's observed value (the trailing number of the raw
        suffix); None when absent or unparseable."""
        if not self.exemplar:
            return None
        try:
            return float(self.exemplar.rsplit(" ", 1)[1])
        except (IndexError, ValueError):
            return None

    def exemplar_labels(self) -> dict[str, str]:
        """The exemplar's label set parsed out of the raw suffix (empty
        when absent) — the postmortem join key (`trace_id`) lives here."""
        if not self.exemplar:
            return {}
        body = self.exemplar
        end = body.rfind("}")
        if not body.startswith("{") or end == -1:
            return {}
        try:
            fake = _parse_sample_line("x" + body[:end + 1] + " 0", 0)
        except ExpositionParseError:
            return {}
        return fake.labels_dict()


@dataclass
class MetricFamily:
    """One `# HELP`/`# TYPE` group and its samples, in exposition order."""

    name: str
    doc: str
    kind: str
    samples: list[MetricSample] = field(default_factory=list)
    # families synthesized for a bare sample with no HELP/TYPE render
    # without meta lines, preserving byte-identity for such input
    explicit_meta: bool = True


class FamilyList(list):
    """`parse_prometheus`'s result: a plain list of MetricFamily plus the
    one piece of whole-document state the text format carries — whether
    the input ended with the OpenMetrics `# EOF` terminator. Carrying it
    here lets `render_families` reproduce exemplar-bearing expositions
    byte-identically."""

    eof: bool = False


class ExpositionParseError(ValueError):
    pass


def _unescape_label(v: str) -> str:
    out = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            n = v[i + 1]
            if n == "n":
                out.append("\n")
                i += 2
                continue
            if n in ("\\", '"'):
                out.append(n)
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _split_exemplar(rest: str) -> "tuple[str, str | None]":
    """Split a sample line's post-labels tail into (value text, raw
    exemplar suffix). The OpenMetrics exemplar rides after ` # ` and is
    preserved verbatim; label values never reach here, so the separator
    scan is quote-safe."""
    head, sep, ex = rest.partition(" # ")
    if not sep:
        return rest, None
    return head, ex


def _parse_sample_line(line: str, lineno: int) -> MetricSample:
    brace = line.find("{")
    if brace == -1:
        rest, exemplar = _split_exemplar(line)
        try:
            name, value = rest.split(None, 1)
        except ValueError:
            raise ExpositionParseError(f"line {lineno}: malformed sample "
                                       f"{line!r}") from None
        return MetricSample(name, (), float(value), exemplar=exemplar)
    name = line[:brace]
    labels: list[tuple[str, str]] = []
    i = brace + 1
    # scan `label="escaped value"` pairs; values may contain ',' '}' ' '
    while i < len(line) and line[i] != "}":
        eq = line.find("=", i)
        if eq == -1 or line[eq + 1:eq + 2] != '"':
            raise ExpositionParseError(f"line {lineno}: bad label syntax "
                                       f"in {line!r}")
        lname = line[i:eq]
        j = eq + 2
        buf = []
        while j < len(line):
            c = line[j]
            if c == "\\" and j + 1 < len(line):
                buf.append(line[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        if j >= len(line):
            raise ExpositionParseError(f"line {lineno}: unterminated label "
                                       f"value in {line!r}")
        labels.append((lname, _unescape_label("".join(buf))))
        i = j + 1
        if i < len(line) and line[i] == ",":
            i += 1
    if i >= len(line) or line[i] != "}":
        raise ExpositionParseError(f"line {lineno}: unterminated label set "
                                   f"in {line!r}")
    rest = line[i + 1:].strip()
    if not rest:
        raise ExpositionParseError(f"line {lineno}: sample {line!r} has no "
                                   "value")
    rest, exemplar = _split_exemplar(rest)
    return MetricSample(name, tuple(labels), float(rest.split()[0]),
                        exemplar=exemplar)


def _base_name(sample_name: str, family: "MetricFamily | None") -> str:
    """Map `X_bucket`/`X_sum`/`X_count` onto a histogram family `X`."""
    if family is not None and family.kind == "histogram":
        for suf in ("_bucket", "_sum", "_count"):
            if sample_name == family.name + suf:
                return family.name
    return sample_name


def parse_prometheus(text: str) -> "FamilyList":
    """Parse text exposition 0.0.4 into families, preserving family order,
    sample order, label order, HELP docs, exemplar suffixes, and the
    `# EOF` terminator (on the returned list's `.eof`) — everything
    `render_families` needs to reproduce the input byte-for-byte."""
    families: FamilyList = FamilyList()
    by_name: dict[str, MetricFamily] = {}
    current: MetricFamily | None = None

    def _meta(name: str) -> MetricFamily:
        nonlocal current
        fam = by_name.get(name)
        if fam is None:
            fam = MetricFamily(name, "", "untyped")
            by_name[name] = fam
            families.append(fam)
        current = fam
        return fam

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            fam = _meta(parts[0])
            fam.doc = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2:
                raise ExpositionParseError(f"line {lineno}: bad TYPE line "
                                           f"{line!r}")
            _meta(parts[0]).kind = parts[1]
            continue
        if line == "# EOF":
            families.eof = True  # OpenMetrics terminator — round-trips
            continue
        if line.startswith("#"):
            continue  # comments are legal and carry no state
        sample = _parse_sample_line(line, lineno)
        base = _base_name(sample.name, current)
        if current is None or base != current.name:
            # a bare series with no HELP/TYPE (legal exposition)
            fam = by_name.get(base)
            if fam is None:
                fam = MetricFamily(base, "", "untyped", explicit_meta=False)
                by_name[base] = fam
                families.append(fam)
            current = fam
        current.samples.append(sample)
    return families


def render_families(families: Iterable[MetricFamily],
                    eof: "bool | None" = None) -> str:
    """Render families back to text exposition, mirroring
    `MetricsRegistry.render_prometheus` exactly (same escaping, same value
    formatting, raw exemplar suffixes re-attached verbatim) so registry
    output survives a parse round trip byte-for-byte. `eof=None` reads the
    input's `.eof` (a `parse_prometheus` FamilyList) so the OpenMetrics
    terminator round-trips too."""
    if eof is None:
        eof = bool(getattr(families, "eof", False))
    lines: list[str] = []
    for fam in families:
        if fam.explicit_meta:
            lines.append(f"# HELP {fam.name} {fam.doc or fam.name}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
        for s in fam.samples:
            if s.labels:
                lbl = "{" + ",".join(
                    f'{n}="{_escape_label(v)}"' for n, v in s.labels) + "}"
            else:
                lbl = ""
            line = f"{s.name}{lbl} {_fmt_value(s.value)}"
            if s.exemplar is not None:
                line += f" # {s.exemplar}"
            lines.append(line)
    if eof:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------- #
# merge policies                                                        #
# --------------------------------------------------------------------- #

# Counters and histograms always sum across replicas. Gauges need intent:
# additive capacities sum, high-water signals max, and anything without an
# explicit entry falls back to the unit-suffix defaults below. metric_lint
# enforces that every emitted family resolves to SOME policy, so a new
# gauge cannot silently aggregate wrong.
GAUGE_MERGE_POLICIES: dict[str, str] = {
    "mmlspark_tpu_serving_queue_depth": "sum",
    "mmlspark_tpu_dataplane_prefetch_depth": "sum",
    "mmlspark_tpu_dataplane_overlap_ratio": "max",
    "mmlspark_tpu_streaming_lookahead_hit_ratio": "max",
    "mmlspark_tpu_pipeline_fusion_ratio": "max",
    # worst chip imbalance across the fleet is the actionable signal
    "mmlspark_tpu_shard_skew_ratio": "max",
    "mmlspark_tpu_resilience_breaker_state_count": "max",
    "mmlspark_tpu_slo_burn_rate": "max",
    "mmlspark_tpu_slo_budget_remaining_ratio": "min",
    "mmlspark_tpu_fleet_replica_up_count": "sum",
    "mmlspark_tpu_fleet_replicas_up_count": "last",
    "mmlspark_tpu_fleet_replicas_down_count": "last",
    "mmlspark_tpu_fleet_scrape_age_seconds": "max",
    # gateway/autoscaler run ON THE DRIVER: their gauges describe the one
    # routing/control plane, never a per-replica share — "last" wins over
    # the _count suffix default (sum) which would multiply them by the
    # number of scrape sources
    "mmlspark_tpu_gateway_replicas_live_count": "last",
    # fraction of known replicas in rotation: the WORST view across
    # scrape sources is the actionable health signal
    "mmlspark_tpu_gateway_live_replicas_ratio": "min",
    # total in-flight across gateways genuinely sums, but rule 5 wants
    # the intent written down, not inherited from the _depth default
    "mmlspark_tpu_gateway_inflight_depth": "sum",
    "mmlspark_tpu_autoscaler_target_replicas_count": "last",
    "mmlspark_tpu_autoscaler_calm_ticks_count": "last",
    # elastic training world size lives on the ONE driver (the fleet
    # members it counts don't export it) — "last" over the _count
    # default (sum), which would multiply it by scrape sources
    "mmlspark_tpu_training_world_size_count": "last",
    # hot-path serving: batches in flight between dispatch and reply
    # fetch genuinely add across replicas (rule 5: write the intent
    # down, don't inherit it from the _depth suffix default)
    "mmlspark_tpu_serving_readback_inflight_depth": "sum",
    # partition-parallel streaming (streaming/partition.py): the series
    # are per (query, partition), so fleet-level merges must respect the
    # partitioned meaning, not the _seconds suffix default ("last")
    "mmlspark_tpu_streaming_partition_queue_depth": "sum",
    # the slowest partition gates the batch barrier — worst lag is the
    # actionable signal
    "mmlspark_tpu_streaming_partition_lag_seconds": "max",
    # the query's effective watermark is the MINIMUM over partitions:
    # no operator may finalize past the slowest partition's clock
    "mmlspark_tpu_streaming_partition_watermark_seconds": "min",
    # spill files are disjoint per partition, so bytes genuinely add
    "mmlspark_tpu_streaming_state_spill_bytes": "sum",
    # bucket-pad waste: the WORST rung across the fleet is what the
    # attribution table should surface (a replica padding 2x is the
    # problem even when the fleet average looks fine)
    "mmlspark_tpu_dataplane_pad_waste_ratio": "max",
    # elastic training (resilience/elastic.py): the replica that has gone
    # LONGEST without a checkpoint is the one a preemption would set back
    # the furthest — worst age is the pageable signal, not the fleet
    # average or the "_seconds" last-wins default
    "mmlspark_tpu_checkpoint_last_age_seconds": "max",
    # AutoML sweeps (automl/sweep.py) run ON THE DRIVER: the scheduler
    # is a singleton control plane, so its gauges are authoritative
    # values, never per-replica shares — "last" wins over every additive
    # suffix default. The score gauge is in metric units (AUC, mse, ...)
    # and feeds HyperbandPruner, not a fleet aggregate.
    "mmlspark_tpu_sweep_trial_score_rate": "last",
    "mmlspark_tpu_sweep_rung_survivors_count": "last",
    "mmlspark_tpu_sweep_workers_live_count": "last",
    "mmlspark_tpu_sweep_inflight_trials_depth": "last",
    # telemetry timeline (observability/timeline.py): alert state is
    # 0 ok / 1 pending / 2 firing — ANY source firing means the fleet
    # is firing, so "max", never the _count suffix default (sum, which
    # would read two pending replicas as one firing)
    "mmlspark_tpu_timeline_alert_state_count": "max",
    # the stalest recorder is the one whose history has a hole — worst
    # inter-sample gap is the pageable cadence-health signal
    "mmlspark_tpu_timeline_last_sample_age_seconds": "max",
    # segment inventory lives on the ONE driver-side recorder; "last"
    # over the _count default (sum) for the same reason as the gateway
    # singletons above
    "mmlspark_tpu_timeline_segments_count": "last",
    # newest alert-triggered dump wins: --history anchors the incident
    # table on the latest black-box evidence
    "mmlspark_tpu_timeline_dump_timestamp_seconds": "max",
    # autoscaler trend signals are computed on the ONE driver from the
    # timeline; worst (steepest) observed trend is the actionable view
    # if several scrape sources ever report them
    "mmlspark_tpu_autoscaler_queue_slope_rate": "max",
    "mmlspark_tpu_autoscaler_p99_slope_rate": "max",
    # serving protocol mix (serving_protocol_requests_total{proto}) and
    # gateway tier traffic (gateway_worker_requests_total{worker}) are
    # COUNTERS: merge_policy_for resolves them to "sum" by kind before
    # this table is consulted. Written down here so rule M5's audit trail
    # covers them — they carry per-process label sets (worker=w0..wN-1,
    # proto=json|binary) that genuinely add across replicas/workers.
}

_SUFFIX_POLICIES: tuple[tuple[str, str], ...] = (
    ("_total", "sum"),      # counter convention
    ("_bytes", "sum"),
    ("_depth", "sum"),
    ("_count", "sum"),
    ("_ratio", "max"),      # worst/best-case signal, never additive
    ("_rate", "max"),
    ("_seconds", "last"),   # point-in-time timestamps/ages
)


def merge_policy_for(name: str, kind: str = "gauge") -> "str | None":
    """How samples of family `name` combine across replicas; None means
    unknown (metric_lint fails the build on it)."""
    if kind in ("counter", "histogram"):
        return "sum"
    pol = GAUGE_MERGE_POLICIES.get(name)
    if pol is not None:
        return pol
    for suf, pol in _SUFFIX_POLICIES:
        if name.endswith(suf):
            return pol
    return None


# --------------------------------------------------------------------- #
# aggregator                                                            #
# --------------------------------------------------------------------- #


class _MonotonicClock:
    def monotonic(self) -> float:
        return time.monotonic()


def _default_fetch(url: str, timeout_s: float) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return r.read().decode("utf-8")


@dataclass
class _ReplicaState:
    families: list[MetricFamily] = field(default_factory=list)
    last_success_t: float = float("-inf")
    final: bool = False        # pushed its last exposition (graceful stop)
    ever_scraped: bool = False


class MetricsAggregator:
    """Scrape-and-merge over a replica set.

    urls           dict {replica_id: metrics_url}, list of urls (ids are
                   the list indexes), or a zero-arg callable returning the
                   dict — the rendezvous passes a callable so membership
                   tracks live registrations.
    clock          duck-typed `monotonic()` (FakeClock fits) driving
                   staleness decisions — tests advance it, no real sleeps.
    stale_after_s  a replica whose last successful scrape is older than
                   this is DOWN: its gauges drop from the aggregate, its
                   counters/histograms are retained (monotone totals).
    fetch          injectable `(url, timeout_s) -> text` for tests.
    """

    def __init__(self, urls: Any = None, clock: Any = None,
                 stale_after_s: float = 10.0, timeout_s: float = 2.0,
                 fetch: "Callable[[str, float], str] | None" = None):
        self._urls = urls if urls is not None else {}
        self._clock = clock if clock is not None else _MonotonicClock()
        self.stale_after_s = float(stale_after_s)
        self.timeout_s = float(timeout_s)
        self._fetch = fetch if fetch is not None else _default_fetch
        self._lock = make_lock("MetricsAggregator._lock")
        self._replicas: dict[str, _ReplicaState] = {}

    # -- membership ----------------------------------------------------- #

    def resolve_urls(self) -> dict[str, str]:
        urls = self._urls() if callable(self._urls) else self._urls
        if isinstance(urls, dict):
            return {str(k): v for k, v in urls.items()}
        return {str(i): u for i, u in enumerate(urls)}

    def _state(self, rid: str) -> _ReplicaState:
        st = self._replicas.get(rid)
        if st is None:
            st = self._replicas[rid] = _ReplicaState()
        return st

    # -- ingest --------------------------------------------------------- #

    def scrape(self) -> dict[str, bool]:
        """Pull every replica's exposition; returns {replica_id: ok}.
        A failed scrape keeps the replica's previous families (they age
        into staleness on the injected clock rather than vanishing)."""
        results: dict[str, bool] = {}
        for rid, url in sorted(self.resolve_urls().items()):
            try:
                families = parse_prometheus(self._fetch(url, self.timeout_s))
            except Exception:  # noqa: BLE001 — a dead replica can fail anyhow
                with self._lock:
                    self._state(rid)
                results[rid] = False
                continue
            with self._lock:
                st = self._state(rid)
                st.families = families
                st.last_success_t = self._clock.monotonic()
                st.final = False
                st.ever_scraped = True
            results[rid] = True
        return results

    def push(self, replica_id: str, text: str, final: bool = True) -> None:
        """Ingest a pushed exposition — the graceful-shutdown flush: a
        draining replica POSTs its final counters so they survive its
        death in the fleet totals."""
        families = parse_prometheus(text)
        with self._lock:
            st = self._state(str(replica_id))
            st.families = families
            st.last_success_t = self._clock.monotonic()
            st.final = bool(final)
            st.ever_scraped = True

    def forget(self, replica_id: str) -> None:
        with self._lock:
            self._replicas.pop(str(replica_id), None)

    # -- status --------------------------------------------------------- #

    def replica_status(self) -> dict[str, dict]:
        now = self._clock.monotonic()
        with self._lock:
            out = {}
            for rid, st in sorted(self._replicas.items()):
                age = now - st.last_success_t
                out[rid] = {
                    "up": (st.ever_scraped and not st.final
                           and age <= self.stale_after_s),
                    "final": st.final,
                    "age_s": age if st.ever_scraped else float("inf"),
                    "has_data": st.ever_scraped,
                }
            return out

    # -- merge ---------------------------------------------------------- #

    def families(self) -> list[MetricFamily]:
        """The fleet exposition: every replica's samples tagged with a
        `replica` label, plus per-family merged samples under
        `replica="fleet"`, plus the aggregator's own health gauges."""
        status = self.replica_status()
        with self._lock:
            replicas = [(rid, st.families, st.last_success_t)
                        for rid, st in sorted(self._replicas.items())]
        merged: dict[str, MetricFamily] = {}
        # group key -> (policy-ready accumulation)
        groups: dict[str, dict[tuple, list[tuple[float, MetricSample]]]] = {}
        for rid, fams, t in replicas:
            up = status[rid]["up"]
            for fam in fams:
                if fam.kind == "gauge" and not up:
                    continue  # a down replica's gauges are meaningless
                out = merged.get(fam.name)
                if out is None:
                    out = merged[fam.name] = MetricFamily(
                        fam.name, fam.doc, fam.kind)
                elif out.kind == "untyped" and fam.kind != "untyped":
                    out.kind, out.doc = fam.kind, fam.doc
                g = groups.setdefault(fam.name, {})
                for s in fam.samples:
                    out.samples.append(MetricSample(
                        s.name,
                        s.labels + ((REPLICA_LABEL, rid),), s.value,
                        exemplar=s.exemplar))
                    g.setdefault((s.name, s.labels), []).append((t, s))
        for name, fam in merged.items():
            pol = merge_policy_for(name, fam.kind) or "sum"
            for (sname, labels), vals in groups[name].items():
                if pol == "sum":
                    v = sum(s.value for _, s in vals)
                elif pol == "max":
                    v = max(s.value for _, s in vals)
                elif pol == "min":
                    v = min(s.value for _, s in vals)
                else:  # "last": the most recently scraped replica wins
                    v = max(vals, key=lambda p: p[0])[1].value
                # the fleet-merged line keeps the WORST (highest-valued)
                # exemplar across replicas — a fleet p99 bucket links to
                # the exact slowest trace that filled it
                with_ex = [s for _, s in vals
                           if s.exemplar_value() is not None]
                ex = (max(with_ex, key=lambda s: s.exemplar_value()).exemplar
                      if with_ex else None)
                fam.samples.append(MetricSample(
                    sname, labels + ((REPLICA_LABEL, FLEET_REPLICA),), v,
                    exemplar=ex))
        out = FamilyList(merged[k] for k in sorted(merged))
        out.extend(self._meta_families(status))
        out.eof = any(s.exemplar is not None
                      for fam in out for s in fam.samples)
        return out

    def _meta_families(self, status: dict[str, dict]) -> list[MetricFamily]:
        up = [r for r, st in status.items() if st["up"]]
        down = [r for r, st in status.items() if not st["up"]]
        per = MetricFamily(
            "mmlspark_tpu_fleet_replica_up_count",
            "1 when the replica's scrape is fresh, 0 when down", "gauge")
        age = MetricFamily(
            "mmlspark_tpu_fleet_scrape_age_seconds",
            "age of the replica's last successful scrape", "gauge")
        for rid, st in sorted(status.items()):
            per.samples.append(MetricSample(
                "mmlspark_tpu_fleet_replica_up_count",
                ((REPLICA_LABEL, rid),), 1.0 if st["up"] else 0.0))
            if st["has_data"]:
                age.samples.append(MetricSample(
                    "mmlspark_tpu_fleet_scrape_age_seconds",
                    ((REPLICA_LABEL, rid),), max(st["age_s"], 0.0)))
        totals = [
            MetricFamily("mmlspark_tpu_fleet_replicas_up_count",
                         "replicas with a fresh scrape", "gauge",
                         [MetricSample("mmlspark_tpu_fleet_replicas_up_count",
                                       (), float(len(up)))]),
            MetricFamily("mmlspark_tpu_fleet_replicas_down_count",
                         "replicas stale, final, or never scraped", "gauge",
                         [MetricSample(
                             "mmlspark_tpu_fleet_replicas_down_count",
                             (), float(len(down)))]),
        ]
        return [per, age] + totals

    def render(self) -> str:
        return render_families(self.families())

    # -- reads (the single source of truth for fleet totals) ------------ #

    def _iter_samples(self, name: str):
        with self._lock:
            replicas = list(self._replicas.items())
        for rid, st in replicas:
            for fam in st.families:
                if fam.name == name or (fam.kind == "histogram"
                                        and name.startswith(fam.name + "_")):
                    for s in fam.samples:
                        if s.name == name:
                            yield rid, fam.kind, s

    def total(self, name: str, labels: "dict[str, str] | None" = None,
              replica: "str | None" = None) -> float:
        """Sum of a counter/gauge family's plain samples across replicas
        (histogram families: pass the explicit `X_sum`/`X_count` name).
        `labels` filters by subset match; `replica` restricts to one."""
        tot = 0.0
        for rid, _kind, s in self._iter_samples(name):
            if replica is not None and rid != str(replica):
                continue
            if s.name != name:
                continue
            if labels:
                d = s.labels_dict()
                if any(d.get(k) != str(v) for k, v in labels.items()):
                    continue
            tot += s.value
        return tot

    @staticmethod
    def _snapshot_family(fam: MetricFamily,
                         samples: "list[MetricSample]") -> dict:
        """Shape one family's samples like `MetricsRegistry.snapshot()`
        does (histograms regrouped from their _bucket/_sum/_count lines)."""
        if fam.kind == "histogram":
            hists: dict[tuple, dict] = {}
            for s in samples:
                d = s.labels_dict()
                d.pop(REPLICA_LABEL, None)
                le = d.pop("le", None)
                key = tuple(sorted(d.items()))
                h = hists.setdefault(key, {
                    "labels": dict(key), "count": 0, "sum": 0.0,
                    "buckets": {}})
                if s.name == fam.name + "_bucket" and le is not None:
                    bound = "+Inf" if le == "+Inf" else float(le)
                    h["buckets"][bound] = s.value
                elif s.name == fam.name + "_sum":
                    h["sum"] = s.value
                elif s.name == fam.name + "_count":
                    h["count"] = s.value
            shaped = list(hists.values())
        else:
            shaped = []
            for s in samples:
                d = s.labels_dict()
                d.pop(REPLICA_LABEL, None)
                shaped.append({"labels": d, "value": s.value})
        return {"kind": fam.kind, "samples": shaped}

    def snapshot(self) -> dict:
        """Fleet-merged series in `MetricsRegistry.snapshot()` shape —
        what the SLO engine reads, so SLO math and the `/metrics`
        aggregate share one merge."""
        out: dict[str, Any] = {}
        for fam in self.families():
            fleet = [s for s in fam.samples
                     if s.labels_dict().get(REPLICA_LABEL) == FLEET_REPLICA]
            if not fleet and not fam.samples:
                out.setdefault(fam.name, {"kind": fam.kind, "samples": []})
                continue
            if not fleet:  # meta families carry no fleet-merged samples
                fleet = fam.samples
            out[fam.name] = self._snapshot_family(fam, fleet)
        return out

    def replica_snapshot(self, replica_id: str) -> dict:
        """One replica's raw series in `MetricsRegistry.snapshot()` shape
        (no fleet merge) — per-replica SLO/latency reads, e.g. the
        rendezvous `info()` percentiles."""
        with self._lock:
            st = self._replicas.get(str(replica_id))
            fams = list(st.families) if st is not None else []
        return {fam.name: self._snapshot_family(fam, fam.samples)
                for fam in fams}
