"""Distributed preemptible AutoML sweeps with hyperband early stopping.

`SweepScheduler` runs `TuneHyperparameters`-style trials across a fleet
of preemptible WORKER PROCESSES (io_http.serving.ServingFleet — the same
plumbing that serves models), speaking a JSON claim/heartbeat/status
protocol routed by directed `TargetPool` sends. Any worker may be
SIGKILLed mid-trial: the sweep ledger (resilience.elastic
TrainingCheckpointer) plus per-(trial, rung, fold) sub-checkpoints
resume the lost trial on another worker byte-identically, so a chaos-
ridden sweep converges to the same winner as an undisturbed one.

Early stopping is rung-synchronized successive halving (Li et al.,
"Hyperband: a novel bandit-based approach to hyperparameter
optimization", JMLR 2018): every surviving trial trains to the rung's
resource budget, the `HyperbandPruner` reads the per-(trial, rung)
score gauges from the metrics registry and keeps the top 1/eta at each
rung boundary. Because pruning happens only at barriers where EVERY
surviving trial has reported, the set of fits computed is independent
of worker count — `SweepResult.digest` is byte-identical at any
parallelism.

GBDT trials share one binned device-resident dataset per worker
(gbdt.shared_bins): bins build once per sweep, boosters vary, proven by
the build/hit counters the worker `status` op reports.

The winner flows out through `FindBestModel` and can be
`rolling_swap`ped into a live serving fleet behind the gateway
(`SweepResult.hot_swap`) with zero client-visible downtime.

Counterpart of mmlspark_tpu/automl/sweep.py. A worker is a port
`ServingFleet` replica: a spawned process with its own CUDA context, so
the workers of one machine share its card, each trial fitting on its
estimator's `device`. The shared binned dataset lives on that device
(the seeding estimator's `device`), and a fold's fit gathers its rows
there.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import pickle
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from ..core.schema import Table
from ..observability.sanitizer import make_lock
from .metrics import ComputeModelStatistics
from .tune import _MAXIMIZE, _give_trial_checkpoints, _kfold_indices

__all__ = ["HyperbandPruner", "SweepScheduler", "SweepResult",
           "SweepWorkerFactory", "SweepModelFactory"]

SCORE_GAUGE = "mmlspark_tpu_sweep_trial_score_rate"
_SCORE_DOC = ("per-(trial, rung) evaluation-metric value — the series "
              "HyperbandPruner consumes at rung boundaries")
_SPEC_FILE = "spec.json"
_TABLE_FILE = "table.pkl"
_LEDGER_DIR = "_sweep_ledger"


def _sweep_record(kind: str, **data: Any) -> None:
    try:
        from ..observability.recorder import get_recorder

        get_recorder().record(kind, **data)
    except Exception:  # noqa: BLE001 — telemetry never blocks the sweep
        pass


def _registry(reg=None):
    if reg is not None:
        return reg
    from ..observability.metrics import get_registry

    return get_registry()


def _score_gauge(reg):
    return reg.gauge(SCORE_GAUGE, _SCORE_DOC, labels=("trial", "rung"))


def _trials_counter(reg):
    return reg.counter(
        "mmlspark_tpu_sweep_trials_total",
        "sweep trial outcomes by state (done/pruned/failed/resumed)",
        labels=("state",))


# --------------------------------------------------------------------- #
# hyperband pruner                                                      #
# --------------------------------------------------------------------- #


class HyperbandPruner:
    """Rung-synchronized successive halving over registry metrics.

    Budgets grow geometrically from `min_resource` by `eta` up to
    `max_resource` (the final rung always trains at `max_resource`);
    at each rung boundary `decide` reads every surviving trial's
    `mmlspark_tpu_sweep_trial_score_rate{trial, rung}` gauge and keeps
    the best ``ceil(len(survivors) / eta)``. NaN scores (crashed or
    metricless trials) are always pruned first; ties break by trial
    index, so decisions are deterministic — the injectable clock the
    scheduler runs on never reaches the pruning math."""

    def __init__(self, min_resource: int = 10, max_resource: int = 100,
                 eta: int = 3, resource_param: str = "num_iterations"):
        if min_resource < 1 or max_resource < min_resource:
            raise ValueError(
                f"need 1 <= min_resource <= max_resource, got "
                f"{min_resource}..{max_resource}")
        if eta < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        self.min_resource = int(min_resource)
        self.max_resource = int(max_resource)
        self.eta = int(eta)
        self.resource_param = resource_param

    def rung_budgets(self) -> list[int]:
        budgets, b = [], self.min_resource
        while b < self.max_resource:
            budgets.append(b)
            b *= self.eta
        budgets.append(self.max_resource)
        return budgets

    def decide(self, rung: int, trial_ids: Sequence[int], *,
               maximize: bool, registry=None) -> list[int]:
        """Survivors of `rung`, read back from the score gauges."""
        reg = _registry(registry)
        scores: dict[int, float] = {}
        for labelvalues, child in _score_gauge(reg).children():
            labels = dict(zip(("trial", "rung"), labelvalues))
            if labels.get("rung") == str(rung):
                try:
                    scores[int(labels["trial"])] = float(child.value)
                except (TypeError, ValueError):
                    continue
        missing = [ti for ti in trial_ids if ti not in scores]
        if missing:
            raise RuntimeError(
                f"rung {rung} is not a barrier yet: no score gauge for "
                f"trials {missing} — decide() may only run after every "
                "surviving trial reported")
        ranked = [ti for ti in trial_ids
                  if not math.isnan(scores[ti])]
        if not ranked:
            raise RuntimeError(
                f"every trial at rung {rung} scored NaN; nothing to keep")
        ranked.sort(key=lambda ti: ((-scores[ti] if maximize
                                     else scores[ti]), ti))
        keep = max(1, math.ceil(len(trial_ids) / self.eta))
        return sorted(ranked[:keep])


# --------------------------------------------------------------------- #
# worker process                                                        #
# --------------------------------------------------------------------- #


def _load_spec(checkpoint_dir: str) -> tuple[dict, Table]:
    with open(os.path.join(checkpoint_dir, _SPEC_FILE),
              encoding="utf-8") as fh:
        spec = json.load(fh)
    with open(os.path.join(checkpoint_dir, spec["table_file"]), "rb") as fh:
        payload = fh.read()
    if hashlib.blake2b(payload, digest_size=16).hexdigest() != \
            spec["table_digest"]:
        raise ValueError("sweep table payload does not match spec digest")
    return spec, Table(pickle.loads(payload))


def _seed_shared_bins(est, table: Table) -> None:
    """Seed the process-ambient shared-bin context from this trial
    estimator's binning config — idempotent, so every trial of the same
    config shares ONE build (gbdt.shared_bins counts the proof)."""
    needed = ("features_col", "max_bin", "categorical_slot_indexes",
              "bin_construct_sample_cnt")
    if any(p not in est._params for p in needed):
        return
    col = est.get("features_col")
    if col not in table:
        return
    from ..gbdt.shared_bins import (SharedBinContext, get_shared_bin_context,
                                    set_shared_bin_context)

    ctx = get_shared_bin_context()
    if ctx is None:
        ctx = SharedBinContext()
        set_shared_bin_context(ctx)
    ctx.seed(np.asarray(table[col], np.float64),
             max_bin=int(est.get("max_bin")),
             categorical_indexes=tuple(est.get("categorical_slot_indexes")
                                       or ()),
             bin_construct_sample_cnt=int(
                 est.get("bin_construct_sample_cnt")),
             device=(est.get("device") if "device" in est._params
                     else "cuda"))


def _arm_chaos(chaos: dict, checkpoint_dir: str) -> None:
    """Install the chaos-test kill hook in THIS worker process: the Nth
    `TrainingCheckpointer.save` across the sweep either SIGKILLs the
    process on entry (`mode="before_save"` — mid-trial, result not yet
    durable) or mid-fsync (`mode="during_save"` — a torn snapshot the
    loader must fall back past). A checkpoint-dir sentinel claimed with
    O_EXCL fires the kill exactly once per sweep, no matter how many
    workers armed or respawned."""
    import signal

    from ..resilience import elastic

    sentinel = os.path.join(checkpoint_dir, "_chaos_fired")
    nth, mode = int(chaos.get("nth", 1)), chaos.get("mode", "before_save")
    seen = {"n": 0}
    real_save = elastic.TrainingCheckpointer.save

    def _claim() -> bool:
        try:
            os.close(os.open(sentinel, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return True
        except FileExistsError:
            return False

    def _die() -> None:
        os.kill(os.getpid(), signal.SIGKILL)

    def save(self, payload, tag="ckpt", meta=None):
        # the sweep ledger lives on the driver; only sub-checkpoint
        # saves (inside worker trial fits) count toward the trigger
        seen["n"] += 1
        if seen["n"] == nth and _claim():
            if mode == "before_save":
                _die()
            os.fsync = lambda fd: _die()
        return real_save(self, payload, tag=tag, meta=meta)

    elastic.TrainingCheckpointer.save = save


class SweepWorkerFactory:
    """Picklable `ServingFleet` handler factory speaking the sweep
    worker protocol. The sweep spec (estimator registry blobs + trial
    list + training table) loads lazily from `checkpoint_dir`, so a
    respawned worker rebuilds everything a dead one held.

    JSON ops over POST /:

      {"op": "claim", "trial", "rung", "budget"}
          -> {"ok": true}          trial accepted, fitting on a
                                   background thread
          -> {"done": true, "metric"}   (trial, rung) already finished
             here — per-assignment idempotence, a re-sent claim after a
             driver hiccup never fits twice
          -> {"busy": true, "trial", "rung"}  one trial at a time
      {"op": "heartbeat"} -> {"state": idle|running|done|failed,
                              "trial", "rung", "metric", "error",
                              "folds_done"}
      {"op": "status"}    -> done-cache + shared-bin build/hit counters

    A trial that raises lands a flight-recorder dump
    (`trigger_dump("trial_crash")`) before the failure is reported.
    """

    def __init__(self, checkpoint_dir: str, chaos: "dict | None" = None):
        self.checkpoint_dir = checkpoint_dir
        self.chaos = dict(chaos) if chaos else None

    def __call__(self):
        from ..io_http.schema import HTTPResponseData

        checkpoint_dir = self.checkpoint_dir
        if self.chaos:
            _arm_chaos(self.chaos, checkpoint_dir)

        lock = make_lock("SweepWorker.state")
        loaded: dict[str, Any] = {}            # spec/table/models/stats
        state: dict[str, Any] = {"state": "idle", "trial": None,
                                 "rung": None, "metric": None,
                                 "error": None, "folds_done": 0}
        done: dict[tuple[int, int], float] = {}

        def _ensure_loaded():
            if "spec" in loaded:
                return
            import importlib

            from ..core.serialize import stage_from_blob

            spec, table = _load_spec(checkpoint_dir)
            for mod in spec.get("modules", ()):
                importlib.import_module(mod)
            # everything staged, ONE update at the end: a failed partial
            # load must not leave a half-initialized worker behind
            staged = {
                "table": table,
                "models": [stage_from_blob(b) for b in spec["models"]],
                "folds": _kfold_indices(
                    len(table), int(spec["num_folds"]), int(spec["seed"])),
                "stats": ComputeModelStatistics(
                    label_col=spec["label_col"],
                    scored_labels_col="prediction",
                    evaluation_metric=spec["metric"]),
                "spec": spec,
            }
            loaded.update(staged)

        def _run_folds(ti: int, rung: int, budget: int) -> float:
            spec, table = loaded["spec"], loaded["table"]
            mi, pm = spec["trials"][ti]
            metric = spec["metric"]
            scores = []
            for fi, (train_idx, valid_idx) in enumerate(loaded["folds"]):
                est = loaded["models"][mi].copy(dict(pm))
                if spec["resource_param"] in est._params:
                    est.set(**{spec["resource_param"]: int(budget)})
                _seed_shared_bins(est, table)
                _give_trial_checkpoints(est, os.path.join(
                    checkpoint_dir, f"trial-{ti:04d}", f"rung-{rung}",
                    f"fold-{fi}"))
                fitted = est.fit(table.gather(np.asarray(train_idx)))
                scored = fitted.transform(table.gather(np.asarray(valid_idx)))
                row = loaded["stats"].transform(scored)
                if metric not in row:
                    raise KeyError(
                        f"metric {metric!r} not produced; have {row.columns}")
                scores.append(float(np.asarray(row[metric])[0]))
                with lock:
                    state["folds_done"] = fi + 1
            return float(np.mean(scores))

        def _trial_thread(ti: int, rung: int, budget: int) -> None:
            try:
                _sweep_record("sweep.trial_start", trial=ti, rung=rung,
                              budget=budget)
                metric = _run_folds(ti, rung, budget)
                with lock:
                    done[(ti, rung)] = metric
                    state.update(state="done", metric=metric)
                _sweep_record("sweep.trial_done", trial=ti, rung=rung,
                              metric=metric)
            except BaseException as e:  # noqa: BLE001 — reported, dumped
                with lock:
                    state.update(state="failed",
                                 error=f"{type(e).__name__}: {e}")
                _sweep_record("sweep.trial_failed", trial=ti, rung=rung,
                              error=f"{type(e).__name__}: {e}")
                try:
                    from ..observability.recorder import get_recorder

                    get_recorder().trigger_dump("trial_crash", force=True)
                except Exception:  # noqa: BLE001 — dump is best-effort
                    pass

        def _claim(body: dict) -> dict:
            ti, rung = int(body["trial"]), int(body["rung"])
            budget = int(body["budget"])
            _ensure_loaded()
            with lock:
                if (ti, rung) in done:
                    return {"done": True, "metric": done[(ti, rung)]}
                if state["state"] == "running":
                    return {"busy": True, "trial": state["trial"],
                            "rung": state["rung"]}
                state.update(state="running", trial=ti, rung=rung,
                             metric=None, error=None, folds_done=0)
            t = threading.Thread(target=_trial_thread,
                                 args=(ti, rung, budget),
                                 name=f"sweep-trial-{ti}-r{rung}",
                                 daemon=True)
            t.start()
            return {"ok": True}

        def _heartbeat() -> dict:
            with lock:
                return dict(state)

        def _status() -> dict:
            from ..gbdt.shared_bins import bin_counters

            with lock:
                cache = {f"{ti}:{r}": m for (ti, r), m in done.items()}
                st = dict(state)
            return {"done": cache, "state": st, "counters": bin_counters()}

        def handler(table: Table) -> Table:
            replies = []
            for req in table["request"]:
                try:
                    body = req.json() or {}
                    op = body.get("op")
                    if op == "claim":
                        doc = _claim(body)
                    elif op == "heartbeat":
                        doc = _heartbeat()
                    elif op == "status":
                        doc = _status()
                    else:
                        raise ValueError(f"unknown op {op!r}")
                    code, reason = 200, "OK"
                except Exception as e:  # noqa: BLE001 — reply, don't die
                    doc = {"error": f"{type(e).__name__}: {e}"}
                    code, reason = 500, "handler error"
                replies.append(HTTPResponseData(
                    code, reason, entity=json.dumps(doc).encode()))
            return Table({"reply": replies})

        return handler


class SweepModelFactory:
    """Picklable serving factory for the sweep winner: rebuilds the
    fitted model from its registry blob (no pickle) and scores JSON
    feature rows — the payload `SweepResult.hot_swap` rolls into a live
    fleet."""

    def __init__(self, blob: str, features_col: str = "features",
                 reply_col: str = "prediction",
                 modules: "tuple[str, ...]" = ()):
        self.blob = blob
        self.features_col = features_col
        self.reply_col = reply_col
        self.modules = tuple(modules)

    def __call__(self):
        import importlib

        from ..core.serialize import stage_from_blob
        from ..io_http.schema import make_reply, parse_request

        for mod in self.modules:          # register stages before decode
            importlib.import_module(mod)
        model = stage_from_blob(self.blob)
        features_col, reply_col = self.features_col, self.reply_col

        def handler(table: Table) -> Table:
            t = parse_request(table)
            feats = np.asarray(
                [np.asarray(v, np.float64) for v in t[features_col]])
            out = model.transform(t.with_column(features_col, feats))
            return make_reply(out, reply_col)

        return handler


# --------------------------------------------------------------------- #
# the scheduler                                                         #
# --------------------------------------------------------------------- #


@dataclass
class SweepResult:
    """Everything a sweep produced, plus the determinism proof."""

    best_model: Any                     # automl.find_best.BestModel
    best_trial: int
    best_params: dict[str, Any]
    best_metric: float
    best_blob: str                      # deterministic registry blob
    results: dict[str, float]           # "trial:rung" -> metric
    pruned: dict[str, list[int]]        # rung -> trials pruned there
    survivors: list[int]
    lineage: dict[str, list[dict]]      # trial -> assignment history
    resumed_trials: int
    digest: str                         # byte-identical at any P
    worker_counters: list[dict] = field(default_factory=list)

    def hot_swap(self, fleet, features_col: str = "features",
                 reply_col: str = "prediction") -> int:
        """Zero-downtime cutover: rolling_swap the winner into a live
        `ServingFleet` (each successor spawns, warms, and publishes
        before one old replica drains). Returns replicas swapped."""
        refit = self.best_model.best_model
        from ..core.serialize import stage_to_blob

        return fleet.rolling_swap(SweepModelFactory(
            stage_to_blob(refit), features_col=features_col,
            reply_col=reply_col, modules=(type(refit).__module__,)))


class SweepScheduler:
    """Drive one preemptible hyperband sweep over a worker fleet.

    The driver owns all decisions (claims, rung barriers, pruning,
    ledger writes); workers own only fits. Worker death at ANY point is
    survivable: the claim map is rebuilt from fleet membership, lost
    trials re-queue, and sub-checkpoints make the re-run resume
    mid-fit byte-identically."""

    def __init__(self, models, *, trials: "list | None" = None,
                 param_space=None, evaluation_metric: str = "accuracy",
                 label_col: str = "label", num_folds: int = 3,
                 seed: int = 0, checkpoint_dir: str,
                 workers: int = 2, pruner: "HyperbandPruner | None" = None,
                 holdout: "Table | None" = None,
                 clock=None, registry=None,
                 poll_interval_s: float = 0.05,
                 rung_timeout_s: float = 600.0,
                 request_timeout_s: float = 30.0,
                 chaos: "dict | None" = None,
                 fleet_kw: "dict | None" = None):
        from ..core.pipeline import Estimator

        if isinstance(models, Estimator):
            models = [models]
        self.models = list(models)
        if trials is None:
            if param_space is None:
                raise ValueError("need trials or param_space")
            param_maps = list(param_space.param_maps())
            trials = [(mi, pm) for mi in range(len(self.models))
                      for pm in param_maps]
        self.trials = [(int(mi), dict(pm)) for mi, pm in trials]
        if not self.trials:
            raise ValueError("sweep has no trials")
        if not checkpoint_dir:
            raise ValueError(
                "checkpoint_dir is required: the sweep spec, table, "
                "ledger, and sub-checkpoints all live there")
        self.metric = evaluation_metric
        self.maximize = evaluation_metric in _MAXIMIZE
        self.label_col = label_col
        self.num_folds = int(num_folds)
        self.seed = int(seed)
        self.checkpoint_dir = checkpoint_dir
        self.workers = int(workers)
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        self.pruner = pruner if pruner is not None else HyperbandPruner()
        self.holdout = holdout
        if clock is None:
            from ..resilience.policy import SYSTEM_CLOCK

            clock = SYSTEM_CLOCK
        self.clock = clock
        self.registry = _registry(registry)
        self.poll_interval_s = float(poll_interval_s)
        self.rung_timeout_s = float(rung_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self.chaos = chaos
        self.fleet_kw = dict(fleet_kw or {})
        # ledger state (rebuilt on resume)
        self.results: dict[str, float] = {}
        self.pruned: dict[str, list[int]] = {}
        self.lineage: dict[str, list[dict]] = {}
        self.resumed_trials = 0
        self._ledger = None

    # -- durable state -------------------------------------------------- #

    def _write_spec(self, table: Table) -> None:
        from ..core.serialize import stage_to_blob
        from ..utils.storage import atomic_write

        os.makedirs(self.checkpoint_dir, exist_ok=True)
        payload = pickle.dumps(
            {c: np.asarray(table[c]) for c in table.columns},
            protocol=4)
        digest = hashlib.blake2b(payload, digest_size=16).hexdigest()
        spec = {
            "kind": "sweep-spec", "version": 1,
            "models": [stage_to_blob(m) for m in self.models],
            # worker processes only import what sweep.py imports; the
            # stage registry is populated at import time, so each model's
            # defining module must be imported there before blob decode
            "modules": sorted({type(m).__module__ for m in self.models}),
            "trials": self.trials,
            "metric": self.metric, "label_col": self.label_col,
            "num_folds": self.num_folds, "seed": self.seed,
            "resource_param": self.pruner.resource_param,
            "budgets": self.pruner.rung_budgets(),
            "n_workers": self.workers,
            "table_file": _TABLE_FILE, "table_digest": digest,
        }
        spec_path = os.path.join(self.checkpoint_dir, _SPEC_FILE)
        if os.path.exists(spec_path):
            with open(spec_path, encoding="utf-8") as fh:
                old = json.load(fh)
            if old.get("table_digest") != digest:
                raise ValueError(
                    f"{self.checkpoint_dir} holds a sweep over DIFFERENT "
                    "data — refusing to mix ledgers; use a fresh "
                    "checkpoint_dir")
        atomic_write(os.path.join(self.checkpoint_dir, _TABLE_FILE), payload)
        atomic_write(spec_path,
                     json.dumps(spec, sort_keys=True).encode("utf-8"))

    def _load_ledger(self) -> None:
        from ..resilience.elastic import TrainingCheckpointer

        self._ledger = TrainingCheckpointer(
            os.path.join(self.checkpoint_dir, _LEDGER_DIR), keep=2)
        loaded = self._ledger.load_latest()
        if loaded is None:
            return
        try:
            doc = json.loads(loaded[0].decode("utf-8"))
        except ValueError:
            return
        if doc.get("kind") != "sweep-ledger":
            return
        self.results = {k: float(v) for k, v in doc.get("results",
                                                        {}).items()}
        self.pruned = {k: list(v) for k, v in doc.get("pruned", {}).items()}
        self.lineage = {k: list(v) for k, v in doc.get("lineage",
                                                       {}).items()}
        self.resumed_trials = int(doc.get("resumed_trials", 0))

    def _save_ledger(self) -> None:
        if self._ledger is None:
            return
        doc = {"kind": "sweep-ledger",
               "results": self.results, "pruned": self.pruned,
               "lineage": self.lineage,
               "resumed_trials": self.resumed_trials,
               "n_trials": len(self.trials),
               "budgets": self.pruner.rung_budgets()}
        self._ledger.save(
            json.dumps(doc, sort_keys=True).encode("utf-8"),
            tag=f"ledger-{len(self.results):04d}",
            meta={"done": len(self.results)})

    def _note(self, ti: int, event: str, **detail) -> None:
        self.lineage.setdefault(str(ti), []).append(
            {"event": event, **detail})

    # -- one rung ------------------------------------------------------- #

    def _record_result(self, ti: int, rung: int, value: float) -> None:
        self.results[f"{ti}:{rung}"] = value
        _score_gauge(self.registry).labels(
            trial=str(ti), rung=str(rung)).set(value)
        _trials_counter(self.registry).labels(
            state="failed" if math.isnan(value) else "done").inc()
        self._save_ledger()

    def _publish_known(self, rung: int, trial_ids) -> list[int]:
        """Resume support: re-publish ledgered scores for this rung to
        the gauges (the pruner reads gauges, not the ledger) and return
        the trials still to run."""
        todo = []
        for ti in trial_ids:
            key = f"{ti}:{rung}"
            if key in self.results:
                _score_gauge(self.registry).labels(
                    trial=str(ti), rung=str(rung)).set(self.results[key])
            else:
                todo.append(ti)
        return todo

    def _heal(self, fleet) -> None:
        for slot in fleet.dead_slots():
            try:
                url = fleet.respawn(slot)
                _sweep_record("sweep.worker_respawned", slot=slot, url=url)
            except Exception as e:  # noqa: BLE001 — retried next tick
                _sweep_record("sweep.respawn_failed", slot=slot,
                              error=f"{type(e).__name__}: {e}")

    def _send(self, pool, url: str, body: dict):
        from ..io_http.schema import HTTPRequestData

        resp = pool.send(HTTPRequestData.from_json("/", body),
                         timeout=self.request_timeout_s, target=url)
        if resp.status_code != 200 or not resp.entity:
            return None
        try:
            return json.loads(bytes(resp.entity).decode("utf-8"))
        except ValueError:
            return None

    def _run_rung(self, rung: int, budget: int, todo: list[int],
                  fleet, pool) -> None:
        g_inflight = self.registry.gauge(
            "mmlspark_tpu_sweep_inflight_trials_depth",
            "trials currently claimed by workers")
        g_workers = self.registry.gauge(
            "mmlspark_tpu_sweep_workers_live_count",
            "live sweep worker processes")
        pending = deque(sorted(todo))
        running: dict[str, int] = {}
        deadline = self.clock.monotonic() + self.rung_timeout_s
        while pending or running:
            if self.clock.monotonic() > deadline:
                raise TimeoutError(
                    f"rung {rung} incomplete after {self.rung_timeout_s}s "
                    f"(pending={list(pending)}, running={running})")
            self._heal(fleet)
            live = set(fleet.urls)
            g_workers.set(len(live))
            # a claim held by a vanished worker re-queues; the re-run
            # resumes from the dead worker's sub-checkpoints
            for url in [u for u in list(running) if u not in live]:
                ti = running.pop(url)
                self.resumed_trials += 1
                _trials_counter(self.registry).labels(state="resumed").inc()
                self._note(ti, "lost", rung=rung, worker=url)
                _sweep_record("sweep.trial_reassigned", trial=ti,
                              rung=rung, lost_worker=url)
                pending.appendleft(ti)
            for url in sorted(live - set(running)):
                if not pending:
                    break
                ti = pending.popleft()
                doc = self._send(pool, url, {
                    "op": "claim", "trial": ti, "rung": rung,
                    "budget": budget})
                if doc is None or "error" in doc or doc.get("busy"):
                    pending.append(ti)       # dead/busy: heal next tick
                    continue
                if doc.get("done"):
                    self._record_result(ti, rung, float(doc["metric"]))
                    continue
                running[url] = ti
                self._note(ti, "assigned", rung=rung, worker=url)
            for url, ti in list(running.items()):
                doc = self._send(pool, url, {"op": "heartbeat"})
                if doc is None or doc.get("trial") != ti \
                        or doc.get("rung") != rung:
                    continue             # dead or stale: membership decides
                if doc.get("state") == "done":
                    self._record_result(ti, rung, float(doc["metric"]))
                    del running[url]
                elif doc.get("state") == "failed":
                    self._note(ti, "failed", rung=rung, worker=url,
                               error=doc.get("error"))
                    self._record_result(ti, rung, float("nan"))
                    del running[url]
            g_inflight.set(len(running))
            if pending or running:
                self.clock.sleep(self.poll_interval_s)
        g_inflight.set(0)

    # -- the sweep ------------------------------------------------------ #

    def _refit_and_pick(self, table: Table, survivors: list[int]):
        from .find_best import FindBestModel

        budget = self.pruner.rung_budgets()[-1]
        fitted, by_model = [], {}
        for ti in survivors:
            mi, pm = self.trials[ti]
            est = self.models[mi].copy(dict(pm))
            if self.pruner.resource_param in est._params:
                est.set(**{self.pruner.resource_param: int(budget)})
            _give_trial_checkpoints(est, os.path.join(
                self.checkpoint_dir, f"refit-{ti:04d}"))
            m = est.fit(table)
            fitted.append(m)
            by_model[id(m)] = ti
        best = FindBestModel(
            models=fitted, evaluation_metric=self.metric,
            label_col=self.label_col,
        ).fit(self.holdout if self.holdout is not None else table)
        return best, by_model[id(best.best_model)]

    def run(self, table: Table) -> SweepResult:
        from ..io_http.clients import TargetPool
        from ..io_http.serving import ServingFleet
        from ..observability.tracing import get_tracer

        self._write_spec(table)
        self._load_ledger()
        budgets = self.pruner.rung_budgets()
        fleet_kw = {"rendezvous": False,
                    "flight_recorder_dir": os.path.join(
                        self.checkpoint_dir, "flight"),
                    **self.fleet_kw}
        fleet = ServingFleet(
            SweepWorkerFactory(self.checkpoint_dir, chaos=self.chaos),
            n_hosts=self.workers, **fleet_kw)
        tracer = get_tracer()
        with tracer.start_span("sweep.run", trials=len(self.trials),
                               workers=self.workers, rungs=len(budgets)):
            fleet.start()
            pool = TargetPool(fleet.urls)
            fleet.watch(lambda event, url: (
                pool.add(url) if event == "added" else pool.remove(url)))
            try:
                survivors = list(range(len(self.trials)))
                for rung, budget in enumerate(budgets):
                    with tracer.start_span("sweep.rung", rung=rung,
                                           budget=budget,
                                           trials=len(survivors)) as span:
                        todo = self._publish_known(rung, survivors)
                        self._run_rung(rung, budget, todo, fleet, pool)
                        if rung < len(budgets) - 1:
                            keep = self.pruner.decide(
                                rung, survivors, maximize=self.maximize,
                                registry=self.registry)
                            cut = sorted(set(survivors) - set(keep))
                            if cut:
                                self.pruned[str(rung)] = cut
                                for ti in cut:
                                    self._note(ti, "pruned", rung=rung)
                                _trials_counter(self.registry).labels(
                                    state="pruned").inc(len(cut))
                                _sweep_record("sweep.rung_pruned",
                                              rung=rung, pruned=cut)
                            survivors = keep
                        self.registry.gauge(
                            "mmlspark_tpu_sweep_rung_survivors_count",
                            "trials surviving each rung boundary",
                            labels=("rung",)).labels(
                                rung=str(rung)).set(len(survivors))
                        span.set(survivors=len(survivors))
                        self._save_ledger()
                # drop final-rung NaN (crashed-beyond-retry) trials
                final = len(budgets) - 1
                winners = [ti for ti in survivors
                           if not math.isnan(
                               self.results.get(f"{ti}:{final}",
                                                float("nan")))]
                if not winners:
                    raise RuntimeError(
                        "no trial survived the final rung with a real "
                        "metric value")
                worker_counters = []
                for url in list(fleet.urls):
                    doc = self._send(pool, url, {"op": "status"})
                    if doc is not None and "counters" in doc:
                        worker_counters.append(
                            {"worker": url, **doc["counters"]})
            finally:
                fleet.stop()
        best, best_trial = self._refit_and_pick(table, winners)
        from ..core.serialize import stage_to_blob

        best_blob = stage_to_blob(best.best_model)
        digest_doc = {
            "results": {k: repr(v) for k, v in sorted(self.results.items())},
            "pruned": self.pruned,
            "survivors": winners,
            "best_trial": best_trial,
            "best_blob": hashlib.blake2b(
                best_blob.encode("utf-8"), digest_size=16).hexdigest(),
        }
        digest = hashlib.blake2b(
            json.dumps(digest_doc, sort_keys=True).encode("utf-8"),
            digest_size=16).hexdigest()
        mi, pm = self.trials[best_trial]
        final_key = f"{best_trial}:{len(budgets) - 1}"
        result = SweepResult(
            best_model=best, best_trial=best_trial,
            best_params=dict(pm),
            best_metric=float(self.results.get(final_key, float("nan"))),
            best_blob=best_blob,
            results=dict(self.results), pruned=dict(self.pruned),
            survivors=winners, lineage=dict(self.lineage),
            resumed_trials=self.resumed_trials, digest=digest,
            worker_counters=worker_counters)
        _sweep_record("sweep.done", best_trial=best_trial, digest=digest,
                      resumed=self.resumed_trials)
        return result
