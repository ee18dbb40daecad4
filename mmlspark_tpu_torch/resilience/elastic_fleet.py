"""Elastic data-parallel training: grow and shrink the world mid-fit,
byte-reproducibly.

Counterpart of mmlspark_tpu/resilience/elastic_fleet.py, with the same
wire protocol, spec and table files, world-epoch fence, re-shard barrier,
checkpoints, status file and metric names. DNN gradient shards and GBDT
histogram shards are computed by `ServingFleet` WORKER PROCESSES, merged by
the driver, and the fleet membership may change at ANY step.

The reproducibility contract (shard math in `parallel.dp`, a copy of the
JAX package's):

  * rows map to V fixed **virtual shards** by blake2b(row id); workers
    own shards round-robin by rank over the SORTED member list
  * each step, workers return one partial PER OWNED VIRTUAL SHARD
    (never pre-merged — float addition is non-associative); the driver
    folds partials in fixed shard order 0..V-1
  * the global batch order is a driver-owned rng stream P never enters

So the float program is a function of (data, seed, V) only, and the
final model digest is identical at any world-size schedule — including
one that kills and adds workers every N steps.

What runs where in the port:

  * a GBDT worker bins its table and builds its histograms with host
    numpy (`dp.hist_partial`), as the JAX package's does; it never
    initialises CUDA. The driver decides every split on the host too and
    returns a `gbdt.booster.Booster` that scores on the fit's `device`.
  * a DNN worker runs the spec's model (`nn.models.make_model`) on the
    spec's `device` in torch. The flat vector on the wire is
    `jax.flatten_util.ravel_pytree`'s: the leaves of the flax-layout
    "params" tree (`nn.carry.params_tree`) with every dict's keys sorted,
    each leaf row-major, f32. The per-(step, shard) dropout key is
    fold_in(fold_in(prng_key(seed + 1), step), shard) (core/prng.py) and
    the shard's loss the masked per-row sum over a fixed `batch_size` of
    rows, so a shard's gradient is the same problem in any process.
    The driver keeps the parameters and the optimizer state (nn/optim.py,
    optax's formulas) as torch tensors on `device`, which it resolves
    before it writes the spec: "cuda" without a card raises.

Membership changes trigger a checkpointed **re-shard barrier**, driven
by the driver-owned **world epoch** (monotone membership generation):

  drain (no in-flight step survives a membership change: the driver
  abandons the step and retries it after the barrier — a step is a pure
  function of (state, step index), so the retry is byte-identical)
  -> `TrainingCheckpointer` snapshot tagged {world_epoch, world_size}
  -> world_epoch += 1, recompute shard ownership for the new P
  -> `configure` every member (workers fence every op on the epoch, so
     a zombie worker from an older world gets `{"stale": true}` and no
     work) -> resume. A worker dying INSIDE the barrier just restarts
  the barrier loop with the new membership. As in the JAX package, the
  loop retries a failed `configure` without limit while any worker
  lives (a spec no worker can load spins it), so callers bound a fit
  with a deadline of their own.

Every re-shard lands a flight-recorder dump and a
`mmlspark_tpu_training_reshard_total{cause}` tick; workers run under
`PreemptionGuard` semantics (SIGTERM -> finish the in-flight reply ->
exit EX_TEMPFAIL). `FleetAutoscaler` plugs in via `signals()` (step-time
p99 + straggler wait) and the `autoscaler()` helper.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import math
import os
import pickle
import threading
from typing import Any, Callable

import numpy as np

from ..observability.sanitizer import make_lock
from ..parallel import dp
from .elastic import RESUMABLE_EXIT_CODE, TrainingCheckpointer

__all__ = [
    "ElasticWorkerFactory",
    "ElasticDNNFit",
    "ElasticGBDTFit",
    "elastic_fit_dnn",
    "elastic_fit_gbdt",
    "WORLD_SIZE_GAUGE",
]

_SPEC_FILE = "spec.json"
_TABLE_FILE = "table.pkl"
_STATUS_FILE = "elastic_status.json"
_CKPT_DIR = "_elastic_ckpt"

WORLD_SIZE_GAUGE = "mmlspark_tpu_training_world_size_count"


def _registry(reg=None):
    if reg is not None:
        return reg
    from ..observability.metrics import get_registry

    return get_registry()


def _world_gauge(reg):
    return reg.gauge(
        WORLD_SIZE_GAUGE,
        "live elastic-training worker processes (driver-owned singleton)")


def _reshard_counter(reg):
    return reg.counter(
        "mmlspark_tpu_training_reshard_total",
        "re-shard barriers crossed, by membership-change cause",
        labels=("cause",))


def _straggler_hist(reg):
    return reg.histogram(
        "mmlspark_tpu_training_straggler_wait_seconds",
        "per-step wait on the slowest worker beyond the median one")


def _fleet_record(kind: str, **data: Any) -> None:
    try:
        from ..observability.recorder import get_recorder

        get_recorder().record(kind, **data)
    except Exception:  # noqa: BLE001 — telemetry never blocks training
        pass


def _load_spec(checkpoint_dir: str) -> "tuple[dict, dict]":
    with open(os.path.join(checkpoint_dir, _SPEC_FILE),
              encoding="utf-8") as fh:
        spec = json.load(fh)
    with open(os.path.join(checkpoint_dir, spec["table_file"]), "rb") as fh:
        payload = fh.read()
    if hashlib.blake2b(payload, digest_size=16).hexdigest() != \
            spec["table_digest"]:
        raise ValueError("elastic table payload does not match spec digest")
    return spec, pickle.loads(payload)


# --------------------------------------------------------------------- #
# the flat parameter vector                                             #
# --------------------------------------------------------------------- #


def _sorted_leaves(tree: Any) -> list:
    """The leaves of a nested dict with every dict's keys sorted: the order
    `jax.tree_util` flattens a flax params tree in."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    return [tree]


class FlatParams:
    """`ravel_pytree`'s flat vector of a module's flax "params" tree, and
    back, as one gather on the parameters' device.

    Each layer's flax leaf is a permutation of its torch parameter (a
    transposed Dense or Conv kernel), so the map is a permutation: built
    once by sending every parameter element's index through
    `nn.carry.params_tree` in f64 (exact below 2**53 elements)."""

    def __init__(self, module):
        import torch

        from ..nn.carry import params_tree

        named = list(module.named_parameters())
        self.names = [n for n, _ in named]
        self.shapes = [tuple(p.shape) for _, p in named]
        self.sizes = [int(p.numel()) for _, p in named]
        total = sum(self.sizes)
        tags = torch.arange(total, dtype=torch.float64)
        tensors, off = {}, 0
        for n, shape, size in zip(self.names, self.shapes, self.sizes):
            tensors[n] = tags[off:off + size].reshape(shape)
            off += size
        tree = params_tree(module, tensors)
        order = np.concatenate([np.asarray(leaf, np.float64).reshape(-1)
                                for leaf in _sorted_leaves(tree)]) if total else \
            np.zeros(0)
        perm = order.astype(np.int64)
        if sorted(perm.tolist()) != list(range(total)):
            raise ValueError("the flax params tree is not a permutation of the module's "
                             "parameters")
        self._perm = torch.as_tensor(perm)          # flat position -> torch index
        self._inv = torch.as_tensor(np.argsort(perm))
        self.size = total

    def _on(self, device):
        if self._perm.device != device:
            self._perm, self._inv = self._perm.to(device), self._inv.to(device)
        return self._perm, self._inv

    def flatten(self, tensors) -> "Any":
        """The flat vector (a tensor on the tensors' device) of the torch
        parameters `tensors`, in `module.named_parameters()` order."""
        import torch

        cat = torch.cat([t.detach().reshape(-1) for t in tensors])
        perm, _ = self._on(cat.device)
        return cat[perm]

    def unflatten(self, flat) -> list:
        """Torch-layout tensors (on the flat tensor's device) of a flat
        vector."""
        _, inv = self._on(flat.device)
        cat = flat[inv]
        out, off = [], 0
        for shape, size in zip(self.shapes, self.sizes):
            out.append(cat[off:off + size].reshape(shape))
            off += size
        return out


# --------------------------------------------------------------------- #
# worker process                                                        #
# --------------------------------------------------------------------- #


class ElasticWorkerFactory:
    """Picklable `ServingFleet` handler factory speaking the elastic
    training protocol. The spec (model config + training arrays) loads
    lazily from `checkpoint_dir`, so a worker spawned mid-fit — respawn,
    scale-up, autoscaler — rebuilds everything a dead one held.

    JSON ops over POST / (every op except configure/status carries the
    driver's `world_epoch` and is FENCED on it — a zombie from an older
    world gets `{"stale": true}` and computes nothing):

      {"op": "configure", "world_epoch", "shards", ["model"]}
          adopt a new world: own these virtual shards; for GBDT the
          model-so-far rides along and raw predictions/node state are
          rebuilt from it (derived state — nothing to migrate)
      {"op": "status"}   -> kind/world_epoch/shards/step (+bin counters)
      {"op": "grad", "step", "params", "batch"}          (DNN)
          -> per-owned-virtual-shard gradient partials over the rows of
             `batch` that hash into each shard (masked fixed-capacity
             sums: the bits depend only on the shard's rows)
      {"op": "tree_start"} / {"op": "hist", "nodes"} /
      {"op": "split", "splits"} / {"op": "tree_finish", "values"} (GBDT)
          per-shard g/h/count histograms merge on the driver, split
          decisions come back

    SIGTERM lands `PreemptionGuard` semantics: the in-flight reply is
    finished, then the process exits `RESUMABLE_EXIT_CODE` (75) — the
    driver sees the membership change and re-shards."""

    def __init__(self, checkpoint_dir: str, guard: bool = True):
        self.checkpoint_dir = checkpoint_dir
        self.guard = bool(guard)

    # overridable so in-process handler tests never kill the test runner
    _exit = staticmethod(os._exit)

    def __call__(self):
        from ..io_http.schema import HTTPResponseData

        checkpoint_dir = self.checkpoint_dir
        lock = make_lock("ElasticWorker.state")
        st: dict[str, Any] = {"world_epoch": -1, "shards": (), "step": -1}
        loaded: dict[str, Any] = {}
        guard = None
        if self.guard:
            from .elastic import PreemptionGuard

            guard = PreemptionGuard(install=True)

        def _ensure_loaded() -> None:
            if "spec" in loaded:
                return
            spec, payload = _load_spec(checkpoint_dir)
            staged: dict[str, Any] = {
                "spec": spec,
                "x": np.asarray(payload["x"]),
                "y": np.asarray(payload["y"]),
                "assign": dp.shard_assignment(
                    len(payload["y"]), int(spec["num_virtual"])),
            }
            if spec["kind"] == "dnn":
                staged.update(_dnn_worker_state(spec, staged["x"]))
            else:
                staged.update(_gbdt_worker_state(spec, staged["x"]))
            loaded.update(staged)

        # -- ops -------------------------------------------------------- #

        def _configure(body: dict) -> dict:
            _ensure_loaded()
            epoch = int(body["world_epoch"])
            shards = tuple(int(s) for s in body["shards"])
            with lock:
                st["world_epoch"], st["shards"] = epoch, shards
            if loaded["spec"]["kind"] == "gbdt":
                loaded["rows_of_shard"] = {
                    s: np.where(loaded["assign"] == s)[0] for s in shards}
                model = body.get("model")
                if model is not None:
                    _gbdt_resync(loaded, model)
            return {"ok": True, "world_epoch": epoch}

        def _status() -> dict:
            with lock:
                doc = {"kind": None, "world_epoch": st["world_epoch"],
                       "shards": list(st["shards"]), "step": st["step"]}
            if "spec" in loaded:
                doc["kind"] = loaded["spec"]["kind"]
                if doc["kind"] == "gbdt":
                    from ..gbdt.shared_bins import bin_counters

                    doc["counters"] = bin_counters()
            return doc

        def _fenced(body: dict) -> "dict | None":
            epoch = int(body.get("world_epoch", -2))
            with lock:
                if epoch != st["world_epoch"]:
                    return {"stale": True, "world_epoch": st["world_epoch"]}
            return None

        def _grad(body: dict) -> dict:
            _ensure_loaded()
            step = int(body["step"])
            with lock:
                st["step"] = step
                shards = st["shards"]
            doc = _dnn_grad(loaded, shards, step, body)
            doc["world_epoch"] = st["world_epoch"]
            doc["step"] = step
            return doc

        def _gbdt_op(op: str, body: dict) -> dict:
            _ensure_loaded()
            with lock:
                shards = st["shards"]
                if op == "hist":
                    st["step"] = int(body.get("step", st["step"]))
            if op == "tree_start":
                _gbdt_tree_start(loaded)
                return {"ok": True}
            if op == "hist":
                doc = _gbdt_hist(loaded, shards, body)
                with lock:
                    doc["step"] = st["step"]
                return doc
            if op == "split":
                _gbdt_split(loaded, body)
                return {"ok": True}
            if op == "tree_finish":
                _gbdt_tree_finish(loaded, body)
                return {"ok": True}
            raise ValueError(f"unknown gbdt op {op!r}")

        def handler(table):
            from ..core.schema import Table

            replies = []
            for req in table["request"]:
                try:
                    body = req.json() or {}
                    op = body.get("op")
                    if op == "configure":
                        doc = _configure(body)
                    elif op == "status":
                        doc = _status()
                    else:
                        doc = _fenced(body)
                        if doc is None:
                            if op == "grad":
                                doc = _grad(body)
                            elif op in ("tree_start", "hist", "split",
                                        "tree_finish"):
                                doc = _gbdt_op(op, body)
                            else:
                                raise ValueError(f"unknown op {op!r}")
                    code, reason = 200, "OK"
                except Exception as e:  # noqa: BLE001 — reply, don't die
                    doc = {"error": f"{type(e).__name__}: {e}"}
                    code, reason = 500, "handler error"
                replies.append(HTTPResponseData(
                    code, reason, entity=json.dumps(doc).encode()))
            out = Table({"reply": replies})
            if guard is not None and guard.should_checkpoint():
                # preemption drain: this reply still flushes, then the
                # process exits EX_TEMPFAIL so the orchestrator knows the
                # work is resumable (the driver re-shards without us)
                threading.Timer(0.25, self._exit,
                                args=(RESUMABLE_EXIT_CODE,)).start()
            return out

        return handler


# -- DNN worker internals ----------------------------------------------- #


def _shard_loss_fn(model, loss_kind: str):
    """The masked per-row loss sum of one padded shard batch."""
    import torch.nn.functional as F

    from ..nn.models import train_forward

    def shard_loss(bx, by, mask, key):
        logits, _ = train_forward(model, bx, key)
        if loss_kind == "softmax_ce":
            per = F.cross_entropy(logits.float(), by.long(), reduction="none")
        else:
            per = (logits.squeeze(-1).float() - by.float()) ** 2
        return (per * mask).sum()

    return shard_loss


def _refuse_batch_stats(module) -> None:
    from ..nn.carry import module_variables

    if module_variables(module).get("batch_stats"):
        raise ValueError(
            "elastic DNN training does not support BatchNorm architectures "
            "(cross-shard batch statistics are not partition-invariant)")


def _dnn_worker_state(spec: dict, x: np.ndarray) -> dict:
    from ..core import prng
    from ..core.kernels import resolve_device
    from ..nn.models import make_model

    device = resolve_device(spec.get("device", "cuda"))
    cfg = dict(spec["model_config"])
    model = make_model(spec["architecture"], x.shape[1:], **cfg)
    _refuse_batch_stats(model)
    flat = FlatParams(model)
    model = model.to(device)
    params = [p for _, p in model.named_parameters()]
    return {"model": model, "params": params, "flat": flat, "device": device,
            "shard_loss": _shard_loss_fn(model, spec["loss"]),
            "base_key": prng.prng_key(int(spec["seed"]) + 1),
            "bs": int(spec["batch_size"]), "x32": np.asarray(x, np.float32)}


def _dnn_grad(loaded: dict, shards: "tuple[int, ...]", step: int,
              body: dict) -> dict:
    import torch

    from ..core import prng

    x, y = loaded["x32"], loaded["y"]
    assign, bs, device = loaded["assign"], loaded["bs"], loaded["device"]
    params = loaded["params"]
    vec = torch.as_tensor(dp.decode_array(body["params"]).astype(np.float32),
                          device=device)
    with torch.no_grad():
        for p, v in zip(params, loaded["flat"].unflatten(vec)):
            p.copy_(v)
    batch = np.asarray(body["batch"], np.int64)
    partials: dict[str, str] = {}
    losses: dict[str, list] = {}
    for s in shards:
        rows = batch[assign[batch] == s]
        if rows.size == 0:
            continue
        bx = np.zeros((bs,) + x.shape[1:], np.float32)
        bx[: rows.size] = x[rows]
        by = np.zeros((bs,), np.float64)
        by[: rows.size] = y[rows]
        mask = np.zeros((bs,), np.float32)
        mask[: rows.size] = 1.0
        # per-(step, shard) dropout stream: deterministic no matter which
        # worker owns the shard this epoch
        key = prng.fold_in(prng.fold_in(loaded["base_key"], step), s)
        loss = loaded["shard_loss"](torch.as_tensor(bx, device=device),
                                    torch.as_tensor(by, device=device),
                                    torch.as_tensor(mask, device=device), key)
        grads = torch.autograd.grad(loss, params)
        gv = loaded["flat"].flatten(grads)
        partials[str(s)] = dp.encode_array(gv.float().cpu().numpy())
        losses[str(s)] = [float(loss.detach()), int(rows.size)]
    return {"partials": partials, "loss": losses}


# -- GBDT worker internals ----------------------------------------------- #


def _gbdt_worker_state(spec: dict, x: np.ndarray) -> dict:
    from ..gbdt.binning import BinMapper
    from ..gbdt.shared_bins import mapper_digest, note_bin_build

    mapper = BinMapper.from_dict(spec["mapper"])
    if mapper_digest(mapper) != spec["mapper_digest"]:
        raise ValueError(
            "shipped BinMapper does not match the driver's boundary digest")
    bins = mapper.transform(np.asarray(x, np.float64)).astype(np.int32)
    note_bin_build()
    n = bins.shape[0]
    return {
        "bins": bins,
        "num_bins": max(int(mapper.num_bins.max(initial=2)), 2),
        "preds": np.full(n, float(spec["init_score"]), np.float64),
        "grad": np.zeros(n, np.float64),
        "hess": np.ones(n, np.float64),
        "node": np.zeros(n, np.int32),
        "rows_of_shard": {},
    }


def _gbdt_objective(loaded: dict) -> None:
    y = np.asarray(loaded["y"], np.float64)
    preds = loaded["preds"]
    if loaded["spec"]["objective"] == "binary":
        p = 1.0 / (1.0 + np.exp(-preds))
        loaded["grad"] = p - y
        loaded["hess"] = p * (1.0 - p)
    else:
        loaded["grad"] = preds - y
        loaded["hess"] = np.ones_like(preds)


def _gbdt_resync(loaded: dict, model: dict) -> None:
    """Rebuild raw predictions from the shipped model-so-far: worker
    tree state is DERIVED, so a joiner (or any re-shard) reconstructs it
    exactly instead of migrating bytes between processes."""
    bins = loaded["bins"]
    preds = np.full(bins.shape[0], float(model["init_score"]), np.float64)
    for enc in model["trees"]:
        tree = {k: dp.decode_array(v) for k, v in enc.items()}
        preds += dp.walk_tree_dict(tree, bins)
    loaded["preds"] = preds
    loaded["node"] = np.zeros(bins.shape[0], np.int32)


def _gbdt_tree_start(loaded: dict) -> None:
    _gbdt_objective(loaded)
    loaded["node"][:] = 0


def _gbdt_hist(loaded: dict, shards: "tuple[int, ...]",
               body: dict) -> dict:
    nodes = [int(n) for n in body["nodes"]]
    partials: dict[str, str] = {}
    for s in shards:
        rows = loaded["rows_of_shard"].get(s)
        if rows is None or rows.size == 0:
            continue
        hp = dp.hist_partial(
            loaded["bins"][rows], loaded["grad"][rows],
            loaded["hess"][rows], loaded["node"][rows], nodes,
            loaded["num_bins"])
        if not np.any(hp[..., 2]):
            # empty shard at this level: skipping is deterministic (the
            # row->shard map decides) and keeps -0.0 artifacts out of
            # the fixed-order fold
            continue
        partials[str(s)] = dp.encode_array(hp)
    return {"partials": partials}


def _gbdt_split(loaded: dict, body: dict) -> None:
    bins, node = loaded["bins"], loaded["node"]
    for nd, f, b, left, right in body["splits"]:
        mask = node == int(nd)
        go_left = bins[mask, int(f)] <= int(b)
        node[mask] = np.where(go_left, np.int32(left), np.int32(right))


def _gbdt_tree_finish(loaded: dict, body: dict) -> None:
    values = dp.decode_array(body["values"]).astype(np.float64)
    loaded["preds"] += values[loaded["node"]]


# --------------------------------------------------------------------- #
# driver                                                                #
# --------------------------------------------------------------------- #


class _ElasticFitBase:
    """Driver shared by the DNN and GBDT elastic fits: fleet lifecycle,
    world epoch, directed broadcast with straggler accounting, the
    re-shard barrier, durable status for `tools/diagnose.py --training`,
    and autoscaler signals."""

    kind = "base"

    def __init__(self, checkpoint_dir: str, *, n_workers: int = 2,
                 num_virtual: int = dp.V_DEFAULT,
                 request_timeout_s: float = 60.0,
                 checkpoint_every_n: int = 0,
                 fleet: Any = None, post: "Callable | None" = None,
                 fleet_kw: "dict | None" = None, metrics: Any = None,
                 step_hook: "Callable | None" = None,
                 barrier_hook: "Callable | None" = None,
                 guard_workers: bool = True,
                 log: "Callable[[str], None] | None" = None):
        if not checkpoint_dir:
            raise ValueError("elastic training requires a checkpoint_dir")
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if num_virtual < n_workers:
            raise ValueError(
                f"num_virtual ({num_virtual}) must be >= n_workers "
                f"({n_workers}): every member needs at least one shard")
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.n_workers = int(n_workers)
        self.num_virtual = int(num_virtual)
        self.request_timeout_s = float(request_timeout_s)
        self.checkpoint_every_n = int(checkpoint_every_n)
        self.fleet = fleet
        self._post_fn = post
        self.fleet_kw = dict(fleet_kw or {})
        self.registry = _registry(metrics)
        self.step_hook = step_hook
        self.barrier_hook = barrier_hook
        self.guard_workers = bool(guard_workers)
        self.log = log
        self._pool = None
        self._members: list[str] = []
        self.world_epoch = 0
        self.step = 0
        self.reshards: list[dict] = []
        self._step_times: list[float] = []
        self._member_steps: dict[str, int] = {}
        self._member_rtts: dict[str, float] = {}
        self._straggler_last = 0.0
        self.ckpt = TrainingCheckpointer(
            os.path.join(checkpoint_dir, _CKPT_DIR))

    # -- plumbing ------------------------------------------------------- #

    def _write_spec(self, spec_doc: dict, payload: dict) -> None:
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        with open(os.path.join(self.checkpoint_dir, _TABLE_FILE), "wb") as fh:
            fh.write(blob)
        spec_doc = dict(spec_doc)
        spec_doc["table_file"] = _TABLE_FILE
        spec_doc["table_digest"] = hashlib.blake2b(
            blob, digest_size=16).hexdigest()
        spec_doc["num_virtual"] = self.num_virtual
        with open(os.path.join(self.checkpoint_dir, _SPEC_FILE), "w",
                  encoding="utf-8") as fh:
            json.dump(spec_doc, fh, sort_keys=True)
        self.spec = spec_doc
        self.config_digest = hashlib.blake2b(
            json.dumps(spec_doc, sort_keys=True).encode(),
            digest_size=16).hexdigest()

    def _start_fleet(self) -> None:
        if self.fleet is None:
            from ..io_http.serving import ServingFleet

            kw = {"rendezvous": False,
                  "flight_recorder_dir": os.path.join(
                      self.checkpoint_dir, "flight"),
                  **self.fleet_kw}
            self.fleet = ServingFleet(
                ElasticWorkerFactory(self.checkpoint_dir,
                                     guard=self.guard_workers),
                n_hosts=self.n_workers, **kw)
            self.fleet.start()
        if self._post_fn is None:
            from ..io_http.clients import TargetPool

            self._pool = TargetPool(self.fleet.urls)
            self.fleet.watch(lambda event, url: (
                self._pool.add(url) if event == "added"
                else self._pool.remove(url)))

    def _stop_fleet(self) -> None:
        if self.fleet is not None and hasattr(self.fleet, "stop"):
            try:
                self.fleet.stop()
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass

    def _post(self, url: str, body: dict) -> "dict | None":
        if self._post_fn is not None:
            try:
                return self._post_fn(url, body)
            except Exception:  # noqa: BLE001 — a dead member reads None
                return None
        from ..io_http.schema import HTTPRequestData

        try:
            resp = self._pool.send(HTTPRequestData.from_json("/", body),
                                   timeout=self.request_timeout_s,
                                   target=url)
        except Exception:  # noqa: BLE001 — a dead member reads None
            return None
        if resp.status_code != 200 or not resp.entity:
            return None
        try:
            return json.loads(bytes(resp.entity).decode("utf-8"))
        except ValueError:
            return None

    def _broadcast(self, body: dict) -> "dict[str, dict | None]":
        """Directed send to every member IN PARALLEL, timing each reply:
        the (max - median) gap feeds the straggler histogram and the
        autoscaler signals."""
        import time as _time

        members = list(self._members)
        out: dict[str, Any] = {}
        rtts: dict[str, float] = {}

        def one(url: str) -> None:
            t0 = _time.monotonic()
            out[url] = self._post(url, body)
            rtts[url] = _time.monotonic() - t0

        threads = [threading.Thread(target=one, args=(u,), daemon=True)
                   for u in members]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if rtts:
            vals = sorted(rtts.values())
            wait = vals[-1] - vals[len(vals) // 2]
            self._straggler_last = wait
            _straggler_hist(self.registry).observe(wait)
            self._member_rtts.update(rtts)
        return out

    def _live(self) -> list[str]:
        return sorted(self.fleet.urls)

    def _membership_cause(self) -> "str | None":
        live = set(self._live())
        cur = set(self._members)
        if live == cur:
            return None
        if live > cur:
            return "join"
        if live < cur:
            return "death"
        return "resize"

    # -- the re-shard barrier ------------------------------------------- #

    def _state_payload(self) -> bytes:
        raise NotImplementedError

    def _model_doc(self) -> "dict | None":
        return None                      # GBDT ships the model-so-far

    def _ckpt_meta(self, world_size: int) -> dict:
        return {"world_epoch": self.world_epoch, "world_size": world_size,
                "step": self.step, "kind": self.kind,
                "config_digest": self.config_digest}

    def _reshard(self, cause: str) -> None:
        """drain -> checkpoint @ world epoch -> epoch++ -> re-own shards
        -> configure every member. A membership change DURING the
        barrier (configure hitting a fresh corpse, or a worker joining
        between two sends) restarts the loop against the new world —
        the barrier only completes against a stable membership."""
        self.ckpt.save(
            self._state_payload(), tag=f"step-{self.step}",
            meta=self._ckpt_meta(len(self._members) or self.n_workers))
        if self.barrier_hook is not None:
            self.barrier_hook(self)
        retries = 0
        while True:
            members = self._live()
            if not members:
                raise RuntimeError(
                    "elastic re-shard: no live workers left and no "
                    "healing policy brought any back")
            self.world_epoch += 1
            model = self._model_doc()
            ok = True
            for rank, url in enumerate(members):
                body = {"op": "configure", "world_epoch": self.world_epoch,
                        "shards": dp.shards_of_member(
                            rank, len(members), self.num_virtual)}
                if model is not None:
                    body["model"] = model
                doc = self._post(url, body)
                if doc is None or doc.get("error"):
                    ok = False
                    break
            if ok and set(self._live()) == set(members):
                self._members = members
                break
            retries += 1

        _reshard_counter(self.registry).labels(cause=cause).inc()
        _world_gauge(self.registry).set(len(self._members))
        _fleet_record("elastic.reshard", cause=cause,
                      world_epoch=self.world_epoch,
                      world_size=len(self._members), step=self.step,
                      barrier_retries=retries)
        try:
            self.fleet.dump_all(trigger=f"reshard-{cause}")
        except Exception:  # noqa: BLE001 — dumps are best-effort
            pass
        import time as _time

        self.reshards.append({
            "cause": cause, "world_epoch": self.world_epoch,
            "world_size": len(self._members), "step": self.step,
            "barrier_retries": retries, "unix_ts": _time.time()})
        if self.log:
            self.log(f"re-shard [{cause}] -> epoch {self.world_epoch}, "
                     f"P={len(self._members)} @ step {self.step}")
        self._write_status()

    def _ensure_world(self) -> None:
        """Step-boundary membership check: any drift re-shards first."""
        cause = self._membership_cause()
        if cause is not None or not self._members:
            self._reshard(cause or "join")

    def _after_step(self, t0: float, tag: str, what: str) -> None:
        """A committed step's bookkeeping: its time, the periodic and the
        preemption checkpoints, the status file."""
        import time as _time

        from .elastic import preempt_now

        self.step += 1
        self._step_times.append(_time.monotonic() - t0)
        if self.checkpoint_every_n and \
                self.step % self.checkpoint_every_n == 0:
            self.ckpt.save(self._state_payload(), tag=f"{tag}-{self.step}",
                           meta=self._ckpt_meta(len(self._members)))
        preempt_now(
            None,
            lambda: self.ckpt.save(
                self._state_payload(), tag=f"{tag}-{self.step}",
                meta=self._ckpt_meta(len(self._members))),
            what)
        self._write_status()

    # -- durable status / signals --------------------------------------- #

    def _write_status(self) -> None:
        members = []
        for rank, url in enumerate(self._members):
            seen = self._member_steps.get(url, -1)
            members.append({
                "rank": rank, "url": url, "step": seen,
                "lag": (self.step - seen) if seen >= 0 else None,
                "rtt_s": self._member_rtts.get(url)})
        doc = {
            "kind": self.kind, "world_epoch": self.world_epoch,
            "world_size": len(self._members), "step": self.step,
            "members": members,
            "last_reshard": self.reshards[-1] if self.reshards else None,
            "reshards": self.reshards[-8:],
            "straggler_wait_s": self._straggler_last,
        }
        tmp = os.path.join(self.checkpoint_dir, _STATUS_FILE + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        os.replace(tmp, os.path.join(self.checkpoint_dir, _STATUS_FILE))

    def _note_member_steps(self, docs: "dict[str, dict | None]") -> None:
        for url, doc in docs.items():
            if doc is not None and "step" in doc:
                self._member_steps[url] = int(doc["step"])

    def _gather_partials(self, body: dict) -> "dict[int, np.ndarray] | None":
        """Broadcast `body` and collect every member's per-shard partials;
        None when a member died, went stale or erred, or two members sent
        the same shard (the caller re-shards)."""
        docs = self._broadcast(body)
        partials: dict[int, np.ndarray] = {}
        for doc in docs.values():
            if doc is None or doc.get("stale") or doc.get("error"):
                return None
            for s, enc in doc.get("partials", {}).items():
                si = int(s)
                if si in partials:
                    return None          # double-owned shard: re-shard
                partials[si] = dp.decode_array(enc)
        self._last_docs = docs
        return partials

    def signals(self) -> dict:
        """Autoscaler signal dict: step-time p99 + straggler wait (plus
        zeroed serving keys so `FleetAutoscaler._calm` sees a full
        quiet baseline)."""
        times = sorted(self._step_times[-128:])
        p99 = times[min(len(times) - 1,
                        math.ceil(0.99 * len(times)) - 1)] if times else 0.0
        return {"queue_depth": 0.0, "p99_latency_s": 0.0,
                "shed_rate": 0.0, "burn_rate": 0.0,
                "step_p99_latency_s": float(p99),
                "straggler_wait_s": float(self._straggler_last)}

    def autoscaler(self, *, up_step_p99_s: float = 1.0,
                   up_straggler_s: float = 0.5, **kw):
        """A `FleetAutoscaler` holding THIS training fleet, scaling on
        step-time/straggler SLO pressure — training capacity managed by
        the same controller (and the same hysteresis/cooldown rules) as
        serving capacity. Scale actions surface to the fit as ordinary
        membership changes at the next step boundary."""
        from ..io_http.autoscale import FleetAutoscaler

        kw.setdefault("metrics", self.registry)
        return FleetAutoscaler(
            self.fleet, self.signals,
            extra_up={"step_p99_latency_s": float(up_step_p99_s),
                      "straggler_wait_s": float(up_straggler_s)}, **kw)

    # -- resume --------------------------------------------------------- #

    def _try_resume(self) -> "dict | None":
        got = self.ckpt.load_latest()
        if got is None:
            return None
        payload, entry = got
        meta = entry.get("meta", {})
        if meta.get("kind") != self.kind or \
                meta.get("config_digest") != self.config_digest:
            return None
        state = pickle.loads(payload)
        # a NEW incarnation of the driver: strictly newer world epoch, so
        # any zombie holding the old epoch is fenced at the first op and
        # `load_latest(max_world_epoch=...)` refuses its stale snapshots
        self.world_epoch = int(meta.get("world_epoch", 0)) + 1
        self.step = int(meta.get("step", 0))
        return state


# -- DNN driver ---------------------------------------------------------- #


class ElasticDNNFit(_ElasticFitBase):
    """Data-parallel DNN fit over elastic workers.

    The driver owns the parameters and the optimizer state (torch tensors
    on `device`) and the batch-order stream; workers own the data and
    return per-virtual-shard gradient sums of the masked per-row loss. One
    step = fold partials in shard order, divide by the (fixed) batch size,
    one optimizer update on the driver. Workers are model-state-free, so
    the re-shard barrier has nothing to migrate — only ownership to
    recompute.

    `device` is where the driver and the workers compute ("cuda" by
    default; it raises without a card). `init_variables`, a flax-layout
    variables tree, replaces `ModelBundle.init`'s random start (whose
    draws are not the JAX package's)."""

    kind = "dnn"

    def __init__(self, checkpoint_dir: str, *, architecture: str = "mlp",
                 model_config: "dict | None" = None, loss: str = "softmax_ce",
                 optimizer: str = "adam", learning_rate: float = 1e-3,
                 epochs: int = 2, batch_size: int = 32, seed: int = 0,
                 device: str = "cuda", init_variables: "dict | None" = None,
                 **kw: Any):
        super().__init__(checkpoint_dir, **kw)
        self.architecture = architecture
        self.model_config = dict(model_config or {})
        self.loss = loss
        self.optimizer = optimizer
        self.learning_rate = float(learning_rate)
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.device = str(device)
        self.init_variables = init_variables

    def _state_payload(self) -> bytes:
        state = {k: ([t.cpu().numpy() for t in v] if isinstance(v, list) else v)
                 for k, v in self._opt_state.items()}
        return pickle.dumps({
            "params": [p.detach().cpu().numpy() for p in self._params],
            "opt_state": state,
            "step": self.step,
        }, protocol=pickle.HIGHEST_PROTOCOL)

    def fit(self, x: np.ndarray, y: np.ndarray):
        """Returns the fitted `nn.models.ModelBundle`."""
        import time as _time

        import torch

        from ..core.kernels import resolve_device
        from ..nn.carry import load_variables, module_variables
        from ..nn.models import ModelBundle
        from ..nn.optim import Optimizer

        # a spec no worker can load would spin the re-shard barrier
        device = resolve_device(self.device)
        x = np.asarray(x)
        y = np.asarray(y)
        n = x.shape[0]
        bs = min(self.batch_size, n)
        num_classes = int(y.max()) + 1 if self.loss == "softmax_ce" else 1
        cfg = dict(self.model_config)
        cfg.setdefault("num_outputs", max(num_classes, 1))
        self._write_spec({
            "kind": "dnn", "architecture": self.architecture,
            "model_config": cfg, "loss": self.loss,
            "seed": self.seed, "batch_size": bs, "device": str(device),
        }, {"x": np.asarray(x, np.float32), "y": y})

        bundle = ModelBundle.init(self.architecture, x.shape[1:],
                                  seed=self.seed, **cfg)
        module = copy.deepcopy(bundle.module)
        if self.init_variables is not None:
            load_variables(module, self.init_variables)
        _refuse_batch_stats(module)
        self._flat = FlatParams(module)
        module = module.to(device)
        self._params = [p.detach() for _, p in module.named_parameters()]
        tx = Optimizer(self.optimizer, self.learning_rate)
        self._opt_state = tx.init(self._params)

        order = dp.global_batch_order(n, bs, self.epochs, self.seed)
        self._start_fleet()
        try:
            resumed = self._try_resume()
            if resumed is not None:
                with torch.no_grad():
                    for p, v in zip(self._params, resumed["params"]):
                        p.copy_(torch.as_tensor(v))
                self._opt_state = {
                    k: ([torch.as_tensor(a, device=device) for a in v]
                        if isinstance(v, list) else v)
                    for k, v in resumed["opt_state"].items()}
                self.step = int(resumed["step"])
            self._reshard("join" if resumed is None else "resume")

            while self.step < len(order):
                t0 = _time.monotonic()
                if self.step_hook is not None:
                    self.step_hook(self)
                self._ensure_world()
                batch = order[self.step]
                vec = self._flat.flatten(self._params).float().cpu().numpy()
                merged = self._merge_grads({
                    "op": "grad", "world_epoch": self.world_epoch,
                    "step": self.step,
                    "params": dp.encode_array(vec),
                    "batch": [int(r) for r in batch]}, batch)
                if merged is None:
                    # a member died or went stale mid-step: abandon the
                    # step, re-shard, retry — the retry is byte-identical
                    self._reshard(self._membership_cause() or "death")
                    continue
                grads = self._flat.unflatten(torch.as_tensor(merged, device=device))
                tx.step(self._params, grads, self._opt_state)
                self._note_member_steps(self._last_docs)
                self._after_step(t0, "step", "elastic-dnn")
            return dataclasses.replace(bundle, variables=module_variables(module),
                                       _module=None)
        finally:
            self._stop_fleet()

    def _merge_grads(self, body: dict, batch: np.ndarray) -> "np.ndarray | None":
        """The step's merged gradient (f32, flat), or None to re-shard."""
        partials = self._gather_partials(body)
        if partials is None:
            return None
        assign = dp.shard_assignment(int(batch.max()) + 1, self.num_virtual)
        needed = set(int(s) for s in np.unique(assign[batch]))
        if needed - set(partials):
            return None                  # a shard went missing: re-shard
        self.last_merged = dp.fold_partials(partials, self.num_virtual) / np.float32(len(batch))
        return self.last_merged

    def params_flat(self) -> np.ndarray:
        """The parameters as `ravel_pytree`'s f32 flat vector."""
        return self._flat.flatten(self._params).float().cpu().numpy()

    def params_digest(self) -> str:
        return hashlib.blake2b(self.params_flat().tobytes(),
                               digest_size=16).hexdigest()


# -- GBDT driver --------------------------------------------------------- #


class ElasticGBDTFit(_ElasticFitBase):
    """Data-parallel GBDT fit over elastic workers — the voting/data-
    parallel `tree_learner` on the fleet protocol: workers hold binned
    rows (identical `BinMapper` boundaries shipped in the spec) and return
    per-virtual-shard g/h/count histograms; the driver folds them in shard
    order, decides every split, and broadcasts the decisions back.

    A membership change mid-tree abandons the tree: worker tree state
    (raw preds, node-of-row) is derived from the committed model, so the
    barrier re-syncs it from the driver's tree list and the tree regrows
    byte-identically. The fit runs on the host; the returned Booster
    scores on `device`."""

    kind = "gbdt"

    def __init__(self, checkpoint_dir: str, *, objective: str = "regression",
                 num_iterations: int = 10, learning_rate: float = 0.1,
                 num_leaves: int = 31, max_depth: int = -1,
                 max_bin: int = 255, min_data_in_leaf: int = 20,
                 min_sum_hessian_in_leaf: float = 1e-3,
                 lambda_l2: float = 0.0, min_gain_to_split: float = 0.0,
                 boost_from_average: bool = True, seed: int = 0,
                 bin_construct_sample_cnt: int = 200_000,
                 device: str = "cuda", **kw: Any):
        super().__init__(checkpoint_dir, **kw)
        if objective not in ("regression", "l2", "binary"):
            raise ValueError(
                f"elastic GBDT supports regression/l2/binary objectives, "
                f"got {objective!r}")
        self.objective = "regression" if objective == "l2" else objective
        self.num_iterations = int(num_iterations)
        self.learning_rate = float(learning_rate)
        self.num_leaves = int(num_leaves)
        self.max_depth = int(max_depth)
        self.max_bin = int(max_bin)
        self.min_data_in_leaf = float(min_data_in_leaf)
        self.min_sum_hessian_in_leaf = float(min_sum_hessian_in_leaf)
        self.lambda_l2 = float(lambda_l2)
        self.min_gain_to_split = float(min_gain_to_split)
        self.boost_from_average = bool(boost_from_average)
        self.seed = int(seed)
        self.bin_construct_sample_cnt = int(bin_construct_sample_cnt)
        self.device = str(device)
        self._trees: list[dict] = []

    def _state_payload(self) -> bytes:
        return pickle.dumps(
            {"trees": self._trees, "step": self.step},
            protocol=pickle.HIGHEST_PROTOCOL)

    def _model_doc(self) -> dict:
        return {"init_score": self._init,
                "trees": [{k: dp.encode_array(np.asarray(v))
                           for k, v in t.items()} for t in self._trees]}

    def fit(self, x: np.ndarray, y: np.ndarray,
            feature_names: "list[str] | None" = None):
        """Returns a fitted `gbdt.booster.Booster`."""
        import time as _time

        from ..gbdt.binning import BinMapper
        from ..gbdt.booster import Booster, TrainOptions
        from ..gbdt.objectives import init_raw_score
        from ..gbdt.shared_bins import mapper_digest, note_bin_build

        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        mapper = BinMapper(
            max_bin=self.max_bin,
            bin_construct_sample_cnt=self.bin_construct_sample_cnt,
        ).fit(x)
        note_bin_build()
        self._init = float(init_raw_score(
            self.objective, y, None, self.boost_from_average))
        self._write_spec({
            "kind": "gbdt", "objective": self.objective,
            "mapper": mapper.to_dict(),
            "mapper_digest": mapper_digest(mapper),
            "init_score": self._init, "seed": self.seed,
        }, {"x": x, "y": y})

        self._start_fleet()
        try:
            resumed = self._try_resume()
            if resumed is not None:
                self._trees = list(resumed["trees"])
                self.step = int(resumed["step"])
            self._reshard("join" if resumed is None else "resume")

            while self.step < self.num_iterations:
                t0 = _time.monotonic()
                if self.step_hook is not None:
                    self.step_hook(self)
                self._ensure_world()
                tree = self._grow_tree()
                if tree is None:
                    # a member died or went stale mid-tree: the barrier
                    # re-syncs derived worker state from the committed
                    # model and the tree regrows byte-identically
                    self._reshard(self._membership_cause() or "death")
                    continue
                self._trees.append(tree)
                self._after_step(t0, "round", "elastic-gbdt")
            opts = TrainOptions(
                objective=self.objective,
                num_iterations=self.num_iterations,
                learning_rate=self.learning_rate,
                num_leaves=self.num_leaves, max_depth=self.max_depth,
                max_bin=self.max_bin,
                min_data_in_leaf=int(self.min_data_in_leaf),
                min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
                lambda_l2=self.lambda_l2,
                min_gain_to_split=self.min_gain_to_split,
                boost_from_average=self.boost_from_average, seed=self.seed,
                device=self.device)
            names = list(feature_names) if feature_names else []
            return Booster.from_tree_dicts(
                self._trees, [0] * len(self._trees), mapper, opts,
                self._init, names, device=self.device)
        finally:
            self._stop_fleet()

    # -- one tree, driver-orchestrated ---------------------------------- #

    def _gather_hist(self, nodes: "list[int]"):
        partials = self._gather_partials({
            "op": "hist", "world_epoch": self.world_epoch,
            "step": self.step, "nodes": nodes})
        if partials is None:
            return None
        self._note_member_steps(self._last_docs)
        if not partials:
            return None
        return dp.fold_partials(partials, self.num_virtual)

    def _all_ok(self, body: dict) -> bool:
        docs = self._broadcast(body)
        return all(doc is not None and doc.get("ok")
                   for doc in docs.values()) and bool(docs)

    def _grow_tree(self) -> "dict | None":
        if not self._all_ok({"op": "tree_start",
                             "world_epoch": self.world_epoch}):
            return None
        m = 2 * self.num_leaves - 1
        tree = dp.TreeBuilder(m)
        node_stats: dict[int, tuple] = {}
        frontier = [0]
        leaves, depth = 1, 0
        depth_cap = self.max_depth if self.max_depth > 0 else 64
        while frontier and depth < depth_cap:
            merged = self._gather_hist(frontier)
            if merged is None:
                return None
            if 0 not in node_stats:       # root totals from the histogram
                node_stats[0] = (
                    float(merged[0, 0, :, 0].sum()),
                    float(merged[0, 0, :, 1].sum()),
                    float(merged[0, 0, :, 2].sum()))
            splits, next_frontier = [], []
            for idx, nd in enumerate(frontier):
                parent = node_stats[nd]
                sp = None
                if leaves < self.num_leaves:
                    sp = dp.best_split(
                        merged[idx], parent, lambda_l2=self.lambda_l2,
                        min_data_in_leaf=self.min_data_in_leaf,
                        min_sum_hessian=self.min_sum_hessian_in_leaf,
                        min_gain=self.min_gain_to_split)
                if sp is None:
                    tree.set_leaf(nd, dp.leaf_value(
                        parent[0], parent[1], lambda_l2=self.lambda_l2,
                        learning_rate=self.learning_rate))
                    continue
                left, right = tree.alloc_pair()
                tree.set_split(nd, sp["feature"], sp["bin"], left, right,
                               sp["gain"])
                node_stats[left] = sp["left"]
                node_stats[right] = sp["right"]
                splits.append([nd, sp["feature"], sp["bin"], left, right])
                next_frontier += [left, right]
                leaves += 1
            if splits and not self._all_ok({
                    "op": "split", "world_epoch": self.world_epoch,
                    "splits": splits}):
                return None
            frontier = next_frontier
            depth += 1
        for nd in frontier:               # depth cap hit: close them out
            g, h, _ = node_stats[nd]
            tree.set_leaf(nd, dp.leaf_value(
                g, h, lambda_l2=self.lambda_l2,
                learning_rate=self.learning_rate))
        tree_dict = tree.to_dict()
        if not self._all_ok({
                "op": "tree_finish", "world_epoch": self.world_epoch,
                "values": dp.encode_array(
                    np.asarray(tree_dict["value"], np.float64))}):
            return None
        return tree_dict

    def model_digest(self) -> str:
        doc = json.dumps(
            [{k: dp.encode_array(np.asarray(v)) for k, v in t.items()}
             for t in self._trees], sort_keys=True)
        return hashlib.blake2b(doc.encode(), digest_size=16).hexdigest()


# --------------------------------------------------------------------- #
# estimator entry points                                                #
# --------------------------------------------------------------------- #


def elastic_fit_dnn(est, table) -> "Any":
    """`DNNLearner._fit` elastic path: same Params surface, same
    `DNNModel` out — only the compute moves onto fleet workers, on the
    learner's `device`."""
    from ..nn.trainer import DNNModel

    x_col = table[est.get("features_col")]
    x = np.stack(x_col) if isinstance(x_col, list) else np.asarray(x_col)
    y = np.asarray(table[est.get("label_col")])
    cfg = dict(est.get("model_config"))
    if est.get("bfloat16"):
        # the string form: the spec must be JSON
        cfg.setdefault("dtype", "bfloat16")
    fitter = ElasticDNNFit(
        est.get("checkpoint_dir"),
        architecture=est.get("architecture"),
        model_config=cfg,
        loss=est.get("loss"), optimizer=est.get("optimizer"),
        learning_rate=est.get("learning_rate"), epochs=est.get("epochs"),
        batch_size=est.get("batch_size"), seed=est.get("seed"),
        device=est.get("device"),
        n_workers=int(est.get("elastic_workers")),
        num_virtual=int(est.get("elastic_num_virtual")),
        checkpoint_every_n=int(est.get("checkpoint_every_n") or 0),
        log=est._log() if hasattr(est, "_log") else None)
    bundle = fitter.fit(x, y)
    model = DNNModel(features_col=est.get("features_col"),
                     prediction_col="prediction", device=est.get("device"))
    model.set_bundle(bundle, classifier=est.get("loss") == "softmax_ce")
    return model


def elastic_fit_gbdt(est, x: np.ndarray, y: np.ndarray, objective: str,
                     feature_names: "list[str] | None" = None):
    """GBDT estimator elastic path: returns the fitted Booster (scoring
    on the estimator's `device`) for the estimator to wrap exactly like
    the in-process path does."""
    fitter = ElasticGBDTFit(
        est.get("checkpoint_dir"),
        objective=objective,
        num_iterations=est.get("num_iterations"),
        learning_rate=est.get("learning_rate"),
        num_leaves=est.get("num_leaves"), max_depth=est.get("max_depth"),
        max_bin=est.get("max_bin"),
        min_data_in_leaf=est.get("min_data_in_leaf"),
        min_sum_hessian_in_leaf=est.get("min_sum_hessian_in_leaf"),
        lambda_l2=est.get("lambda_l2"),
        min_gain_to_split=est.get("min_gain_to_split"),
        boost_from_average=est.get("boost_from_average"),
        seed=est.get("seed"),
        bin_construct_sample_cnt=est.get("bin_construct_sample_cnt"),
        device=est.get("device"),
        n_workers=int(est.get("elastic_workers")),
        num_virtual=int(est.get("elastic_num_virtual")))
    return fitter.fit(x, y, feature_names=feature_names)
