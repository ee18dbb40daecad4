"""DNNLearner — deep-model training on the card — and DNNModel, its output.

Counterpart of mmlspark_tpu/nn/trainer.py, with its Params and defaults
and a `device` (default "cuda"). The JAX trainer jit-compiles one train
step, or scans a whole epoch in one dispatch; here the step runs eagerly:

- the forward is `train_forward` (nn/models.py), flax's
  `apply(train=True, mutable=["batch_stats"], rngs={"dropout": key})`,
  under `remat` recomputed in the backward pass; the transformer's flash
  core is K2 with its ported backward (`FlashAttention`);
- the loss is softmax cross entropy on f32 logits with integer labels, or
  the mean squared error;
- the optimizer is nn/optim.py's copy of optax's, freezing all but
  `trainable_prefixes` as `multi_transform` with `set_to_zero` does;
- a step's key is fold_in(fold_in(PRNGKey(seed + 1), epoch), step)
  (core/prng.py), the shuffle `np.random.default_rng(seed).permutation(n)`
  each epoch, the ragged tail dropped: the JAX trainer's batches and keys.

`fused_epochs` keeps the table on the device (within
`fused_epoch_budget_mb`) and gathers each step's rows there by index, the
counterpart of the epoch scan; otherwise batches stream through the
`Prefetcher` at `prefetch_depth`. Both give the same bits.

On a mesh of d shards (`use_mesh`, parallel/mesh.py; one process a shard)
shard i takes rows [i bs/d, (i+1) bs/d) of every global batch, the
gradients are psum-med and divided by d (the gradient of the global batch's
mean loss), BatchNorm's moments are the global batch's, and every rank ends
with the same parameters. A one-shard mesh is the one-device path.

Checkpoints go through `TrainingCheckpointer` with the JAX trainer's cursor
(epoch, batch) and payload: `nn/flax_blob.to_bytes` of {"epoch", "batch",
"params", "batch_stats", "opt_state"} in flax's state-dict layout (optax's
for the optimizer), so a snapshot of either package resumes in the other.
On a mesh, shard 0's rank writes them. `elastic_workers` fits over that
many elastic fleet worker processes (resilience/elastic_fleet.py) on
`device`, without warm starts or frozen prefixes, as the JAX trainer.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import logging
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import prng
from ..core.dataplane import Prefetcher
from ..core.kernels import resolve_device
from ..core.params import HasFeaturesCol, HasLabelCol, Param
from ..core.pipeline import Estimator
from ..core.schema import SCORE_KIND, Table
from ..core.serialize import register_stage
from ..observability.tracing import get_tracer
from ..parallel.mesh import get_mesh
from . import flax_blob
from .carry import (load_variables, module_variables, param_paths, params_from_tree,
                    params_tree)
from .models import ModelBundle, train_forward
from .optim import Optimizer
from .runner import DeepModelTransformer, _to_device

__all__ = ["DNNLearner", "DNNModel", "TrainState", "loss_and_grads"]


def _loss(logits: torch.Tensor, by: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "softmax_ce":
        return F.cross_entropy(logits.float(), by.long())
    return torch.mean((logits.squeeze(-1) - by.float()) ** 2)


def _sorted(tree):
    """A tree's dicts with their keys sorted, as `jax.device_get` leaves them."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


class TrainState:
    """A model being trained: its parameters split into trained and frozen,
    the optimizer and its state."""

    def __init__(self, model: nn.Module, optimizer: Optimizer, prefixes=None):
        self.model = model
        self.optimizer = optimizer
        paths = param_paths(model)
        self.names = [n for n, _ in model.named_parameters()]
        self.frozen = bool(prefixes)
        trained = [n for n in self.names
                   if not prefixes or any(".".join(paths[n]).startswith(p) for p in prefixes)]
        named = dict(model.named_parameters())
        for n in self.names:
            named[n].requires_grad_(n in trained)
        self.trained_names = trained
        self.trained = [named[n] for n in trained]
        self.opt_state = optimizer.init(self.trained)

    def install_stats(self, stats: dict) -> None:
        with torch.no_grad():
            for bn, (mean, var) in stats.items():
                bn.running_mean.copy_(mean)
                bn.running_var.copy_(var)

    # -- snapshots in the JAX trainer's layout --------------------------- #

    def snapshot(self, epoch: int, batch: int) -> dict:
        variables = module_variables(self.model)
        named = dict(self.model.named_parameters())

        def tree_of(slot: list):
            tensors = {n: named[n].data for n in self.names}
            tensors.update(zip(self.trained_names, slot))
            tree = params_tree(self.model, tensors)
            if self.frozen:
                paths = param_paths(self.model)
                for n in self.names:
                    if n not in self.trained_names:
                        *parents, leaf = paths[n]
                        node = tree
                        for part in parents:
                            node = node[part]
                        node[leaf] = {}
            return _sorted(tree)

        return {"epoch": int(epoch), "batch": int(batch),
                "params": _sorted(variables["params"]),
                "batch_stats": _sorted(variables.get("batch_stats", {})),
                "opt_state": self.optimizer.state_tree(self.opt_state, tree_of, self.frozen)}

    def restore(self, state: dict) -> None:
        variables = {"params": state["params"]}
        if state.get("batch_stats"):
            variables["batch_stats"] = state["batch_stats"]
        load_variables(self.model, variables)

        def tensors_of(tree) -> list:
            got = params_from_tree(self.model, tree)
            return [got[n].clone() for n in self.trained_names]

        self.opt_state = self.optimizer.load_state_tree(state["opt_state"], tensors_of,
                                                        self.frozen)


def loss_and_grads(ts: TrainState, bx: torch.Tensor, by: torch.Tensor, key, loss_kind: str,
                   mesh=None, remat: bool = False) -> tuple:
    """One step's forward and backward: (global mean loss, gradients of the
    trained parameters, new BatchNorm statistics). On a mesh the gradients
    are psum-med over the shards and divided by their count."""
    logits, stats = train_forward(ts.model, bx, key, mesh, remat)
    loss = _loss(logits, by, loss_kind)
    grads = torch.autograd.grad(loss, ts.trained) if ts.trained else ()
    loss = loss.detach()
    if mesh is not None:
        from ..parallel.collectives import psum

        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        flat = psum(flat, mesh) / mesh.size
        grads, at = [], 0
        for p in ts.trained:
            grads.append(flat[at:at + p.numel()].view_as(p))
            at += p.numel()
        loss = flat[-1]
    return loss, grads, stats


@register_stage
class DNNLearner(HasFeaturesCol, HasLabelCol, Estimator):
    """Fit a deep model on a Table (the CNTKLearner surface, in-process)."""

    architecture = Param("mlp", "architecture name (nn.models.ARCHITECTURES)", ptype=str)
    model_config = Param({}, "architecture config kwargs")
    loss = Param("softmax_ce", "softmax_ce | mse", ptype=str)
    optimizer = Param("adam", "adam|adamw|sgd|momentum|rmsprop", ptype=str)
    learning_rate = Param(1e-3, "base learning rate", ptype=float)
    epochs = Param(5, "epochs over the table", ptype=int)
    batch_size = Param(128, "global batch size", ptype=int)
    use_mesh = Param(True, "data-parallel over the mesh data axis", ptype=bool)
    seed = Param(0, "init + shuffle seed", ptype=int)
    checkpoint_dir = Param(None, "epoch checkpoint directory (resume if present)", ptype=str)
    checkpoint_every_n = Param(1, "checkpoint every N epochs (needs checkpoint_dir)", ptype=int)
    init_bundle_path = Param(None, "warm start from a saved ModelBundle", ptype=str)
    bfloat16 = Param(True, "compute in bfloat16 (f32 params)", ptype=bool)
    remat = Param(False, "rematerialize the forward in the backward pass", ptype=bool)
    trainable_prefixes = Param(None, "list of param path prefixes to train (None=all)")
    fused_epochs = Param(True, "keep the table on the device, gather each step's rows there",
                         ptype=bool)
    fused_epoch_budget_mb = Param(
        512, "max table MB resident on device for the fused epoch path", ptype=int
    )
    prefetch_depth = Param(
        2, "minibatches prepared ahead in the streamed epoch loop (0 = sync)",
        ptype=int,
    )
    # Elastic data-parallel fit over ServingFleet worker processes
    # (resilience/elastic_fleet.py): the fleet may grow or shrink mid-fit
    # without changing the resulting model's bytes.
    elastic_workers = Param(
        0, "fit data-parallel over N elastic fleet workers (0 = in-process)", ptype=int)
    elastic_num_virtual = Param(
        32, "virtual shards for the elastic fit (fixes the gradient merge order "
        "independently of the live worker count)", ptype=int)
    device = Param("cuda", "torch device of the fit: cuda | cpu", ptype=str)

    init_bundle: ModelBundle | None = None  # programmatic warm start

    def _fit(self, table: Table) -> "DNNModel":
        if int(self.get("elastic_workers") or 0) > 0:
            if self.init_bundle is not None or self.get("init_bundle_path"):
                raise ValueError(
                    "elastic_workers does not support warm starts "
                    "(init_bundle / init_bundle_path)")
            if self.get("trainable_prefixes"):
                raise ValueError("elastic_workers does not support trainable_prefixes")
            from ..resilience.elastic_fleet import elastic_fit_dnn

            return elastic_fit_dnn(self, table)
        x_col = table[self.get("features_col")]
        x = np.stack(x_col) if isinstance(x_col, list) else np.asarray(x_col)
        y = np.asarray(table[self.get("label_col")])
        n = x.shape[0]
        loss_kind = self.get("loss")
        # max+1, NOT unique-count: a CV fold may lack the highest class
        num_classes = int(y.max()) + 1 if loss_kind == "softmax_ce" else 1

        mesh = get_mesh() if self.get("use_mesh") else None
        if mesh is not None and mesh.size == 1:
            mesh = None
        device = resolve_device(mesh.device if mesh is not None and mesh.device is not None
                                else self.get("device"))
        bundle = self._initial_bundle(x, num_classes)
        model = copy.deepcopy(bundle.module).to(device)
        ts = TrainState(model, Optimizer(self.get("optimizer"), self.get("learning_rate")),
                        self.get("trainable_prefixes"))
        remat = bool(self.get("remat"))
        base_key = prng.prng_key(int(self.get("seed")) + 1)

        bs = min(int(self.get("batch_size")), n)  # small tables: never a zero-step epoch
        d = mesh.size if mesh is not None else 1
        bs = max((bs // d) * d, d)
        # this shard's rows of every global batch (P(DATA) of the JAX step)
        lo = mesh.shard_index * (bs // d) if mesh is not None else 0
        hi = lo + bs // d
        rng = np.random.default_rng(self.get("seed"))
        ckpt = self._checkpointer(mesh)
        start_epoch, start_batch = self._maybe_resume(ckpt, ts)
        # replay the shuffle stream of the completed epochs
        for _ in range(start_epoch):
            rng.permutation(n)

        steps = (n - bs) // bs + 1 if n >= bs else 0
        fused = (bool(self.get("fused_epochs")) and steps > 1
                 and x.nbytes + y.nbytes <= int(self.get("fused_epoch_budget_mb")) * 2 ** 20)
        if fused:
            xd, yd = _to_device(x, device), _to_device(y, device)

        def step(bx, by, key):
            loss, grads, stats = loss_and_grads(ts, bx, by, key, loss_kind, mesh, remat)
            ts.optimizer.step(ts.trained, grads, ts.opt_state)
            ts.install_stats(stats)
            return loss

        writer = mesh is None or mesh.shard_index == 0
        log = self._log()
        tracer = get_tracer()
        # each epoch's mean loss and host seconds (the loss read waits for
        # the device), for the caller
        self.epoch_losses, self.epoch_seconds = [], []
        for epoch in range(start_epoch, int(self.get("epochs"))):
            t0 = time.perf_counter()
            # a mid-epoch cursor comes from the streamed path only, so the
            # resumed-into epoch streams: both fold the same step keys
            resume_k = start_batch if epoch == start_epoch else 0
            use_fused = fused and not resume_k
            with tracer.start_span("trainer.epoch", epoch=epoch,
                                   fused=use_fused, steps=steps) as ep_span:
                order = rng.permutation(n)
                epoch_key = prng.fold_in(base_key, epoch)
                losses = []
                if use_fused:
                    idx = torch.as_tensor(order[: steps * bs].reshape(steps, bs)[:, lo:hi],
                                          device=device)
                    for k in range(steps):
                        losses.append(step(xd[idx[k]], yd[idx[k]], prng.fold_in(epoch_key, k)))
                else:
                    def prep(ki, _order=order):
                        k, i = ki
                        rows = _order[i: i + bs][lo:hi]
                        return k, _to_device(x[rows], device), _to_device(y[rows], device)

                    for k, bx, by in Prefetcher(
                            itertools.islice(enumerate(range(0, n - bs + 1, bs)), resume_k, None),
                            prep, depth=int(self.get("prefetch_depth")), name="trainer"):
                        losses.append(step(bx, by, prng.fold_in(epoch_key, k)))
                        self._drain(ckpt, ts, epoch, k + 1, mesh, writer, device)
                mean_loss = float(torch.stack(losses).mean()) if losses else float("nan")
                self.epoch_losses.append(mean_loss)
                self.epoch_seconds.append(time.perf_counter() - t0)
                ep_span.set(loss=mean_loss)
                log(f"epoch {epoch + 1}/{self.get('epochs')}: loss={mean_loss:.4f}")
                self._maybe_checkpoint(ckpt, ts, epoch + 1, 0, mesh, writer)
                self._drain(ckpt, ts, epoch + 1, 0, mesh, writer, device)

        out = dataclasses.replace(bundle, variables=module_variables(model), _module=None)
        model_out = DNNModel(features_col=self.get("features_col"), prediction_col="prediction",
                             device=self.get("device"))
        model_out.set_bundle(out, classifier=loss_kind == "softmax_ce")
        return model_out

    # ------------------------------------------------------------------ #

    def _initial_bundle(self, x: np.ndarray, num_classes: int) -> ModelBundle:
        path = self.get("init_bundle_path")
        if self.init_bundle is not None:
            # the fit trains a copy of its module and returns a new bundle:
            # the caller's stays as it was
            return self.init_bundle
        if path:
            return ModelBundle.load(path)
        cfg = dict(self.get("model_config"))
        cfg.setdefault("num_outputs", max(num_classes, 1))
        if self.get("bfloat16"):
            cfg.setdefault("dtype", "bfloat16")
        return ModelBundle.init(self.get("architecture"), x.shape[1:], seed=self.get("seed"),
                                **cfg)

    def _checkpointer(self, mesh):
        d = self.get("checkpoint_dir")
        if not d:
            return None
        from ..resilience.elastic import TrainingCheckpointer

        ckpt = TrainingCheckpointer(d)
        if mesh is not None:
            mesh.barrier()
        return ckpt

    def _maybe_checkpoint(self, ckpt, ts: TrainState, epoch: int, batch: int, mesh, writer: bool,
                          force: bool = False) -> "str | None":
        """Snapshot the resume cursor (epoch, batch) and the f32 training
        state: end-of-epoch writes (epoch+1, 0), a mid-epoch drain
        (epoch, step+1). On a mesh shard 0's rank writes, behind a barrier."""
        if ckpt is None:
            return None
        every = max(int(self.get("checkpoint_every_n")), 1)
        if not force and (batch != 0 or epoch % every != 0):
            return None
        path = None
        if writer:
            tag = f"epoch-{epoch:04d}" + (f"-step-{batch:05d}" if batch else "")
            path = ckpt.save(flax_blob.to_bytes(ts.snapshot(epoch, batch)), tag=tag,
                             meta={"epoch": int(epoch), "batch": int(batch),
                                   "seed": int(self.get("seed"))})
        if mesh is not None:
            mesh.barrier()
        return path

    def _drain(self, ckpt, ts, epoch: int, batch: int, mesh, writer: bool, device) -> None:
        """A draining PreemptionGuard: write the cursor and raise Preempted.
        On a mesh every rank stops when any rank's guard drains."""
        from ..resilience.elastic import Preempted, get_active_guard, preempt_now

        def write():
            return self._maybe_checkpoint(ckpt, ts, epoch, batch, mesh, writer, force=True)

        if mesh is None:
            preempt_now(None, write, "dnn-train")
            return
        from ..parallel.collectives import pmax

        guard = get_active_guard()
        draining = guard is not None and guard.should_checkpoint()
        if not float(pmax(torch.tensor([float(draining)], device=device), mesh)[0]):
            return
        path = write()
        if draining:
            preempt_now(guard, lambda: path, "dnn-train")
        raise Preempted("dnn-train preempted on another rank of the mesh; resumable "
                        "checkpoint written by shard 0's rank", checkpoint_path=path)

    def _maybe_resume(self, ckpt, ts: TrainState) -> tuple:
        if ckpt is None:
            return 0, 0
        loaded = ckpt.load_latest()
        if loaded is None:
            return 0, 0
        payload, entry = loaded
        log = self._log()
        meta = entry.get("meta") or {}
        if "seed" in meta and int(meta["seed"]) != int(self.get("seed")):
            log(f"ignoring checkpoint {entry['file']}: seed {meta['seed']} != {self.get('seed')}")
            return 0, 0
        state = flax_blob.from_bytes(payload)
        ts.restore(state)
        log(f"resuming from {entry['file']} at epoch {state['epoch']} batch {state['batch']}")
        return int(state["epoch"]), int(state["batch"])

    def _log(self):
        return logging.getLogger("mmlspark_tpu_torch.nn").info


@register_stage
class DNNModel(DeepModelTransformer):
    """Fitted DNNLearner output: DeepModelTransformer + argmax prediction."""

    prediction_col = Param("prediction", "predicted label column", ptype=str)
    classifier = Param(True, "argmax labels (vs raw regression output)", ptype=bool)

    features_col = Param("features", "input features column", ptype=str)

    def set_bundle(self, bundle: ModelBundle, classifier: bool = True) -> "DNNModel":
        self.set_model(bundle)
        self.set(input_col=self.get("features_col"), classifier=classifier)
        return self

    def _transform(self, table: Table) -> Table:
        self.set(input_col=self.get("features_col"))
        if self.get("classifier"):
            self.set(fetch_dict={"probability": "probability", "raw_prediction": "logits"})
        else:
            self.set(fetch_dict={self.get("prediction_col"): "logits"})
        out = DeepModelTransformer._transform(self, table)
        if self.get("classifier"):
            prob = np.asarray(out["probability"])
            labels = np.argmax(prob, axis=-1).astype(np.float64)
            out = out.with_column(self.get("prediction_col"), labels,
                                  meta={SCORE_KIND: "predicted_label"})
        else:
            arr = np.asarray(out[self.get("prediction_col")])
            if arr.ndim == 2 and arr.shape[1] == 1:
                out = out.with_column(self.get("prediction_col"), arr[:, 0],
                                      meta={SCORE_KIND: "prediction"})
        return out
