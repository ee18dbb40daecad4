"""DeepModelTransformer — batched DNN inference as a pipeline stage.

Counterpart of mmlspark_tpu/nn/runner.py (reference: `CNTKModel`,
src/cntk-model/src/main/scala/CNTKModel.scala:147-516). The model's weights
go to the device once per (bundle, device, bfloat16) and rows run in
fixed-size minibatches, the ragged tail padded by repeating the last row:

- `fused_dispatch`: one host->device copy of the whole padded table, then
  a loop over minibatch views of it on the device, the outputs gathered
  on the device and read back once;
- otherwise the pipelined path on the async data plane (core/dataplane.py):
  a `Prefetcher` slices, pads (to the `ShapeBucketer` ladder) and copies
  minibatch N+1 while the device computes N, and `AsyncReadback` reads
  N-1 back behind it.

Every prefetch depth gives the same bits; fused and pipelined give the
same rows. `bfloat16=True` casts the weights once (every floating
parameter and buffer) and the inputs per batch, as the JAX stage does
(runner.py:118-120, :226-232), rounding included. PyTorch runs eagerly,
so nothing is compiled: the `ExecutableCache` keeps the JAX stage's
per-(family, bucket) counters.

`device_kernel` hands core/fusion.py the same `_forward` with the device
model as its params, so a fused segment (a CUDA graph a shape on the
card) runs it.

`use_mesh` serves data-parallel on the current mesh's data axis
(`get_mesh().axis("data")`, one process a shard): every rank calls the
same transform on the whole table, the minibatch is rounded up to a
multiple of the axis size, each rank scores its block of every minibatch
on its device, and one all-gather a fetched output gives every rank all
the rows.

Fused under a mesh with a model axis of several ranks (core/fusion.py),
`device_kernel`'s `mesh_fn` swaps in the column-parallel forward
(`_tp_forward_fn`, the reference's runner.py:324-418) where the
reference's does: an "mlp" bundle in f32 fetching only logits or
probability, every dense layer's output features divisible by the model
axis. Rank (i, j) of a data x model grid holds column block j of every
dense layer (`tensor_parallel.column_block`), scores its data block i and
runs `gathered_column_parallel` over `mesh.axis("model")`: every output
element is one full-contraction dot, the gather only concatenates. The
reference's `MMLSPARK_TPU_RING_GATHER` environment switch is not carried
over (the port reads no environment overrides); the ring schedule stays
reachable as `gathered_column_parallel(ring=True)`.
"""

from __future__ import annotations

import base64
import copy
from typing import Any

import numpy as np
import torch
from torch import nn

from ..core.dataplane import AsyncReadback, ExecutableCache, Prefetcher, ShapeBucketer
from ..core.kernels import resolve_device
from ..core.params import Param
from ..core.pipeline import Model
from ..core.schema import SCORE_KIND, Table
from ..core.serialize import register_stage
from .models import Capture, ModelBundle

__all__ = ["DeepModelTransformer"]

# JAX runs with 64-bit types off: host arrays reach the device narrowed
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.require(a, dtype=_NARROW.get(a.dtype, a.dtype), requirements=["C", "W"])
    return torch.from_numpy(a).to(device, non_blocking=True)


@register_stage
class DeepModelTransformer(Model):
    """Batched forward pass of a ModelBundle over a Table column.

    fetch_dict maps output column -> "logits" | "probability" |
    "<layer path>" (a name from bundle.layer_names())."""

    input_col = Param("features", "input column (stacked to (n, ...))", ptype=str)
    fetch_dict = Param(
        {"output": "logits"}, "output column -> logits|probability|<layer path>")
    mini_batch_size = Param(64, "rows per device batch", ptype=int)
    use_mesh = Param(False, "shard batches over the data mesh axis",
                     ptype=bool)
    fused_dispatch = Param(
        True, "one host->device copy of the table, then a loop over minibatch views",
        ptype=bool)
    fused_dispatch_budget_mb = Param(
        512, "max input + output MB eligible for the fused path", ptype=int)
    bfloat16 = Param(
        False, "run the forward in bfloat16 (outputs stay float32)", ptype=bool)
    prefetch_depth = Param(
        2, "minibatches prepared ahead of device compute (0 = sequential)", ptype=int)
    shape_buckets = Param(
        True, "pad ragged tails to a pow-2 bucket ladder (vs full batch)", ptype=bool)
    device = Param("cuda", "torch device of the forward: cuda | cpu", ptype=str)

    bundle: ModelBundle | None = None
    _models: dict | None = None
    _outbytes_cache: dict | None = None
    _exec_cache: ExecutableCache | None = None
    #: stats from the most recent pipelined (non-fused) _transform
    last_pipeline_stats: dict | None = None

    def set_model(self, bundle: ModelBundle) -> "DeepModelTransformer":
        self.bundle = bundle
        self._models = {}
        self._outbytes_cache = {}
        self._exec_cache = ExecutableCache()
        return self

    # ------------------------------------------------------------------ #

    def _device_model(self, device: torch.device) -> nn.Module:
        """The bundle's model on `device`, cast to bfloat16 once when asked.
        id(bundle) in the key: assigning a new bundle directly must not
        score with stale weights."""
        if self._models is None:
            self._models = {}
        key = (id(self.bundle), str(device), bool(self.get("bfloat16")))
        if key not in self._models:
            model = copy.deepcopy(self.bundle.module).to(device)
            if self.get("bfloat16"):
                model = model.to(torch.bfloat16)
            self._models[key] = model.eval()
        return self._models[key]

    def _forward(self, model: nn.Module, fetches: tuple[str, ...], x: torch.Tensor,
                 mean: torch.Tensor, std: torch.Tensor) -> tuple[torch.Tensor, ...]:
        x = (x.float() - mean) / std
        if self.get("bfloat16"):
            x = x.to(torch.bfloat16)
        layers = {f for f in fetches if f not in ("logits", "probability")}
        if layers:
            with Capture(model, layers) as cap:
                logits = model(x)
        else:
            logits = model(x)
        logits = logits.float()
        outs = []
        for f in fetches:
            if f == "logits":
                outs.append(logits)
            elif f == "probability":
                outs.append(torch.softmax(logits, dim=-1))
            else:
                outs.append(cap.values[f].float())
        return tuple(outs)

    def _transform(self, table: Table) -> Table:
        if self.bundle is None:
            raise ValueError("DeepModelTransformer has no model; call set_model()")
        if self.get("use_mesh"):
            from ..parallel.mesh import DATA_AXIS, get_mesh

            mesh = get_mesh().axis(DATA_AXIS)
            if mesh.size > 1:
                return self._transform_mesh(table, mesh)
        col = table[self.get("input_col")]
        x = np.stack(col) if isinstance(col, list) else np.asarray(col)
        n = x.shape[0]
        fetch = dict(self.get("fetch_dict"))
        fetches = tuple(fetch.values())
        bs = int(self.get("mini_batch_size"))
        device = resolve_device(self.get("device"))
        model = self._device_model(device)
        mean = torch.as_tensor(np.asarray(self.bundle.preprocess.get("mean", 0.0),
                                          np.float32), device=device)
        std = torch.as_tensor(np.asarray(self.bundle.preprocess.get("std", 1.0),
                                         np.float32), device=device)

        pad = (-n) % bs
        fused = bool(self.get("fused_dispatch"))
        # the fused path holds the padded inputs AND every fetched output
        # on the device at once, so both sides count against the budget;
        # a batch's output bytes are known once one batch of this
        # (fetches, batch shape, model) has run
        if self._outbytes_cache is None:
            self._outbytes_cache = {}
        okey = (fetches, bs, x.shape[1:], str(x.dtype), id(self.bundle))
        if fused:
            row_bytes = np.dtype(_NARROW.get(x.dtype, x.dtype)).itemsize * \
                int(np.prod(x.shape[1:]))
            total = row_bytes * (n + pad) + self._outbytes_cache.get(okey, 0) * ((n + pad) // bs)
            fused = total <= int(self.get("fused_dispatch_budget_mb")) * 2 ** 20

        with torch.inference_mode():
            if fused:
                cols = self._transform_fused(x, bs, pad, model, fetches, mean, std)
            else:
                family = (fetches, bs, bool(self.get("bfloat16")), id(self.bundle),
                          str(device))
                cols = self._transform_pipelined(x, bs, family, model, fetches,
                                                 mean, std, device)
        if n:
            self._outbytes_cache[okey] = sum(c[0].nbytes for c in cols) * bs

        out = table
        for (col_name, fetch_name), arr in zip(fetch.items(), cols):
            kind = "probability" if fetch_name == "probability" else "raw_prediction"
            out = out.with_column(col_name, arr, meta={SCORE_KIND: kind})
        return out

    def _transform_mesh(self, table: Table, mesh) -> Table:
        """Data-parallel scoring over the 1-D data mesh `mesh` (reference
        runner.py:146-190): the minibatch rounded up to a multiple of the
        shards, shard i scoring rows [i bs/d, (i+1) bs/d) of every
        minibatch, the outputs all-gathered so every rank returns the
        whole table's."""
        from ..parallel import collectives as C

        col = table[self.get("input_col")]
        x = np.stack(col) if isinstance(col, list) else np.asarray(col)
        n = x.shape[0]
        fetch = dict(self.get("fetch_dict"))
        fetches = tuple(fetch.values())
        d = mesh.size
        bs = int(self.get("mini_batch_size"))
        bs = ((bs + d - 1) // d) * d
        per = bs // d
        params = self._device_params(mesh.device)
        model, mean, std = params["model"], params["mean"], params["std"]
        device = mean.device
        pad = (-n) % bs
        if pad and n:
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        nb = x.shape[0] // bs
        i = mesh.shard_index
        mine = x.reshape((nb, bs) + x.shape[1:])[:, i * per:(i + 1) * per]
        with torch.inference_mode():
            xd = _to_device(np.ascontiguousarray(mine.reshape((nb * per,) + x.shape[1:])),
                            device)
            outs: list[list[torch.Tensor]] = [[] for _ in fetches]
            for k in range(nb):
                for acc, o in zip(outs, self._forward(model, fetches, xd[k * per:(k + 1) * per],
                                                      mean, std)):
                    acc.append(o)
            cols = []
            for acc in outs:
                local = torch.cat(acc) if acc else torch.zeros(0)
                every = C.all_gather(local.contiguous(), mesh, axis=0, tiled=False)
                # (shards, nb * per, ...) -> minibatch order, shard blocks in turn
                every = every.reshape((d, nb, per) + tuple(local.shape[1:]))
                every = every.transpose(0, 1).reshape((nb * bs,) + tuple(local.shape[1:]))
                cols.append(every[:n].cpu().numpy())
        out = table
        for (col_name, fetch_name), arr in zip(fetch.items(), cols):
            kind = "probability" if fetch_name == "probability" else "raw_prediction"
            out = out.with_column(col_name, arr, meta={SCORE_KIND: kind})
        return out

    def _tp_forward_fn(self, fetches: tuple[str, ...], mesh):
        """The column-parallel forward for the fused tensor-parallel path,
        or None when this model cannot take it (the fused engine's default
        then applies: rows sharded, weights whole on every rank).

        Only the plain MLP qualifies: its forward is a chain of Dense +
        relu, which maps exactly onto `gathered_column_parallel`. Returns
        (forward(params, x) -> outputs, this rank's params): its column
        block of every dense layer as an (in, out / n) kernel and bias,
        and the preprocessing mean and std."""
        from ..parallel.mesh import MODEL_AXIS
        from ..parallel.tensor_parallel import column_block, gathered_column_parallel

        bundle = self.bundle
        n_model = 1 if mesh is None else int(mesh.shape.get(MODEL_AXIS, 1))
        if n_model <= 1:
            return None  # pure data parallelism: nothing to specialize
        if bundle.architecture != "mlp":
            return None
        if any(f not in ("logits", "probability") for f in fetches):
            return None  # intermediate captures need the module's hooks
        if self.get("bfloat16"):
            return None  # bf16 accumulation order voids the column layout's exactness
        module = bundle.module
        names = [f"dense_{i}" for i in range(getattr(module, "num_layers", -1))] + ["head"]
        want = {f"{nm}.{leaf}" for nm in names for leaf in ("weight", "bias")}
        got = dict(module.named_parameters())
        if set(got) != want or list(module.buffers()) or module.dtype != torch.float32:
            return None
        for nm in names:
            w = got[f"{nm}.weight"]
            if w.dtype != torch.float32 or w.dim() != 2 or w.shape[0] % n_model:
                return None  # output features must split evenly
        axis = mesh.axis(MODEL_AXIS)
        layers = [(column_block(got[f"{nm}.weight"].detach().t(), axis.shard_index,
                                axis.size).contiguous(),
                   column_block(got[f"{nm}.bias"].detach(), axis.shard_index,
                                axis.size).contiguous())
                  for nm in names]
        pre = bundle.preprocess
        params = {"layers": layers,
                  "mean": torch.as_tensor(np.asarray(pre.get("mean", 0.0), np.float32)),
                  "std": torch.as_tensor(np.asarray(pre.get("std", 1.0), np.float32))}

        def forward(p, x):
            h = (x.float() - p["mean"]) / p["std"]
            h = h.reshape(h.shape[0], -1)
            last = len(p["layers"]) - 1
            for i, (w, b) in enumerate(p["layers"]):
                h = gathered_column_parallel(h, w, b, axis)
                if i != last:
                    h = torch.relu(h)
            logits = h.float()
            return tuple(torch.softmax(logits, dim=-1) if f == "probability" else logits
                         for f in fetches)

        return forward, params

    def _transform_fused(self, x: np.ndarray, bs: int, pad: int, model: nn.Module,
                         fetches: tuple[str, ...], mean, std) -> list[np.ndarray]:
        n = x.shape[0]
        if pad:
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        xd = _to_device(x, mean.device)
        outs: list[list[torch.Tensor]] = [[] for _ in fetches]
        for start in range(0, len(x), bs):
            for acc, o in zip(outs, self._forward(model, fetches, xd[start:start + bs],
                                                  mean, std)):
                acc.append(o)
        return [torch.cat(o).cpu().numpy()[:n] for o in outs]

    def _transform_pipelined(self, x: np.ndarray, bs: int, family, model: nn.Module,
                             fetches: tuple[str, ...], mean, std,
                             device: torch.device) -> list[np.ndarray]:
        """Non-fused loop on the async data plane: prepare (slice + pad +
        copy) of minibatch N+1 overlaps device compute on N, and host
        readback lags one batch. Shapes, batch order and per-row outputs
        are the same at every prefetch depth."""
        n = x.shape[0]
        bucketer = ShapeBucketer(bs) if self.get("shape_buckets") else None
        if self._exec_cache is None:
            self._exec_cache = ExecutableCache()

        def prepare(i: int):
            chunk = x[i:i + bs]
            m = chunk.shape[0]
            if bucketer is not None:
                padded, _ = bucketer.pad(chunk)
            elif m < bs:
                padded = np.concatenate([chunk, np.repeat(chunk[-1:], bs - m, axis=0)])
            else:
                padded = chunk
            return _to_device(padded, device), m

        prefetch = Prefetcher(range(0, n, bs), prepare,
                              depth=int(self.get("prefetch_depth")), name="runner")
        # fetch = wait for the device result and slice the padding off;
        # lag 1 keeps batch N-1's readback behind batch N's dispatch
        readback = AsyncReadback(
            lambda om: tuple(a[:om[1]].cpu().numpy() for a in om[0]), lag=1)
        chunks: list[tuple[np.ndarray, ...]] = []
        for xb, m in prefetch:
            shape_key = (int(xb.shape[0]), tuple(xb.shape[1:]), str(xb.dtype))
            forward = self._exec_cache.get_or_build(family, shape_key,
                                                    lambda: self._forward)
            chunks.extend(readback.push((forward(model, fetches, xb, mean, std), m)))
        chunks.extend(readback.drain())
        self.last_pipeline_stats = {
            **prefetch.stats,
            "overlap_fraction": prefetch.overlap_fraction(),
            "prefetch_depth": prefetch.depth,
            "bucket_ladder": list(bucketer.ladder) if bucketer else [bs],
            **self._exec_cache.stats(),
        }
        return [np.concatenate([c[j] for c in chunks]) for j in range(len(fetches))]

    def _device_params(self, device=None) -> dict:
        """The forward's params on `device` (default: the stage's): the
        (bf16-cast) model and the preprocessing mean and std."""
        device = resolve_device(device if device is not None else self.get("device"))
        pre = self.bundle.preprocess
        return {"model": self._device_model(device),
                "mean": torch.as_tensor(np.asarray(pre.get("mean", 0.0), np.float32),
                                        device=device),
                "std": torch.as_tensor(np.asarray(pre.get("std", 1.0), np.float32),
                                       device=device)}

    def device_kernel(self):
        """Fusion kernel (core/fusion.py): the same `_forward` the staged
        path runs, with the device model, mean and std as params (moved to
        the segment's device once). The forward is row-independent (eval
        mode — no batch statistics), so the engine's chunking/padding
        cannot change any row's value. Under a mesh with a model axis of
        several ranks `mesh_fn` swaps in the column-parallel forward
        (`_tp_forward_fn`), whose gathers keep the segment eager."""
        from ..core.fusion import DeviceKernel

        if self.bundle is None:
            return "no model bundle attached (call set_model())"
        fetch = dict(self.get("fetch_dict"))
        fetches = tuple(fetch.values())
        out_cols = tuple(fetch.keys())
        in_col = self.get("input_col")

        def fn(params, cols):
            outs = self._forward(params["model"], fetches, cols[in_col],
                                 params["mean"], params["std"])
            return dict(zip(out_cols, outs))

        def ready(table: Table):
            if isinstance(table[in_col], list):
                return f"column {in_col!r} is a ragged list (host stacks it)"
            return True

        def mesh_fn(mesh):
            tp = self._tp_forward_fn(fetches, mesh)
            if tp is None:
                return None
            tp_forward, rank_params = tp

            def tp_fn(params, cols):
                return dict(zip(out_cols, tp_forward(params, cols[in_col])))

            tp_fn.collectives = True   # the gathers run eagerly, never in a graph
            return tp_fn, rank_params

        meta = {c: {SCORE_KIND: "probability" if f == "probability"
                    else "raw_prediction"} for c, f in fetch.items()}
        return DeviceKernel(
            fn=fn, input_cols=(in_col,), output_cols=out_cols,
            params=self._device_params(), name="DeepModelTransformer",
            out_dtypes={c: np.float32 for c in out_cols},
            out_meta=meta, ready=ready, mesh_fn=mesh_fn,
            mesh_desc=("rows P(data); dense kernels column-parallel "
                       "P(None,model) + tiled all_gather when the mesh has "
                       "a >1 model axis, else variables replicated"))

    # -- persistence ---------------------------------------------------- #

    def _save_state(self) -> dict[str, Any]:
        if self.bundle is None:
            return {}
        return {"bundle": base64.b64encode(self.bundle.to_bytes()).decode()}

    def _load_state(self, state: dict[str, Any]) -> None:
        if not state.get("bundle"):
            return
        self.set_model(ModelBundle.from_bytes(base64.b64decode(state["bundle"])))
