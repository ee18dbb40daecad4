"""Whole-pipeline fusion: run adjacent device-capable stages as ONE device
program over device-resident columns.

Counterpart of mmlspark_tpu/core/fusion.py. The role model is Spark SQL's
whole-stage codegen (Neumann, "Efficiently Compiling Efficient Query
Plans"; Spark's `WholeStageCodegenExec`): instead of running operators one
at a time with materialized intermediates, run a maximal run of compatible
operators as a single program. `PipelineModel._transform` runs stage by
stage, so a featurize -> model -> post-process chain crosses the
host/device boundary once per device stage. Fusion partitions the stage
list into maximal runs of stages that declare a pure device kernel, runs
each run as one composition, and keeps columns on the device across stage
boundaries. Host materialization happens only at non-fusable boundaries,
which run exactly as before.

Stage protocol
--------------
A stage opts in by implementing::

    def device_kernel(self) -> DeviceKernel | str | None

returning a `DeviceKernel` when it can run on the device, or a reason
string (or None) when it cannot. A kernel's `fn(params, cols)` must be a
pure, ROW-INDEPENDENT function over a dict of device tensors, with no host
sync (`.item()`, `.cpu()`, a Python branch on a tensor, `nonzero`): row
independence makes pad-to-bucket and chunked execution exact, and the
absence of host syncs lets a CUDA graph capture it. `params` is the
kernel's device-resident table (tree tables, binning keys, an `nn.Module`
and its preprocessing tensors, ...): moved to the segment's device once
per segment, as the reference's `device_put` (:314-319), and reused by
every batch.

jit becomes a CUDA graph
------------------------
On a CUDA device each (family, rung) of a segment is a
`torch.cuda.CUDAGraph`, captured once over static input buffers after one
eager warm-up call on a side stream; `ExecutableCache.get_or_build` counts
the capture as the compile, so the steady state is zero captures. A
replay copies the batch into the static inputs, replays, and copies the
outputs into fresh tensors, all on the calling stream under the
segment's lock: the next replay writes over the graph's own outputs, and
`AsyncReadback` reads batch N only after batch N+1 was dispatched.
Captures take turns across the process (`torch.cuda.graph`'s capture
stream is one for all of them), and a capture that fails keeps its graph
object alive, because destroying an unfinished CUDAGraph aborts the
process: its exception reaches the caller. The capture does not launch
the kernels it records, so the wrapper launch
counters (`core.kernels.LAUNCH_COUNTERS`) are set back after it and
advanced by the captured launches at every replay: they count launches
that ran. A capture that fails raises from the build; a segment never
runs eagerly on the card in a graph's place. On the CPU the same
composition runs eagerly under the same cache accounting. The
`donate_buffers` Param stays (and in the family key): a graph reuses its
static input buffers, which is what donation is here.

Fusion under a mesh of several ranks
------------------------------------
The reference row-shards one program over the chips of one process with
GSPMD; the port's mesh is one process a rank (parallel/mesh.py), so a
fused segment under a mesh of several ranks runs SPMD over processes:

* Every rank calls `transform` with the same host table. The chunk size
  rounds up to a multiple of the data-axis size d, the ladder is
  `ShapeBucketer(bs, shards=d)`, and rank i uploads only its block of each
  padded chunk (`DeviceTable.from_host(shardings=...)`), runs that block
  through its own CUDA graph (rung / d rows), and at fetch time the
  outputs are all-gathered over the data axis
  (`collectives.all_gather_rows`): every rank returns the whole table,
  the same bytes on every rank.
* Collectives never run inside a graph capture: the gather follows the
  replay. A segment whose body runs collectives itself (a kernel's
  `mesh_fn` marks such a body `collectives = True`, as the
  tensor-parallel MLP's) runs eagerly on the card; `stats` and
  `describe` say so.
* Params are "replicated" (whole on every rank), "none", or "custom" (the
  body and this rank's params from the kernel's `mesh_fn`), as the
  reference records them. The family key carries (mesh shape,
  placements) only under a sharded mesh; a mesh of one rank, or none, is
  the single-device path, byte for byte.
* Where only shard 0 holds the input (a server's request batch, a
  stream's micro-batch), shard 0 leads (`_MeshLead`): before each fused
  run, and each resident dispatch and fetch, it broadcasts a control word
  (and the padded batch), and the other ranks, in
  `FusedPipelineModel._follow`, receive it and run their block, until a
  stop word. A lead idle for 5 s sends an idle word, so a
  follower's wait never reaches the process group's timeout while shard 0
  lives; a follower that is gone fails the lead's next collective, and a
  stop that never comes fails the follower's wait at that timeout.
  Neither hangs.

Not ported: `ResidentExecutor.aot_args`, which serves the JAX package's
tools/aot_gate.py (it lowers JAX programs).

Integration
-----------
* `ExecutableCache` (core.dataplane) tracks one family per fused segment;
  ragged row counts pad up a `ShapeBucketer` ladder so steady-state
  recompiles stay at zero.
* Large tables stream through the segment in `mini_batch_size` chunks on
  the async data plane (`prefetch_depth` overlaps upload of chunk N+1
  with device compute on N).
* Each segment execution opens a `pipeline.fused_segment` span and the
  model publishes a `mmlspark_tpu_pipeline_fusion_ratio` gauge.

`serve_model` fuses `PipelineModel` handlers automatically; `fuse()` is
idempotent and `FusedPipelineModel` serializes like the `PipelineModel` it
wraps (a saved one loads in either package).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .dataplane import AsyncReadback, ExecutableCache, Prefetcher, ShapeBucketer
from .kernels import LAUNCH_COUNTERS, resolve_device
from .params import Param
from .pipeline import PipelineModel, Transformer
from .schema import Table
from .serialize import register_stage
from .table_io import DeviceTable

__all__ = [
    "DeviceKernel",
    "StagePlan",
    "SegmentPlan",
    "FusionPlan",
    "ResidentExecutor",
    "kernel_of",
    "plan_fusion",
    "fuse",
    "FusedPipelineModel",
]


@dataclass
class DeviceKernel:
    """One stage's pure device program plus its column contract.

    fn(params, cols) -> dict of output columns; `cols` maps column name to
    a device tensor and contains at least `input_cols`.  The function must
    be row-independent and free of host syncs (see module docstring).
    `out_dtypes` maps output columns to the HOST dtype the staged path
    would produce — the engine casts after read-back so fused and staged
    tables carry identical schemas (e.g. float32 device features widening
    to a float64 column is exact).  `out_meta` carries per-column
    `ColumnMeta`; a value may be a callable taking the downloaded ndarray
    (for shape-dependent metadata like IMAGE_SPEC).  `ready(table)` is the
    runtime fusability check on the HOST inputs (dtype / uniformity
    preconditions); returning a string vetoes fusion for that table and
    the segment falls back to the staged path.  `ready_values(cols)` is
    the cheap VALUE-dependent subset of `ready` over a plain
    `{col: ndarray}` dict: a serving hot path that already validated the
    schema once at warmup calls only this per batch (a kernel with a
    value-dependent `ready` but no `ready_values` keeps paying the full
    check — no precondition is ever silently skipped).

    `mesh_fn(mesh)` is the reference's mesh hook: under a mesh of several
    ranks it returns None (the default: this body, params whole on every
    rank) or `(body, rank_params)`, another body and the params THIS rank
    holds (placement "custom"). A body that runs collectives itself
    carries the attribute `collectives = True`; its segment then runs
    eagerly, never in a CUDA graph. `mesh_desc` is the plan text's
    sharding line. `kernel_label` names the device program variant (e.g.
    the GBDT models' `fused_traverse`) so the plan output pins WHICH
    program a segment runs."""

    fn: Callable[[Any, dict], dict]
    input_cols: tuple[str, ...]
    output_cols: tuple[str, ...]
    params: Any = None
    name: str = ""
    out_dtypes: dict[str, Any] = field(default_factory=dict)
    out_meta: dict[str, Any] = field(default_factory=dict)
    ready: "Callable[[Table], Any] | None" = None
    ready_values: "Callable[[dict], Any] | None" = None
    mesh_fn: "Callable[[Any], tuple | None] | None" = None
    mesh_desc: str = "rows P(data) / params replicated"
    kernel_label: str = ""


@dataclass
class StagePlan:
    stage: Any
    kernel: "DeviceKernel | None"
    reason: str = ""  # why the stage stays on host ("" when fused)

    @property
    def fused(self) -> bool:
        return self.kernel is not None


@dataclass
class SegmentPlan:
    fused: bool
    stages: list[StagePlan]


@dataclass
class FusionPlan:
    segments: list[SegmentPlan]

    @property
    def n_stages(self) -> int:
        return sum(len(s.stages) for s in self.segments)

    @property
    def n_fused_stages(self) -> int:
        return sum(len(s.stages) for s in self.segments if s.fused)

    @property
    def fusion_ratio(self) -> float:
        n = self.n_stages
        return (self.n_fused_stages / n) if n else 0.0

    def transfers_per_batch(self) -> tuple[int, int]:
        """(fused, staged) host<->device boundary crossings per batch:
        fused pays one upload + one read-back per fused segment; the
        staged path pays the same pair once per device-capable STAGE."""
        fused = 2 * sum(1 for s in self.segments if s.fused)
        staged = 2 * self.n_fused_stages
        return fused, staged

    def describe(self, mesh: Any = None, donate: "bool | None" = None,
                 pipeline_depth: "int | None" = None,
                 eager: "Sequence[int]" = ()) -> str:
        """Human-readable segment plan, the same text as the JAX
        package's. With a mesh, each fused segment also shows the mesh
        shape; `donate` / `pipeline_depth` (the model's runtime knobs)
        print next to it. The segments listed in `eager` (their bodies run
        collectives) say that they run eagerly."""
        lines = []
        fused_t, staged_t = self.transfers_per_batch()
        mesh_label = ("x".join(str(s) for s in mesh.shape.values())
                      if mesh is not None else "1")
        for i, seg in enumerate(self.segments):
            kind = "FUSED" if seg.fused else "HOST"
            suffix = f" mesh={mesh_label}" if seg.fused else ""
            if seg.fused and donate is not None:
                suffix += f" donate={'on' if donate else 'OFF'}"
            if seg.fused and pipeline_depth is not None:
                suffix += f" in_flight={int(pipeline_depth) + 1}"
            if seg.fused and i in eager:
                suffix += " eager (collectives in its body)"
            lines.append(f"segment {i} [{kind}]{suffix}")
            for sp in seg.stages:
                name = type(sp.stage).__name__
                if seg.fused:
                    k = sp.kernel
                    label = f" kernel={k.kernel_label}" if k.kernel_label \
                        else ""
                    lines.append(
                        f"  {name}: {','.join(k.input_cols)} -> "
                        f"{','.join(k.output_cols)}{label}")
                    lines.append(f"    sharding: {k.mesh_desc}")
                else:
                    lines.append(f"  {name}: {sp.reason}")
        lines.append(
            f"fused {self.n_fused_stages}/{self.n_stages} stages "
            f"(ratio {self.fusion_ratio:.2f}); transfers/batch: "
            f"{fused_t} fused vs {staged_t} staged device-stage pairs")
        return "\n".join(lines)


def kernel_of(stage: Any) -> tuple["DeviceKernel | None", str]:
    """(kernel, reason): a stage's declared device kernel, or why it has
    none.  Never raises — a broken declaration just keeps the stage on the
    host path."""
    decl = getattr(stage, "device_kernel", None)
    if decl is None:
        return None, "no device kernel declared"
    try:
        k = decl()
    except Exception as e:  # noqa: BLE001 — declaration failure == host
        return None, f"device_kernel() failed: {e}"
    if isinstance(k, DeviceKernel):
        if not k.name:
            k.name = type(stage).__name__
        return k, ""
    return None, (k if isinstance(k, str) else "stage declared itself non-fusable")


def _flatten(stages: Sequence[Any]) -> list[Any]:
    """Flatten nested PipelineModels into their leaf stages (sequential
    composition is associative, so this never changes semantics — and it
    lets fusable leaves inside a nested model join an adjacent run)."""
    out: list[Any] = []
    for s in stages:
        if isinstance(s, PipelineModel):
            out.extend(_flatten(s.get("stages") or []))
        else:
            out.append(s)
    return out


def plan_fusion(stages: Sequence[Any]) -> FusionPlan:
    """Partition a stage list into maximal fused runs / host runs."""
    segments: list[SegmentPlan] = []
    for stage in _flatten(stages):
        kernel, reason = kernel_of(stage)
        sp = StagePlan(stage, kernel, reason)
        if segments and segments[-1].fused == sp.fused:
            segments[-1].stages.append(sp)
        else:
            segments.append(SegmentPlan(sp.fused, [sp]))
    return FusionPlan(segments)


# --------------------------------------------------------------------- #
# device placement, launch counters, CUDA graphs                        #
# --------------------------------------------------------------------- #


def _to_device(obj: Any, dev: torch.device) -> Any:
    """A kernel's params on `dev`: tensors copied there once,
    an `nn.Module` copied there unless it already lives there (the
    stage's own copy is never moved), containers walked."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, torch.nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
        if all(t.device == dev for t in tensors):
            return obj
        return copy.deepcopy(obj).to(dev)
    if isinstance(obj, dict):
        return {k: _to_device(v, dev) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, dev) for v in obj)
    return obj


def _launch_counts() -> list:
    """(wrapper, launches, launches_by_path copy) of every counted kernel
    wrapper (`core.kernels.LAUNCH_COUNTERS`)."""
    return [(fn, fn.launches, dict(getattr(fn, "launches_by_path", None) or {}))
            for fn in LAUNCH_COUNTERS]


def _counts_since(before: list) -> list:
    """(wrapper, launches, {path: launches}) added since `before`."""
    out = []
    for fn, n, by_path in before:
        now = dict(getattr(fn, "launches_by_path", None) or {})
        out.append((fn, fn.launches - n,
                    {p: c - by_path.get(p, 0) for p, c in now.items()
                     if c != by_path.get(p, 0)}))
    return out


def _add_counts(delta: list, sign: int = 1) -> None:
    for fn, n, by_path in delta:
        fn.launches += sign * n
        paths = getattr(fn, "launches_by_path", None)
        if paths is not None:
            for p, c in by_path.items():
                paths[p] = paths.get(p, 0) + sign * c


class _DeviceOuts(tuple):
    """A dispatch's output tensors plus the CUDA event recorded after
    them (None on the CPU and for an eager run): `_is_ready` queries it,
    `_block_ready` waits on it. `seq` numbers a led resident dispatch."""

    event: Any = None
    seq: int = -1


# `torch.cuda.graph` captures on one capture stream shared by the whole
# process, so two captures at once (two servers warming their ladders on
# their own threads) would collide: captures take turns under this lock
_CAPTURE_LOCK = threading.Lock()
# graphs whose capture failed: destroying a CUDAGraph that never finished
# its capture aborts the process, so they are kept, and the capture's
# exception reaches the caller instead
_FAILED_CAPTURES: list = []


class _CudaGraphExec:
    """One (rows, dtypes) shape of a fused segment on the card: the
    composition captured in a `torch.cuda.CUDAGraph` over static input
    buffers. `__call__` copies the batch in, replays and copies the
    outputs out on the calling stream, under the segment's lock."""

    def __init__(self, segment: "_FusedSegment", params: tuple, args: tuple):
        with _CAPTURE_LOCK:
            self._capture(segment, params, args)

    def _capture(self, segment: "_FusedSegment", params: tuple, args: tuple) -> None:
        dev = args[0].device
        self.segment = segment
        self.static_in = tuple(torch.empty_like(a) for a in args)
        for s, a in zip(self.static_in, args):
            s.copy_(a)
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side), torch.no_grad():
            # the eager warm-up: kernel libraries loaded, attributes set,
            # cuBLAS handles made, scratch buffers allocated — nothing of
            # that may happen inside the capture
            segment._composed(params, self.static_in)
        stream.wait_stream(side)
        torch.cuda.synchronize(dev)
        segment.forwards += 1
        self.graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        try:
            with torch.cuda.graph(self.graph, pool=segment._graph_pool,
                                  capture_error_mode="thread_local"), torch.no_grad():
                self.static_out = segment._composed(params, self.static_in)
        except BaseException:
            _FAILED_CAPTURES.append(self.graph)
            raise
        finally:
            # the capture recorded these launches; none of them ran
            self.launches = _counts_since(before)
            _add_counts(self.launches, -1)
        segment.captures += 1

    def __call__(self, params: tuple, args: tuple) -> _DeviceOuts:
        seg = self.segment
        with seg._replay_lock:
            if seg._last_replay is not None:
                torch.cuda.current_stream().wait_event(seg._last_replay)
            for s, a in zip(self.static_in, args):
                s.copy_(a)
            self.graph.replay()
            outs = _DeviceOuts(o.clone() for o in self.static_out)
            outs.event = seg._last_replay = torch.cuda.Event()
            outs.event.record()
            _add_counts(self.launches)
            seg.forwards += 1
            seg.replays += 1
        return outs


# --------------------------------------------------------------------- #
# fused segment runtime                                                 #
# --------------------------------------------------------------------- #


class _FusedSegment:
    """One maximal run of device-capable stages run as a single
    composition over device-resident columns on `device`: a CUDA graph a
    shape on the card, the eager composition on the CPU. Under a `mesh`
    of several ranks each rank runs its block of every chunk (module
    docstring)."""

    def __init__(self, index: int, plans: list[StagePlan], mesh: Any = None,
                 donate: bool = False, device: str = "cuda"):
        self.index = index
        self.plans = plans
        self.mesh = mesh
        self.donate = bool(donate)
        # resolved at the first build: planning needs no card
        self.device = torch.device(device)
        self.kernels = [p.kernel for p in plans]
        self.stage_names = [type(p.stage).__name__ for p in plans]
        # upload set: inputs not produced by an earlier kernel in the run;
        # download set: the FINAL value of every column any kernel produces
        produced: dict[str, DeviceKernel] = {}
        uploads: list[str] = []
        for k in self.kernels:
            for c in k.input_cols:
                if c not in produced and c not in uploads:
                    uploads.append(c)
            for c in k.output_cols:
                produced[c] = k  # last producer wins
        self.upload_cols = tuple(uploads)
        self.download_cols = tuple(produced)
        self._last_producer = produced
        self._exec_cache = ExecutableCache()
        self._device_params = None
        self._bodies = None
        self._param_placements: "tuple[str, ...] | None" = None
        # a body that runs collectives (mesh_fn's `collectives = True`)
        # keeps the segment out of CUDA graphs
        self.eager_collectives = False
        # CUDA graphs by (rows, dtypes, trailing shapes): the run path and
        # the resident path share a shape's graph (their cache keys differ,
        # as the reference's do, while jax's own cache holds one program)
        self._graphs: dict[tuple, _CudaGraphExec] = {}
        self._graph_lock = threading.Lock()
        self._replay_lock = threading.Lock()
        self._graph_pool = None
        # the event after the last replay's output copies: the next replay
        # on any stream waits for it before writing the shared buffers
        self._last_replay = None
        # executions of the composition: eager runs and warm-ups, graph
        # replays, and (apart) captures, which record and do not run
        self.forwards = 0
        self.replays = 0
        self.captures = 0

    # -- build ---------------------------------------------------------- #

    def _build(self) -> tuple:
        """The kernels' params, moved to the segment's device once, and
        their placements: "single" without a mesh; under one, "none"
        (no params), "replicated" (whole on every rank) or "custom" (the
        body and this rank's params from the kernel's `mesh_fn`)."""
        if self._device_params is None:
            self.device = resolve_device(self.device)
            bodies, params, placements = [], [], []
            for k in self.kernels:
                body, mine = k.fn, None
                if self.mesh is not None and k.mesh_fn is not None:
                    spec = k.mesh_fn(self.mesh)
                    if spec is not None:
                        body, mine = spec
                bodies.append(body)
                if self.mesh is None:
                    params.append(k.params)
                    placements.append("single")
                elif k.params is None:
                    params.append(None)
                    placements.append("none")
                elif mine is None:
                    params.append(k.params)
                    placements.append("replicated")
                else:
                    params.append(mine)
                    placements.append("custom")
            self._device_params = tuple(
                _to_device(p, self.device) if p is not None else None for p in params)
            self._bodies = bodies
            self._param_placements = tuple(placements)
            self.eager_collectives = any(getattr(b, "collectives", False) for b in bodies)
        return self._device_params

    def _composed(self, params_tuple, in_arrays) -> tuple:
        cols = dict(zip(self.upload_cols, in_arrays))
        for body, p in zip(self._bodies, params_tuple):
            cols.update(body(p, cols))
        return tuple(cols[c] for c in self.download_cols)

    def _eager_call(self, params, args) -> _DeviceOuts:
        with torch.no_grad():
            outs = _DeviceOuts(self._composed(params, args))
        self.forwards += 1
        return outs

    def _graph_for(self, args: tuple) -> _CudaGraphExec:
        key = tuple((str(a.dtype), tuple(a.shape)) for a in args)
        with self._graph_lock:
            g = self._graphs.get(key)
            if g is None:
                if self._graph_pool is None:
                    # one memory pool for the segment's graphs: replays
                    # never overlap (one lock), and every graph keeps its
                    # own outputs alive, so no graph reuses another's
                    self._graph_pool = torch.cuda.graph_pool_handle()
                g = self._graphs[key] = _CudaGraphExec(self, self._device_params, args)
        return g

    def _executable(self, args: tuple):
        """The builder `ExecutableCache.get_or_build` times: on the card
        the capture of this shape's graph (once, shared between run and
        resident paths), on the CPU, and for a body that runs collectives,
        the eager composition."""
        if self.device.type == "cuda" and not self.eager_collectives:
            return self._graph_for(args)
        return self._eager_call

    def _family_key(self, ins: dict) -> Any:
        """Executable-cache family: program lineage = this segment's column
        contract and whether its batch buffers are donated (reused), plus,
        under a mesh, (mesh_shape, sharding_spec): a mesh change is a NEW
        family, never a recompile of the old one."""
        base = (id(self), ("donate", self.donate), tuple(
            (c, str(ins[c].dtype), ins[c].shape[1:]) for c in self.upload_cols))
        if self.mesh is None:
            return base
        self._build()  # placements are part of the lineage
        spec = tuple(zip((k.name for k in self.kernels), self._param_placements)) + tuple(
            (c, "P(data)") for c in self.upload_cols)
        return ExecutableCache.family_key(
            base, mesh_shape=tuple(self.mesh.shape.items()), sharding_spec=spec)

    def _data_axis(self):
        """The ranks that hold this rank's model-axis block and split the
        rows between them (the whole mesh on a data mesh)."""
        from ..parallel.mesh import DATA_AXIS

        return self.mesh.axis(DATA_AXIS)

    def _gather(self, outs: tuple, readback: "list | None" = None) -> tuple:
        """This rank's block of every output read back to the host, then
        every shard's blocks all-gathered over the data axis, in shard
        order. `readback` accumulates [seconds, rows] of this rank's own
        copies (the shard-skew gauge)."""
        from ..parallel import collectives as C

        t0 = time.perf_counter()
        mine = [o.cpu().numpy() for o in outs]
        if readback is not None:
            readback[0] += time.perf_counter() - t0
            readback[1] += int(mine[0].shape[0]) if mine else 0
        return tuple(C.all_gather_rows(mine, self._data_axis()))

    # -- execution ------------------------------------------------------ #

    def check_ready(self, table: Table) -> str:
        """'' when this table can run fused, else the blocking reason."""
        if table.num_rows == 0:
            return "empty batch (padding has no row to repeat)"
        for c in self.upload_cols:
            if c not in table:
                return f"input column {c!r} missing"
            col = table[c]
            if not isinstance(col, np.ndarray) or col.dtype == object:
                return f"input column {c!r} is not a dense ndarray"
        produced: set[str] = set()
        for k in self.kernels:
            # a `ready` precondition is a check on HOST inputs; once any of
            # the kernel's inputs is a device intermediate produced earlier
            # in the segment, its dtype/layout is fixed by the upstream
            # kernel's contract and there is no host column to inspect
            if k.ready is not None and produced.isdisjoint(k.input_cols):
                ok = k.ready(table)
                if ok is not True and ok is not None:
                    return str(ok)
            produced.update(k.output_cols)
        return ""

    def check_ready_values(self, cols: dict) -> str:
        """'' when these host input VALUES can run fused, else the blocking
        reason.  The cheap per-batch complement of `check_ready` for a
        serving hot path that validated schema/shape ONCE at warmup: only
        each kernel's `ready_values` hook runs (vectorized, no Table
        construction); a kernel with a value-dependent `ready` but no hook
        falls back to its full check so no precondition is skipped."""
        produced: set[str] = set()
        table = None
        for k in self.kernels:
            if produced.isdisjoint(k.input_cols):
                if k.ready_values is not None:
                    ok = k.ready_values(cols)
                    if ok is not True and ok is not None:
                        return str(ok)
                elif k.ready is not None:
                    if table is None:
                        table = Table(dict(cols))
                    ok = k.ready(table)
                    if ok is not True and ok is not None:
                        return str(ok)
            produced.update(k.output_cols)
        return ""

    def run_host(self, table: Table) -> Table:
        for p in self.plans:
            table = p.stage.transform(table)
        return table

    def run(self, table: Table, *, mini_batch_size: int, prefetch_depth: int,
            shape_buckets: bool, tracer: Any, fused_label: str = "pipeline",
            readback_lag: int = 1,
            pipeline_depth: "int | None" = None) -> tuple[Table, dict]:
        n = table.num_rows
        params = self._build()
        bs = max(int(mini_batch_size), 1)
        mesh = self.mesh
        if mesh is None:
            mesh_label, d, shardings = "1", 1, None
        else:
            from ..parallel.mesh import DATA_AXIS, mesh_shape_label

            mesh_label = mesh_shape_label(mesh)
            d = int(mesh.shape.get(DATA_AXIS, 1))
            # every shard gets equal rows: chunk size (and therefore every
            # full chunk) must divide evenly over the data axis
            bs = -(-bs // d) * d
            shardings = {c: mesh for c in self.upload_cols}
        # The ladder must depend only on mini_batch_size, never on the row
        # count of THIS table: an n-derived max would mint n-specific bucket
        # shapes for small tables and recapture in steady state. Under a
        # mesh the ladder is skew-aware (`shards=d`): every rung splits
        # into d equal blocks.
        bucketer = ShapeBucketer(bs, shards=d) if shape_buckets else None
        ins = {c: np.asarray(table[c]) for c in self.upload_cols}
        family = self._family_key(ins)
        stats = {
            "kind": "fused", "segment": self.index,
            "stages": list(self.stage_names), "rows": n,
            "mesh_shape": mesh_label,
            "uploads": 0, "downloads": 0,
            "prepare_seconds": 0.0, "fetch_seconds": 0.0,
            "pad_seconds": 0.0, "h2d_seconds": 0.0,
            "dispatch_seconds": 0.0, "wait_seconds": 0.0,
            "rows_real": 0, "rows_padded": 0,
            "ready_on_fetch": 0, "fetched": 0,
        }
        if mesh is not None:
            stats["param_placements"] = list(self._param_placements)
            if self.eager_collectives:
                stats["eager"] = "collectives in its body"
        # [seconds, rows] of this rank's own readback copies
        readback_acc = [0.0, 0]

        def prepare(start: int):
            stop = min(start + bs, n)
            m = stop - start
            target = bucketer.bucket_for(m) if bucketer is not None else bs
            cols = {}
            t_pad = 0.0
            for c in self.upload_cols:
                chunk = ins[c][start:stop]
                if target > m:
                    t0 = time.perf_counter()
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], target - m, axis=0)])
                    t_pad += time.perf_counter() - t0
                cols[c] = chunk
            stats["pad_seconds"] += t_pad
            stats["rows_real"] += m
            stats["rows_padded"] += target - m
            if bucketer is not None and target > m:
                bucketer.note_pad(m, target)
            # one upload per input column; under a mesh only this rank's
            # block of the chunk's rows
            t0 = time.perf_counter()
            dt = DeviceTable.from_host(cols, shardings=shardings, device=self.device)
            stats["h2d_seconds"] += time.perf_counter() - t0
            stats["uploads"] += len(self.upload_cols)
            return dt, m, target

        def fetch(item):
            outs, m = item
            # dispatch-overlap gauge: a batch whose device results are
            # already complete when the host comes to fetch it had its
            # compute fully hidden behind pipeline work
            stats["fetched"] += 1
            if _is_ready(outs):
                stats["ready_on_fetch"] += 1
            # block on the whole output first: the wait is device compute
            # (wait_seconds), the copies below readback bandwidth only
            t0 = time.perf_counter()
            _block_ready(outs)
            stats["wait_seconds"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            if mesh is None:
                host = tuple(o[:m].cpu().numpy() for o in outs)
            else:
                host = tuple(a[:m] for a in self._gather(outs, readback_acc))
            stats["fetch_seconds"] += time.perf_counter() - t0
            stats["downloads"] += len(host)
            return host

        prefetch = Prefetcher(range(0, n, bs), prepare,
                              depth=max(int(prefetch_depth), 0),
                              name=f"fused-seg{self.index}")
        # `pipeline_depth` is the bounded dispatch->dispatch window: at
        # most K+1 batches dispatched-but-unfetched, with lag-K readback.
        # None falls back to the readback_lag knob.
        lag = (max(int(readback_lag), 0) if pipeline_depth is None
               else max(int(pipeline_depth), 0))
        readback = AsyncReadback(fetch, lag=lag)
        chunks: list[tuple[np.ndarray, ...]] = []
        t_run0 = time.perf_counter()
        with tracer.start_span("pipeline.fused_segment", segment=self.index,
                               stages=",".join(self.stage_names), rows=n,
                               mesh_shape=mesh_label) as span:
            ledger = _ledger("fused", f"seg{self.index}", span=span,
                             mesh_shape=mesh_label)
            for dt, m, target in prefetch:
                shape_key = (target, tuple(
                    (str(dt[c].dtype), tuple(dt[c].shape[1:]))
                    for c in self.upload_cols))
                args = tuple(dt[c] for c in self.upload_cols)
                # the ExecutableCache entry makes hits/misses/RECOMPILES
                # observable (steady-state recompiles == 0 is the bar); a
                # miss on the card captures the shape's graph
                fn = self._exec_cache.get_or_build(
                    family, shape_key, lambda: self._executable(args))
                ledger.cost((family, shape_key), fn, params, args)
                t0 = time.perf_counter()
                outs = fn(params, args)
                stats["dispatch_seconds"] += time.perf_counter() - t0
                if ledger.armed:
                    with ledger.phase("compute"):
                        _block_ready(outs)
                chunks.extend(readback.push((outs, m)))
            chunks.extend(readback.drain())
        stats["prepare_seconds"] = prefetch.stats["prepare_seconds"]
        stats["overlap_fraction"] = prefetch.overlap_fraction()
        stats["pipeline_depth"] = lag
        stats["dispatch_overlap_fraction"] = (
            stats["ready_on_fetch"] / stats["fetched"]
            if stats["fetched"] else 0.0)
        stats.update(self._exec_cache.stats())
        stats.update(device=str(self.device), graph_captures=self.captures,
                     graph_replays=self.replays)
        per_shard = None
        if mesh is not None:
            from ..parallel import collectives as C

            data = self._data_axis()
            per_shard = C.all_gather_floats(readback_acc, data)
            secs, rows = per_shard[:, 0], per_shard[:, 1]
            if secs.min() >= 1e-3:
                skew = float(secs.max() / secs.min())
            else:
                # copy totals under ~1 ms a shard are timer noise, not
                # imbalance: below that floor the gauge is the per-shard
                # ROW skew the skew-aware ladder controls (the reference's
                # rule)
                skew = float(rows.max() / max(rows.min(), 1.0))
            stats["shard_skew_ratio"] = skew
            _set_shard_skew_gauge(fused_label, mesh_label, skew)
        if ledger.armed:
            host_prep = max(stats["prepare_seconds"] - stats["h2d_seconds"]
                            - stats["pad_seconds"], 0.0)
            ledger.add("prepare", host_prep)
            ledger.add("pad", stats["pad_seconds"])
            ledger.add("h2d", stats["h2d_seconds"])
            ledger.add("dispatch", stats["dispatch_seconds"])
            ledger.add("compute", stats["wait_seconds"])
            ledger.add("d2h", stats["fetch_seconds"])
            ledger.set(dispatch_overlap_fraction=round(
                stats["dispatch_overlap_fraction"], 4))
            ledger.note_pad(stats["rows_real"],
                            stats["rows_real"] + stats["rows_padded"])
            if per_shard is not None:
                for rank, (sec, rows_) in zip(data.ranks, per_shard):
                    ledger.note_shard(f"rank{rank}", float(sec), rows=int(rows_))
            ledger.done(rtt_s=time.perf_counter() - t_run0)

        out = table
        for j, c in enumerate(self.download_cols):
            arr = (np.concatenate([ch[j] for ch in chunks])
                   if len(chunks) > 1 else chunks[0][j])
            kern = self._last_producer[c]
            want = kern.out_dtypes.get(c)
            if want is not None and arr.dtype != np.dtype(want):
                arr = arr.astype(want)
            meta = kern.out_meta.get(c)
            if callable(meta):
                meta = meta(arr)
            out = out.with_column(c, arr, meta=meta)
        return out, stats


# --------------------------------------------------------------------- #
# ResidentExecutor — the persistent serving session over one segment     #
# --------------------------------------------------------------------- #


class ResidentExecutor:
    """A long-lived serving session over a single fused segment.

    `_FusedSegment.run` is built for batch work: every call re-creates a
    Prefetcher, an AsyncReadback, a span, and the family key, and blocks
    until all chunks are back on host.  A serving hot path needs the
    opposite shape: params pinned on the device ONCE at startup, then per
    request batch exactly one upload + replay (`dispatch`) and one
    deferred read-back (`fetch`), so the caller can overlap reply
    serialization of batch N with device compute on batch N+1
    (io_http/serving.py drives this through `AsyncReadback`).

    Values are byte-identical to the staged path: the same composition,
    the same pinned params, the same `out_dtypes` cast on read-back. Each
    dispatch returns fresh output tensors (the graph's own are copied out
    before the next replay can write over them). `round_trips` counts
    upload+readback pairs — one per dispatched batch.

    Under a mesh of several ranks `dispatch` uploads this rank's block of
    the batch and `fetch` gathers every block; with a `lead` (shard 0 of
    a served model) each dispatch and fetch is first announced to the
    following ranks, which do their part of it."""

    def __init__(self, segment: "_FusedSegment", lead: "_MeshLead | None" = None):
        self.segment = segment
        self._lead = lead
        self.upload_cols = segment.upload_cols
        self.download_cols = segment.download_cols
        self._params = segment._build()
        self._shardings = (None if segment.mesh is None
                           else {c: segment.mesh for c in segment.upload_cols})
        self._family_cache: dict[tuple, Any] = {}
        self.dispatches = 0
        self.round_trips = 0
        # dispatch-overlap accounting: fetches whose device results were
        # already complete at fetch entry
        self.fetches = 0
        self.ready_on_fetch = 0

    @property
    def data_axis_size(self) -> int:
        """Every dispatched batch's row count must divide by this (the
        mesh data-axis size; 1 single-device). Serving builds its bucket
        ladder with `multiple_of=` this so padded rungs stay shardable."""
        if self.segment.mesh is None:
            return 1
        from ..parallel.mesh import DATA_AXIS

        return int(self.segment.mesh.shape.get(DATA_AXIS, 1))

    # -- host-side preconditions ---------------------------------------- #

    def check_ready(self, table: Table) -> str:
        """'' when this table can run resident, else the blocking reason
        (same contract as `_FusedSegment.check_ready`)."""
        return self.segment.check_ready(table)

    def check_ready_values(self, cols: dict) -> str:
        """Per-batch VALUE re-check over `{col: ndarray}` host inputs —
        the cheap complement of `check_ready` once schema validation has
        run (serving warmup does it exactly once)."""
        return self.segment.check_ready_values(cols)

    # -- per-batch execution -------------------------------------------- #

    def _signature(self, ins: dict) -> tuple:
        return tuple((c, str(ins[c].dtype), ins[c].shape[1:])
                     for c in self.upload_cols)

    def _family_for(self, ins: dict) -> Any:
        sig = self._signature(ins)
        fam = self._family_cache.get(sig)
        if fam is None:
            fam = self.segment._family_key(ins)
            self._family_cache[sig] = fam
        return fam

    def dispatch(self, cols: dict, ledger: Any = None) -> tuple:
        """Upload one padded batch and replay the resident program.
        Returns the still-in-flight device outputs: the caller is free to
        assemble the next batch before `fetch`ing."""
        if ledger is None:
            ledger = _LEDGER_FALLBACK
        lead = self._lead
        if lead is None:
            return self._dispatch(cols, ledger)
        seq = lead.next_seq()
        with lead.op(_OP_DISPATCH, seq,
                     cols={c: np.asarray(cols[c]) for c in self.upload_cols}):
            outs = self._dispatch(cols, ledger)
        outs.seq = seq
        return outs

    def _dispatch(self, cols: dict, ledger: Any) -> tuple:
        seg = self.segment
        with ledger.phase("prepare"):
            ins = {c: np.asarray(cols[c]) for c in self.upload_cols}
            rows = next(iter(ins.values())).shape[0] if ins else 0
            family = self._family_for(ins)
            shape_key = (rows, self._signature(ins))
        with ledger.phase("h2d"):
            dt = DeviceTable.from_host(ins, shardings=self._shardings, device=seg.device)
        args = tuple(dt[c] for c in self.upload_cols)
        fn = seg._exec_cache.get_or_build(
            family, shape_key, lambda: seg._executable(args))
        ledger.cost((id(self), family, shape_key), fn, self._params, args)
        with ledger.phase("dispatch"):
            outs = fn(self._params, args)
        self.dispatches += 1
        self.round_trips += 1
        return outs

    def fetch(self, outs: tuple, n_valid: int, ledger: Any = None) -> dict:
        """Block on the device results, slice padding off, and apply the
        staged path's host dtype casts — the columns a `transform` of the
        same batch would have produced, bit for bit."""
        if ledger is None:
            ledger = _LEDGER_FALLBACK
        lead = self._lead
        if lead is None:
            return self._fetch(outs, n_valid, ledger)
        with lead.op(_OP_FETCH, outs.seq, n_valid):
            return self._fetch(outs, n_valid, ledger)

    def _fetch(self, outs: tuple, n_valid: int, ledger: Any) -> dict:
        self.fetches += 1
        if _is_ready(outs):
            self.ready_on_fetch += 1
        if ledger.armed:
            with ledger.phase("compute"):
                _block_ready(outs)
        result: dict[str, np.ndarray] = {}
        with ledger.phase("d2h"):
            if self.segment.mesh is None:
                host = tuple(o[:n_valid].cpu().numpy() for o in outs)
            else:
                host = tuple(a[:n_valid] for a in self.segment._gather(outs))
            for j, c in enumerate(self.download_cols):
                arr = host[j]
                kern = self.segment._last_producer[c]
                want = kern.out_dtypes.get(c)
                if want is not None and arr.dtype != np.dtype(want):
                    arr = arr.astype(want)
                result[c] = arr
        return result

    # -- warmup ---------------------------------------------------------- #

    def warm(self, cols: dict, ladder: Sequence[int],
             prefetch_depth: int = 1, readback_lag: int = 1) -> int:
        """Capture and run the resident program once per ladder rung so
        live traffic never pays a capture.  `cols` is a sample batch (>= 1
        row) of the upload columns; each rung's input is built by repeating
        its last row — the same padding live batches use.  Rung assembly
        overlaps the previous rung's device execution (`Prefetcher`) and
        read-backs trail by `readback_lag` (`AsyncReadback`), mirroring the
        hot loop's steady-state schedule.  Returns rungs executed."""
        ins = {c: np.asarray(cols[c]) for c in self.upload_cols}

        def prepare(rung: int):
            padded = {}
            for c, arr in ins.items():
                if rung > len(arr):
                    arr = np.concatenate(
                        [arr, np.repeat(arr[-1:], rung - len(arr), axis=0)])
                padded[c] = arr[:rung]
            return rung, padded

        prefetch = Prefetcher(list(ladder), prepare,
                              depth=max(int(prefetch_depth), 0),
                              name="resident-warm")
        readback = AsyncReadback(lambda item: self.fetch(item[0], item[1]),
                                 lag=max(int(readback_lag), 0))
        n = 0
        for rung, padded in prefetch:
            outs = self.dispatch(padded)
            readback.push((outs, rung))
            n += 1
        readback.drain()
        return n

    def stats(self) -> dict:
        """Executable-cache counters + session round-trip accounting +
        the donation/pipelining gauges serving's info() republishes."""
        out = self.segment._exec_cache.stats()
        out.update(dispatches=self.dispatches, round_trips=self.round_trips,
                   fetches=self.fetches, ready_on_fetch=self.ready_on_fetch,
                   dispatch_overlap_fraction=(
                       self.ready_on_fetch / self.fetches
                       if self.fetches else 0.0),
                   donate_buffers=self.segment.donate,
                   graph_captures=self.segment.captures,
                   graph_replays=self.segment.replays)
        return out


# --------------------------------------------------------------------- #
# FusedPipelineModel                                                    #
# --------------------------------------------------------------------- #


# the control words shard 0 sends its followers: [op, a, b, 0]
_OP_IDLE, _OP_RUN, _OP_DISPATCH, _OP_FETCH, _OP_STOP = range(5)
# a lead idle this long sends an idle word: well inside any process
# group's timeout (RankPool's 120 s, initialize_runtime's 600 s)
_HEARTBEAT_S = 5.0


class _MeshLead:
    """Shard 0's side of a mesh where only shard 0 holds the input (a
    server's request batches, a stream's micro-batches): each fused run
    (`_OP_RUN`, segment index, the upload columns) and each resident
    dispatch (`_OP_DISPATCH`, its number, the padded batch) and fetch
    (`_OP_FETCH`, its number, the valid rows) is announced by a control
    word, then done by every rank together. One lock orders the words, so
    the followers do the ops in the order shard 0 sends them. Idle for
    `_HEARTBEAT_S`, the lead sends an idle word. A failed op marks the lead
    broken: every later op raises. `close` sends the stop word."""

    def __init__(self, mesh: Any):
        self.mesh = mesh
        self.ops = 0
        self._lock = threading.Lock()
        self._closed = False
        self._error: "BaseException | None" = None
        self._seq = itertools.count()
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._beat = threading.Thread(target=self._heartbeat, name="mesh-lead-heartbeat",
                                      daemon=True)
        self._beat.start()

    def next_seq(self) -> int:
        return next(self._seq)

    def _check(self) -> None:
        if self._error is not None:
            raise RuntimeError(f"the mesh lead failed earlier: {self._error!r}") from self._error
        if self._closed:
            raise RuntimeError("the mesh lead is closed: its followers have stopped")

    @contextlib.contextmanager
    def op(self, code: int, a: int = 0, b: int = 0, cols: "dict | None" = None):
        """Announce one op (and broadcast `cols`), then run the caller's
        part of it, all under the lead's lock."""
        from ..parallel import collectives as C

        with self._lock:
            self._check()
            try:
                C.broadcast_word([code, int(a), int(b), 0], self.mesh)
                if cols is not None:
                    C.broadcast_arrays(cols, self.mesh)
                yield
            except BaseException as e:
                self._error = e
                raise
            finally:
                self.ops += 1
                self._last = time.monotonic()

    def _heartbeat(self) -> None:
        from ..parallel import collectives as C

        while not self._stop.wait(_HEARTBEAT_S / 2):
            if time.monotonic() - self._last < _HEARTBEAT_S:
                continue
            with self._lock:
                if self._closed or self._error is not None:
                    return
                try:
                    C.broadcast_word([_OP_IDLE, 0, 0, 0], self.mesh)
                except BaseException as e:  # noqa: BLE001 - the next op raises it
                    self._error = e
                    return
                self._last = time.monotonic()

    def close(self) -> None:
        """Stop the followers (once) and the heartbeat. A broken lead
        sends nothing: its followers fail at the group's timeout."""
        from ..parallel import collectives as C

        self._stop.set()
        with self._lock:
            if not self._closed:
                self._closed = True
                if self._error is None:
                    C.broadcast_word([_OP_STOP, 0, 0, 0], self.mesh)
        if self._beat is not threading.current_thread():
            self._beat.join(timeout=_HEARTBEAT_S)


@register_stage
class FusedPipelineModel(PipelineModel):
    """A PipelineModel whose device-capable stage runs execute as single
    fused device programs.  Behaves exactly like the staged model (same
    columns, dtypes, metadata, values); non-fusable stages run on the host
    path unchanged.  Build with `fuse(model)`."""

    mini_batch_size = Param(
        4096, "rows per fused device dispatch (large tables stream through "
              "the segment in chunks of this size)", ptype=int)
    prefetch_depth = Param(
        2, "chunks prepared/uploaded ahead of device compute (0 = "
           "sequential)", ptype=int)
    shape_buckets = Param(
        True, "pad ragged chunk tails to a pow-2 bucket ladder so the "
              "compiled-shape set stays closed", ptype=bool)
    fused_label = Param(
        "pipeline", "label for the fusion-ratio gauge", ptype=str)
    readback_lag = Param(
        1, "device batches kept in flight before device->host readback is "
           "forced (0 = fetch synchronously after every dispatch); also the "
           "lag of the serving hot path's overlapped reply fetch", ptype=int)
    donate_buffers = Param(
        True, "donate each chunk's device input buffers to the fused "
              "executable (jit donate_argnums on the batch tuple; params "
              "are never donated) so steady-state batches reuse device "
              "memory instead of allocating fresh — identical values, "
              "fewer allocations", ptype=bool)
    pipeline_depth = Param(
        None, "sharded dispatches kept in flight per segment (the bounded "
              "dispatch->dispatch pipeline window: at most this+1 batches "
              "dispatched-but-unfetched, lag-K readback; 0 = fetch "
              "synchronously after every dispatch). None inherits "
              "readback_lag, keeping the pre-pipelining schedule",
        ptype=int)
    use_mesh = Param(
        False, "compile fused segments under the process mesh "
               "(parallel.mesh.get_mesh()) when no explicit mesh was set "
               "via fuse(model, mesh=...) / set_mesh()", ptype=bool)
    device = Param(
        "cuda", "torch device the fused segments run on: cuda (a CUDA "
                "graph a shape) | cpu (the composition eagerly)", ptype=str)

    #: stats from the most recent transform: per-segment timings, transfer
    #: counts, executable-cache counters, fusion ratio
    last_stats: "dict | None" = None
    #: explicit mesh (runtime handle, not serialized state — like a model
    #: bundle, it is re-attached after load via set_mesh)
    mesh: Any = None
    _segments: "list | None" = None
    _segments_key: "tuple | None" = None
    _plan: "FusionPlan | None" = None
    _mesh: Any = None  # the normalized mesh the current segments run on
    _lead: "_MeshLead | None" = None  # set on shard 0 of a served or streamed model

    def plan(self) -> FusionPlan:
        self._ensure_segments()
        return self._plan

    def resident_executor(self) -> "ResidentExecutor | str":
        """A persistent serving session over this model, or the reason one
        cannot exist.  Requires the whole plan to be ONE fused segment —
        any host stage in the chain forces a host materialization between
        device programs, so there is no single resident program to pin
        (`serve_model` falls back to the per-request handler path then)."""
        segments = self._ensure_segments()
        if len(segments) != 1 or not isinstance(segments[0], _FusedSegment):
            fused = sum(1 for s in segments if isinstance(s, _FusedSegment))
            return (f"plan is {len(segments)} segments ({fused} fused) — a "
                    "resident session needs exactly one fused segment")
        return ResidentExecutor(segments[0], lead=self._lead)

    def set_mesh(self, mesh: Any) -> "FusedPipelineModel":
        """Attach (or with None, detach) the mesh fused segments run
        under; segments rebuild on next use. Returns self."""
        self.mesh = mesh
        self._segments = None
        return self

    def _effective_mesh(self) -> Any:
        """The mesh segments actually run on: the explicit one, else
        `get_mesh()` when `use_mesh` is set — normalized to None whenever
        it spans a single rank, so a trivial mesh IS the single-device
        path (same programs, same cache keys)."""
        mesh = self.mesh
        if mesh is None and self.get("use_mesh"):
            from ..parallel.mesh import get_mesh

            mesh = get_mesh()
        if mesh is None:
            return None
        from ..parallel.mesh import mesh_device_count

        return mesh if mesh_device_count(mesh) > 1 else None

    def _ensure_segments(self):
        stages = list(self.get("stages") or [])
        mesh = self._effective_mesh()
        donate = bool(self.get("donate_buffers"))
        device = str(self.get("device"))
        key = (tuple(id(s) for s in stages), mesh, donate, device)
        if self._segments is None or self._segments_key != key:
            self._plan = plan_fusion(stages)
            self._segments = [
                _FusedSegment(i, sp.stages, mesh=mesh, donate=donate, device=device)
                if sp.fused else sp
                for i, sp in enumerate(self._plan.segments)]
            self._segments_key = key
            self._mesh = mesh
        return self._segments

    def describe(self) -> str:
        """The plan text (`FusionPlan.describe`) under this model's mesh,
        donation and pipeline window, with the segments that run eagerly
        (their bodies run collectives) named."""
        eager = []
        for seg in self._ensure_segments():
            if isinstance(seg, _FusedSegment) and seg.mesh is not None:
                seg._build()
                if seg.eager_collectives:
                    eager.append(seg.index)
        depth = self.get("pipeline_depth")
        return self._plan.describe(
            mesh=self._mesh, donate=bool(self.get("donate_buffers")),
            pipeline_depth=self.get("readback_lag") if depth is None else depth,
            eager=eager)

    def _run_options(self) -> dict:
        return {"mini_batch_size": self.get("mini_batch_size"),
                "prefetch_depth": self.get("prefetch_depth"),
                "shape_buckets": self.get("shape_buckets"),
                "fused_label": self.get("fused_label"),
                "readback_lag": self.get("readback_lag"),
                "pipeline_depth": self.get("pipeline_depth")}

    # -- one leading rank, the others following -------------------------- #

    def _open_lead(self) -> "_MeshLead":
        """On shard 0 of this model's mesh of several ranks: lead the
        other ranks, which run `_follow`, through every fused run and
        resident dispatch from now until `_close_lead`."""
        mesh = self._effective_mesh()
        if mesh is None or mesh.shard_index != 0:
            raise ValueError("only shard 0 of a mesh of several ranks leads")
        if self._lead is None:
            self._lead = _MeshLead(mesh)
        return self._lead

    def _close_lead(self) -> None:
        lead, self._lead = self._lead, None
        if lead is not None:
            lead.close()

    def _follow(self) -> dict:
        """On a rank other than shard 0: receive shard 0's control words
        and run this rank's part of each fused run, resident dispatch and
        fetch, until the stop word. Returns the ops done by kind. A word
        that never comes fails at the process group's timeout."""
        from ..parallel import collectives as C

        mesh = self._effective_mesh()
        if mesh is None or mesh.shard_index == 0:
            raise ValueError("only a rank other than shard 0 of a mesh of several ranks follows")
        segments = self._ensure_segments()
        tracer = _get_tracer()
        executor = None
        in_flight: dict[int, tuple] = {}
        done = {"runs": 0, "dispatches": 0, "fetches": 0, "idle": 0}
        while True:
            code, a, b, _ = C.broadcast_word(None, mesh)
            if code == _OP_STOP:
                return done
            if code == _OP_IDLE:
                done["idle"] += 1
            elif code == _OP_RUN:
                cols = C.broadcast_arrays(None, mesh)
                segments[a].run(Table(cols), tracer=tracer, **self._run_options())
                done["runs"] += 1
            elif code == _OP_DISPATCH:
                cols = C.broadcast_arrays(None, mesh)
                if executor is None:
                    executor = self.resident_executor()
                    if isinstance(executor, str):
                        raise RuntimeError(f"shard 0 dispatched, but {executor}")
                in_flight[a] = executor.dispatch(cols)
                done["dispatches"] += 1
            elif code == _OP_FETCH:
                executor.fetch(in_flight.pop(a), b)
                done["fetches"] += 1
            else:
                raise RuntimeError(f"unknown control word {code} from shard 0")

    def _transform(self, table: Table) -> Table:
        segments = self._ensure_segments()
        tracer = _get_tracer()
        mesh_label = "1"
        if self._mesh is not None:
            from ..parallel.mesh import mesh_shape_label

            mesh_label = mesh_shape_label(self._mesh)
        stats: dict[str, Any] = {
            "segments": [], "uploads": 0, "downloads": 0,
            "fusion_ratio": self._plan.fusion_ratio,
            "n_stages": self._plan.n_stages,
            "n_fused_stages": self._plan.n_fused_stages,
            "mesh_shape": mesh_label,
        }
        current = table
        for seg in segments:
            t0 = time.perf_counter()
            if isinstance(seg, _FusedSegment):
                why_not = seg.check_ready(current)
                if why_not:
                    current = seg.run_host(current)
                    seg_stats = {
                        "kind": "host_fallback", "segment": seg.index,
                        "stages": list(seg.stage_names), "reason": why_not,
                        "mesh_shape": "1",  # ran staged on the host path
                    }
                else:
                    lead = self._lead
                    with (lead.op(_OP_RUN, seg.index,
                                  cols={c: np.asarray(current[c]) for c in seg.upload_cols})
                          if lead is not None else contextlib.nullcontext()):
                        current, seg_stats = seg.run(current, tracer=tracer,
                                                     **self._run_options())
                    stats["uploads"] += seg_stats["uploads"]
                    stats["downloads"] += seg_stats["downloads"]
            else:
                for sp in seg.stages:
                    current = sp.stage.transform(current)
                seg_stats = {
                    "kind": "host",
                    "stages": [type(sp.stage).__name__ for sp in seg.stages],
                    "mesh_shape": "1",
                }
            seg_stats["seconds"] = time.perf_counter() - t0
            stats["segments"].append(seg_stats)
        self.last_stats = stats
        _set_fusion_gauge(self.get("fused_label"), stats["fusion_ratio"],
                          mesh_label)
        return current

    def params_to_dict(self) -> dict[str, Any]:
        """Every set Param but `device`: where the segments run is a
        runtime placement, as the reference's `mesh` is, so a saved model
        carries only Params both packages know and loads in either (a
        loaded one runs on "cuda" until told otherwise)."""
        return {k: v for k, v in super().params_to_dict().items() if k != "device"}

    def _load_state(self, state: dict[str, Any]) -> None:
        super()._load_state(state)
        self._segments = None  # rebuild against the loaded stages


def fuse(model: Any, mesh: Any = None, **params: Any) -> FusedPipelineModel:
    """Wrap a PipelineModel (or any Transformer) for whole-pipeline
    fusion.  Idempotent; non-fusable stages keep their staged path, so
    `fuse` never changes results — only where the work runs. `device`
    ("cuda" by default) is where fused segments run. With `mesh` (several
    ranks, every rank calling), fused segments run each rank's block of
    the rows (a 1-rank mesh is the plain single-device path); given a
    FusedPipelineModel, `mesh` is attached to it."""
    if isinstance(model, FusedPipelineModel):
        return model.set_mesh(mesh) if mesh is not None else model
    if isinstance(model, PipelineModel):
        stages = list(model.get("stages") or [])
    elif isinstance(model, Transformer):
        stages = [model]
    else:
        raise TypeError(f"fuse() needs a Transformer, got {type(model).__name__}")
    fm = FusedPipelineModel(stages, **params)
    if mesh is not None:
        fm.set_mesh(mesh)
    return fm


def _on_mesh(*models: Any) -> "FusedPipelineModel | None":
    """The fused model among `models` that runs under a mesh of several
    ranks (its shard 0 leads a server or a stream, the other ranks follow
    it), or None. serve_model, serve_recommender and StreamingQuery split
    their ranks by it."""
    for m in models:
        if isinstance(m, FusedPipelineModel) and m._effective_mesh() is not None:
            return m
    return None


# --------------------------------------------------------------------- #
# observability shims (lazy: observability imports core.pipeline)       #
# --------------------------------------------------------------------- #


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set(self, **kw):
        pass


class _NullTracer:
    def start_span(self, *a, **kw):
        return _NullSpan()


def _get_tracer():
    try:
        from ..observability.tracing import get_tracer

        return get_tracer()
    except Exception:
        return _NullTracer()


class _NullLedgerFallback:
    """The disarmed phase ledger for when observability cannot load: every
    hook a no-op."""

    armed = False

    def phase(self, name):
        return _NullSpan()

    def add(self, name, seconds):
        pass

    def note_pad(self, rows_real, rows_target):
        pass

    def note_shard(self, shard, seconds, rows=None):
        pass

    def cost(self, key, fn, *args, **kwargs):
        return None

    def set(self, **meta):
        pass

    def done(self, rtt_s=None):
        pass


_LEDGER_FALLBACK = _NullLedgerFallback()


def _ledger(kind: str, segment: str, span: Any = None, **meta: Any):
    """A phase ledger from the process-default profiler (the shared
    no-op when it is disarmed), or the local fallback when the
    observability package cannot load."""
    try:
        from ..observability.profiler import get_profiler

        return get_profiler().ledger(kind, segment, span=span, **meta)
    except Exception:
        return _LEDGER_FALLBACK


def _block_ready(outs: Any) -> None:
    """Wait for a dispatch's device results (nothing to wait on for the
    CPU's eager outputs)."""
    event = getattr(outs, "event", None)
    if event is not None:
        event.synchronize()


def _is_ready(outs: Any) -> bool:
    """Non-blocking: True when a dispatch's device results had already
    completed at the moment the host asked — the numerator of the
    dispatch-overlap gauge. CPU outputs count as ready."""
    event = getattr(outs, "event", None)
    return True if event is None else bool(event.query())


def _set_shard_skew_gauge(label: str, mesh_shape: str, ratio: float) -> None:
    try:
        from ..observability.metrics import get_registry

        get_registry().gauge(
            "mmlspark_tpu_shard_skew_ratio",
            "slowest/fastest per-shard wall time within a fused sharded "
            "segment (1.0 = perfectly balanced chips)",
            labels=("pipeline", "mesh_shape")).labels(
                pipeline=label, mesh_shape=mesh_shape).set(ratio)
    except Exception:
        pass


def _set_fusion_gauge(label: str, ratio: float, mesh_shape: str = "1") -> None:
    try:
        from ..observability.metrics import get_registry

        get_registry().gauge(
            "mmlspark_tpu_pipeline_fusion_ratio",
            "fraction of pipeline stages executing inside fused segments",
            labels=("pipeline", "mesh_shape")).labels(
                pipeline=label, mesh_shape=mesh_shape).set(ratio)
    except Exception:
        pass
