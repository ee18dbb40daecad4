"""The mesh: a torch.distributed process group, one process a shard.

Counterpart of mmlspark_tpu/parallel/mesh.py. The JAX package is one SPMD
program over a `jax.sharding.Mesh` of devices: `shard_map` hands each
device a contiguous block of rows along the "data" axis, in device order,
and its collectives run over that axis. PyTorch's idiom is one process a
shard, as torchrun and DDP run it, so here a mesh is a process group:

- every rank runs the same program on the whole host table and takes the
  contiguous block of padded rows that shard i of `P(DATA)` holds
  (`shard_bounds`);
- every collective is a `torch.distributed` call on the mesh's group
  (parallel/collectives.py);
- a `Mesh` holds the data-axis size, the group, its own table from shard
  index to global rank, and this rank's device. The shard index comes
  from that table, never from the group's rank: `dist.new_group` sorts its
  ranks, and a permuted table is how a mesh mirrors the JAX package's
  device permutations.

With no process group initialized, `get_mesh()` is a one-shard mesh, and a
fit on it equals the fit without a mesh byte for byte (the reference's
`mesh.shape[DATA] == 1` branch). `initialize_runtime` joins the processes.

`make_mesh(n_data, n_model, n_seq)` with a model or sequence axis lays the
ranks out as the JAX package lays out devices: a row-major grid over
(data, model), or (data, seq, model) when n_seq > 1. `mesh.axis(name)` is
the 1-D mesh of the ranks that vary along that axis with this rank, with
its own process group, and the collectives take it as they take a data
mesh (ring and Ulysses attention on the seq axis, tensor parallelism on
the model axis). The sharding objects of the JAX package
(`data_sharding`, `replicated_sharding`, `shard_row_counts`) have no
counterpart: a rank holds its rows as plain tensors.

`make_mesh` and `split_mesh` call `dist.new_group` for a mesh that is not
the whole world in rank order (a grid: for every line of every axis too),
and `new_group` is collective: every rank of the world calls them with the
same arguments, in the same order.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "initialize_runtime",
    "get_mesh",
    "set_default_mesh",
    "use_mesh",
    "make_mesh",
    "split_mesh",
    "shard_bounds",
    "shard_rows",
    "local_device_count",
    "mesh_shape_label",
    "mesh_device_count",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

_lock = threading.Lock()
_default_mesh: "Mesh | None" = None
_tls = threading.local()


class Mesh:
    """A mesh of processes.

    `ranks[i]` is the global rank that holds shard i (on a grid: the ranks
    in row-major grid order); `group` is the process group the collectives
    run on (None: the default group, or no group for a one-shard mesh
    outside torch.distributed); `device` is the torch device this rank
    computes on, or None to leave it to the fit's own `device` option.
    `axis_names` and `axis_sizes` name the grid's axes ("data" alone for a
    data mesh); `lines[name][rank]` is the 1-D mesh along `name` through
    `rank`, which `axis(name)` returns."""

    def __init__(self, ranks: Sequence[int], group=None,
                 device: "torch.device | None" = None,
                 axis_names: Sequence[str] = (DATA_AXIS,),
                 axis_sizes: "Sequence[int] | None" = None,
                 lines: "dict | None" = None):
        self.ranks = tuple(int(r) for r in ranks)
        if len(set(self.ranks)) != len(self.ranks) or not self.ranks:
            raise ValueError(f"a mesh needs distinct ranks, got {self.ranks}")
        self.group = group
        self.device = None if device is None else torch.device(device)
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(n) for n in axis_sizes) if axis_sizes else (len(self.ranks),)
        if int(np.prod(self.axis_sizes)) != len(self.ranks):
            raise ValueError(f"axes {self.axis_sizes} do not hold {len(self.ranks)} ranks")
        self.lines = lines or {}

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def shape(self) -> dict:
        """{"data": shards, "model": 1} for a data mesh, as the JAX
        package's mesh.shape; {axis: size} of a grid or of a 1-D mesh
        along another axis."""
        if self.axis_names == (DATA_AXIS,):
            return {DATA_AXIS: self.size, MODEL_AXIS: 1}
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis(self, name: str) -> "Mesh":
        """The 1-D mesh of the ranks that vary along axis `name` with this
        rank (its shard index is this rank's position on the axis). An
        axis of size 1, or one the mesh lacks, is this rank alone."""
        if self.axis_names == (name,):
            return self
        if name in self.lines:
            me = dist.get_rank() if dist.is_initialized() else self.ranks[0]
            if me not in self.lines[name]:
                raise ValueError(f"rank {me} is not on this mesh's {name!r} axis")
            return self.lines[name][me]
        me = dist.get_rank() if dist.is_initialized() else self.ranks[0]
        return Mesh((me,), None, self.device, (name,))

    @property
    def shard_index(self) -> int:
        """This rank's shard: its place in `ranks` (0 outside any group)."""
        if not dist.is_initialized():
            return 0
        return self.ranks.index(dist.get_rank())

    @property
    def is_member(self) -> bool:
        return not dist.is_initialized() or dist.get_rank() in self.ranks

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)

    def __repr__(self) -> str:
        axes = "" if self.axis_names == (DATA_AXIS,) else \
            f", axes={dict(zip(self.axis_names, self.axis_sizes))}"
        return f"Mesh(ranks={self.ranks}{axes}, device={self.device})"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _default_device() -> "torch.device | None":
    """A rank that owns a card (NCCL) computes on it; otherwise the fit's
    own `device` option decides."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return None


def initialize_runtime(
    coordinator_address: "str | None" = None,
    num_processes: "int | None" = None,
    process_id: "int | None" = None,
    backend: "str | None" = None,
    timeout_s: float = 600.0,
) -> None:
    """Join this process to the others (`dist.init_process_group`).

    The address comes from the argument or `COORDINATOR_ADDRESS`, as the
    JAX package reads it; without either this is a single process and the
    call does nothing. "host:port" means a TCP store there
    (`tcp://host:port`); a full `tcp://` or `file://` URL is taken as it is.
    `num_processes` and `process_id` default to torchrun's `WORLD_SIZE`
    and `RANK`.

    `backend`: "nccl" for card tensors where each rank owns its own card,
    "gloo" for CPU tensors and for ranks that share one card (NCCL refuses
    two ranks on one device). None picks "nccl" where CUDA is available and
    "gloo" where it is not. A failed init raises; nothing switches backends
    behind the caller's back. Under NCCL the rank takes card `LOCAL_RANK`
    (default: process_id modulo the cards). `timeout_s` bounds every
    collective, so a dead rank fails the others instead of hanging them.
    The default mesh is made anew at the next `get_mesh()`, over every
    rank."""
    global _default_mesh
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None:
        return
    with _lock:
        if dist.is_initialized():
            return
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
            torch.cuda.set_device(local)
        url = addr if "://" in addr else f"tcp://{addr}"
        dist.init_process_group(
            backend, init_method=url, world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=timeout_s))
        _default_mesh = None


def _group_for(ranks: tuple):
    """None for one shard (no collective runs on it) and for the whole
    world in any order (the default group), else a new group over `ranks`
    (collective: every rank calls it)."""
    if not dist.is_initialized() or len(ranks) == 1:
        return None
    if sorted(ranks) == list(range(_world())):
        return None
    return dist.new_group(ranks=sorted(ranks))


def make_mesh(
    n_data: "int | None" = None,
    n_model: int = 1,
    n_seq: int = 1,
    ranks: "Sequence[int] | None" = None,
    device: "str | torch.device | None" = None,
) -> Mesh:
    """A mesh over `ranks` (default: the first ranks of the world, in rank
    order). `ranks` in another order permutes which rank holds which shard.
    With n_model or n_seq above 1 the ranks form a row-major grid over
    (data, model), or (data, seq, model) when n_seq > 1, the JAX package's
    axis order, and n_data defaults to the world over the other axes.
    Outside torch.distributed only a one-shard mesh exists. `device`
    (None: the fit's own option, or the card an NCCL rank owns) is checked:
    "cuda" without a card raises RuntimeError."""
    world = _world()
    n_model, n_seq = int(n_model), int(n_seq)
    if n_model < 1 or n_seq < 1:
        raise ValueError(f"axis sizes must be >= 1, got model={n_model} seq={n_seq}")
    inner = n_model * n_seq
    if ranks is None:
        n = world // inner if n_data is None else int(n_data)
        need = n * inner
        if need > world or n < 1:
            raise ValueError(
                f"mesh {n}x{n_seq}x{n_model} needs {max(need, inner)} processes, have {world}")
        ranks = range(need)
    ranks = tuple(int(r) for r in ranks)
    if n_data is not None and len(ranks) != n_data * inner:
        raise ValueError(f"n_data={n_data} x {inner} but {len(ranks)} ranks given")
    if len(ranks) % inner:
        raise ValueError(f"{len(ranks)} ranks do not fill a grid of {n_seq}x{n_model}")
    if any(not 0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} outside the world of {world} processes")
    if device is not None:
        from ..core.kernels import resolve_device

        device = resolve_device(device)
    else:
        device = _default_device()
    if inner == 1:
        return Mesh(ranks, _group_for(ranks), device)
    if n_seq > 1:
        names, sizes = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS), (len(ranks) // inner, n_seq, n_model)
    else:
        names, sizes = (DATA_AXIS, MODEL_AXIS), (len(ranks) // inner, n_model)
    grid = np.asarray(ranks).reshape(sizes)
    lines: dict = {}
    for ax, name in enumerate(names):
        # every rank walks every line in the same order: new_group is collective
        by_rank = {}
        for line in np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax]):
            line = tuple(int(r) for r in line)
            sub = Mesh(line, _group_for(line), device, (name,))
            for r in line:
                by_rank[r] = sub
        lines[name] = by_rank
    return Mesh(ranks, _group_for(ranks), device, names, sizes, lines)


def get_mesh() -> Mesh:
    """The current mesh: the thread's override (`use_mesh`) if one is
    active, else the process default, made at first use over every rank
    (one shard outside torch.distributed)."""
    override = getattr(_tls, "mesh", None)
    if override is not None:
        return override
    global _default_mesh
    with _lock:
        if _default_mesh is None:
            _default_mesh = make_mesh()
        return _default_mesh


def set_default_mesh(mesh: "Mesh | None") -> None:
    global _default_mesh
    with _lock:
        _default_mesh = mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Thread-local mesh override: stages that consult `get_mesh()` inside
    the block run on `mesh`."""
    prev = getattr(_tls, "mesh", None)
    _tls.mesh = mesh
    try:
        yield mesh
    finally:
        _tls.mesh = prev


def split_mesh(mesh: Mesh, n: int) -> list:
    """The data axis cut into `n` disjoint meshes of consecutive shards,
    each with its own group (every rank of the world calls this)."""
    d = mesh.size
    if n <= 0 or d % n != 0:
        raise ValueError(f"cannot split data axis of size {d} into {n} submeshes")
    per = d // n
    pieces = [mesh.ranks[i * per:(i + 1) * per] for i in range(n)]
    return [Mesh(p, _group_for(p), mesh.device) for p in pieces]


def local_device_count() -> int:
    return torch.cuda.device_count()


def mesh_device_count(mesh: "Mesh | None") -> int:
    """Shards under a mesh; 1 for None (the single-device path)."""
    return 1 if mesh is None else mesh.size


def mesh_shape_label(mesh: "Mesh | None" = None) -> str:
    """'4x1' for a 4-shard data mesh, '1' for no mesh."""
    if mesh is None:
        return "1"
    return "x".join(str(s) for s in mesh.shape.values())


def shard_bounds(n_rows: int, mesh: "Mesh | None" = None) -> tuple:
    """(n_padded, lo, hi): the rows padded up to a multiple of the shards,
    and this rank's block [lo, hi) of them, as `P(DATA)` places it."""
    mesh = mesh or get_mesh()
    d = mesh.size
    n_pad = ((n_rows + d - 1) // d) * d
    per = n_pad // d
    lo = mesh.shard_index * per
    return n_pad, lo, lo + per


def shard_rows(array, mesh: "Mesh | None" = None, pad_value=0,
               device: "str | torch.device | None" = None):
    """This rank's block of a host array's rows as a tensor on `device`
    (default: the mesh's device, else the card), the array padded with
    `pad_value` up to a multiple of the shards first. Returns
    (tensor, original_n_rows)."""
    from ..core.kernels import resolve_device

    mesh = mesh or get_mesh()
    arr = np.asarray(array)
    n = arr.shape[0]
    n_pad, lo, hi = shard_bounds(n, mesh)
    if n_pad != n:
        pad_width = [(0, n_pad - n)] + [(0, 0)] * (arr.ndim - 1)
        arr = np.pad(arr, pad_width, constant_values=pad_value)
    dev = device if device is not None else (mesh.device or "cuda")
    return torch.as_tensor(np.ascontiguousarray(arr[lo:hi]), device=resolve_device(dev)), n
