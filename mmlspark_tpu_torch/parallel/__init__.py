"""Distribution layer: the mesh as a torch.distributed process group and
its collectives (counterpart of mmlspark_tpu/parallel's mesh and
collectives). Ring and Ulysses attention, tensor and pipeline parallelism
and MoE are not ported yet (ROADMAP.md Queue 1, item 12c)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    initialize_runtime,
    get_mesh,
    set_default_mesh,
    make_mesh,
    split_mesh,
    use_mesh,
    shard_bounds,
    shard_rows,
    local_device_count,
    mesh_device_count,
    mesh_shape_label,
)
from . import collectives
from .launch import RankPool

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "initialize_runtime",
    "get_mesh",
    "set_default_mesh",
    "make_mesh",
    "split_mesh",
    "use_mesh",
    "shard_bounds",
    "shard_rows",
    "local_device_count",
    "mesh_device_count",
    "mesh_shape_label",
    "collectives",
    "RankPool",
]
