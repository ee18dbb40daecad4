"""Distribution layer: the mesh as torch.distributed process groups, its
collectives, and the parallel layers on it (counterpart of
mmlspark_tpu/parallel): the data, model and sequence axes, the elastic
fit's shard math (`dp`), ring and Ulysses attention, tensor and pipeline
parallelism, and mixture-of-experts dispatch."""

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
from . import dp
from .launch import RankPool
from .ring_attention import (
    dense_attention,
    ring_attention,
    ulysses_attention,
    make_ring_attention,
    make_ulysses_attention,
)
from .tensor_parallel import (
    column_parallel,
    row_parallel,
    ring_all_gather,
    gathered_column_parallel,
    column_block,
    dense_column_blocks,
    make_tp_mlp,
)
from .pipeline_parallel import PIPE_AXIS, make_pipe_mesh, pipeline_apply, pipeline_forward
from .moe import EXPERT_AXIS, MoEParams, init_moe, moe_ffn_local, moe_ffn_sharded

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
    "dp",
    "RankPool",
    "dense_attention",
    "ring_attention",
    "ulysses_attention",
    "make_ring_attention",
    "make_ulysses_attention",
    "column_parallel",
    "row_parallel",
    "ring_all_gather",
    "gathered_column_parallel",
    "column_block",
    "dense_column_blocks",
    "make_tp_mlp",
    "PIPE_AXIS",
    "make_pipe_mesh",
    "pipeline_apply",
    "pipeline_forward",
    "EXPERT_AXIS",
    "MoEParams",
    "init_moe",
    "moe_ffn_local",
    "moe_ffn_sharded",
]
