"""The scheduling step on one device, over a node mesh, and across processes.

Counterpart of ``crane_scheduler_tpu/parallel``. The reference's
``node_sharding`` and ``replicated_sharding`` have no PyTorch counterpart
(a tensor has no sharding spec); ``node_tiles`` says which rows each tile
of a ``NodeMesh`` holds instead.
"""

from .distributed import (
    global_node_mesh,
    host_local_to_global,
    initialize,
    partition_nodes,
    prepare_from_local_shard,
)
from .mesh import (
    NODE_AXIS,
    NodeMesh,
    make_node_mesh,
    make_placement_mesh,
    mesh_shape,
    node_tiles,
    round_up_to_shards,
)
from .sharded import ShardedScheduleStep, TiledSnapshot
from .step import (
    COMPACT_MAX_PODS,
    PackedFetch,
    PreparedSnapshot,
    ScheduleStep,
    StepResult,
)

__all__ = [
    "COMPACT_MAX_PODS",
    "NODE_AXIS",
    "NodeMesh",
    "PackedFetch",
    "PreparedSnapshot",
    "ScheduleStep",
    "ShardedScheduleStep",
    "StepResult",
    "TiledSnapshot",
    "global_node_mesh",
    "host_local_to_global",
    "initialize",
    "make_node_mesh",
    "make_placement_mesh",
    "mesh_shape",
    "node_tiles",
    "partition_nodes",
    "prepare_from_local_shard",
    "round_up_to_shards",
]
