"""Multi-device fusion and IK over a device mesh.

Port of ``reconplan_tpu.parallel``: a mesh of torch devices, in one
process or across the ranks of a ``torch.distributed`` process group
(``parallel.mesh``); the dense grid cut into z-slabs
(``parallel.fusion``); IK batches split over the shards
(``parallel.ik``); the brick grid cut along the brick axis
(``parallel.brick``). Several shards may share one device and then run
in turn. Nothing is exchanged while integrating; the gathers all-gather
under a group.
"""

from reconplan_tpu_torch.parallel.brick import (
    ShardedBrickGrid,
    gather_brick_grid,
    make_sharded_brick_grid,
    sharded_brick_grid_from_numpy,
    sharded_brick_grid_to_numpy,
    sharded_integrate_frames_bricked,
)
from reconplan_tpu_torch.parallel.fusion import (
    ShardedTSDFGrid,
    gather_grid,
    make_sharded_grid,
    sharded_grid_from_numpy,
    sharded_grid_to_numpy,
    sharded_integrate_frames,
)
from reconplan_tpu_torch.parallel.ik import sharded_ik_solve
from reconplan_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    shard_grid,
)

__all__ = [
    "make_mesh",
    "shard_grid",
    "replicate",
    "sharded_integrate_frames",
    "make_sharded_grid",
    "gather_grid",
    "sharded_ik_solve",
    "Mesh",
    "ShardedTSDFGrid",
    "sharded_grid_from_numpy",
    "sharded_grid_to_numpy",
    "ShardedBrickGrid",
    "gather_brick_grid",
    "make_sharded_brick_grid",
    "sharded_brick_grid_from_numpy",
    "sharded_brick_grid_to_numpy",
    "sharded_integrate_frames_bricked",
]
