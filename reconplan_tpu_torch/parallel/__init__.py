"""Brick-sharded TSDF fusion over a list of devices.

Port of the brick half of ``reconplan_tpu.parallel`` (``parallel/brick.py``).
A list of devices takes the place of the JAX mesh: one shard per entry,
repeats allowed (every shard on ``cuda:0`` on one card, on ``cpu`` on the
CPU). There is no process group: the shards run in turn from one process.
"""

from reconplan_tpu_torch.parallel.brick import (
    ShardedBrickGrid,
    gather_brick_grid,
    make_sharded_brick_grid,
    sharded_brick_grid_from_numpy,
    sharded_brick_grid_to_numpy,
    sharded_integrate_frames_bricked,
)

__all__ = [
    "ShardedBrickGrid",
    "gather_brick_grid",
    "make_sharded_brick_grid",
    "sharded_brick_grid_from_numpy",
    "sharded_brick_grid_to_numpy",
    "sharded_integrate_frames_bricked",
]
