"""Brick-sharded TSDF fusion over a device mesh.

Port of ``reconplan_tpu.parallel.brick``. The brick axis is the parallel
axis of the sparse engine: shard ``s`` of the mesh owns the contiguous
brick range ``[s * nb_local, (s + 1) * nb_local)`` as planes of its own,
``(nb_local + 1, 8, 128)`` with a scratch row, on its device; frames
replicate. Each shard computes the global active mask over all frames,
takes its slice, compacts it on its device to ``max_active_per_device``
ids padded with its scratch row (no host read), and launches K3 with its
global id base. Nothing is exchanged during integration but the active
count (all-reduced under a process group); :func:`gather_brick_grid`
concatenates the shards for extraction, all-gathering them under a
group. A process runs its own shards in turn.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.ops.kernels.brick_integrate_fixed import (
    brick_integrate_fixed,
)
from reconplan_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_sum,
    check_mesh,
    make_mesh,
    shard_grid,
)

_ROW = (tb.BRICK_Z, tb.BRICK_Y * tb.BRICK_X)


class ShardedBrickGrid(NamedTuple):
    """A brick grid cut along the brick axis into equal shards, each with
    its own scratch row."""

    sdf: tuple  # per local shard (nb_local + 1, 8, 128) f32 on its device
    weight: tuple  # per local shard (nb_local + 1, 8, 128) f32 on its device
    dims: tuple  # (D, H, W) logical voxels
    origin: torch.Tensor  # (3,) f32 on the first shard's device
    voxel_size: float
    trunc: float
    mesh: Mesh

    @property
    def brick_dims(self):
        D, H, W = self.dims
        return (D // tb.BRICK_Z, H // tb.BRICK_Y, W // tb.BRICK_X)


def make_sharded_brick_grid(dims, origin, voxel_size, mesh=None,
                            trunc=None):
    """An empty brick grid in ``mesh.size`` shards (default mesh:
    ``make_mesh()``; ``make_mesh(devices=["cpu"] * n)`` asks for CPU
    shards), this process's on their devices. Returns the
    ``(grid, nb_local)`` pair the other functions take."""
    mesh = mesh or make_mesh()
    grid = tb.make_brick_grid(dims, origin, voxel_size, trunc,
                              device=mesh.devices[0])
    nb = grid.sdf.shape[0] - 1
    if nb % mesh.size:
        raise ValueError(f"{nb} bricks not divisible by {mesh.size} "
                         "shards")
    nb_local = nb // mesh.size
    shape = (nb_local + 1,) + _ROW
    return ShardedBrickGrid(
        sdf=tuple(torch.ones(shape, device=d) for d in mesh.devices),
        weight=tuple(torch.zeros(shape, device=d) for d in mesh.devices),
        dims=grid.dims,
        origin=grid.origin,
        voxel_size=grid.voxel_size,
        trunc=grid.trunc,
        mesh=mesh,
    ), nb_local


def sharded_integrate_frames_bricked(
    grid_and_nbl,
    depths,
    poses_cam_to_world,
    fx, fy, cx, cy,
    mesh=None,
    depth_scale=1000.0,
    depth_max=3.0,
    max_weight=64.0,
    max_active_per_device=4096,
):
    """Integrate all frames into a brick-sharded grid, one K3 launch per
    shard, with the shards' planes updated in place.

    The grid carries its mesh; ``mesh`` may name it again and must then
    equal it.

    A shard with more than ``max_active_per_device`` active bricks drops
    its highest-index ones. Returns ``((grid, nb_local), n_active)``,
    ``n_active`` the unclamped total active count over every shard (and
    rank) as a 0-d i32 tensor on the first shard's device.
    """
    grid, nb_local = grid_and_nbl
    check_mesh(grid, mesh)
    s0 = grid.mesh.first_shard
    intr = tuple(float(np.float32(v)) for v in (fx, fy, cx, cy))
    replicated = {}  # device -> (depths, w2c poses, origin, global mask)
    counts = []
    for s, (sdf_l, w_l) in enumerate(zip(grid.sdf, grid.weight)):
        dev = sdf_l.device
        if dev not in replicated:
            d = torch.as_tensor(depths, dtype=torch.float32,
                                device=dev).contiguous()
            T = torch.linalg.inv(torch.as_tensor(
                poses_cam_to_world, dtype=torch.float32,
                device=dev)).contiguous()
            origin = grid.origin.to(dev)
            mask = tb.active_brick_mask(
                grid.brick_dims, origin, grid.voxel_size, grid.trunc, d, T,
                *intr, depth_scale, depth_max)
            replicated[dev] = (d, T, origin, mask)
        d, T, origin, mask = replicated[dev]
        base = (s0 + s) * nb_local
        mask_local = mask[base:base + nb_local]
        ids = tb.compact_ids(mask_local, max_active_per_device, nb_local)
        counts.append(mask_local.sum().to(torch.int32))
        brick_integrate_fixed(
            sdf_l, w_l, ids, base, nb_local, T, intr, d, origin,
            grid.brick_dims, grid.voxel_size, grid.trunc, depth_scale,
            depth_max, max_weight)
    first = grid.mesh.devices[0]
    n_active = all_sum(grid.mesh,
                       torch.stack([c.to(first) for c in counts]).sum())
    return (grid, nb_local), n_active


def gather_brick_grid(grid_and_nbl, mesh=None) -> tb.BrickGrid:
    """Collect a brick-sharded grid into one ``BrickGrid`` with a single
    scratch row on the first shard's device, for extraction (on every
    rank under a process group). ``mesh`` as in
    :func:`sharded_integrate_frames_bricked`."""
    grid, _ = grid_and_nbl
    check_mesh(grid, mesh)
    dev = grid.mesh.devices[0]

    def strip(planes, pad_value):
        pad = torch.full((1,) + _ROW, pad_value, dtype=torch.float32,
                         device=dev)
        body = torch.cat([p[:-1].to(dev) for p in planes])
        return torch.cat([all_gather(grid.mesh, body), pad])

    return tb.BrickGrid(
        sdf=strip(grid.sdf, 1.0),
        weight=strip(grid.weight, 0.0),
        dims=grid.dims,
        origin=grid.origin,
        voxel_size=grid.voxel_size,
        trunc=grid.trunc,
    )


def sharded_brick_grid_from_numpy(sdf, weight, dims, origin, voxel_size,
                                  trunc, mesh):
    """A sharded grid from numpy planes in the JAX sharded layout
    ``(n_shards * (nb_local + 1), 8, 128)`` (a JAX sharded ``BrickGrid``
    taken with ``np.asarray`` field by field), one shard a shard of
    ``mesh``; this rank keeps its own. Returns ``(grid, nb_local)``."""
    planes = shard_grid(mesh, mesh.axis_name)

    def split(a):
        return planes.put(torch.as_tensor(np.array(a, np.float32)))

    return ShardedBrickGrid(
        sdf=split(sdf),
        weight=split(weight),
        dims=tuple(int(v) for v in dims),
        origin=torch.as_tensor(np.array(origin, np.float32),
                               device=mesh.devices[0]),
        voxel_size=float(voxel_size),
        trunc=float(trunc),
        mesh=mesh,
    ), len(sdf) // mesh.size - 1


def sharded_brick_grid_to_numpy(grid_and_nbl) -> dict:
    """The sharded grid's fields as numpy, its planes (every rank's under
    a process group) in the JAX sharded layout, keyed as
    :func:`sharded_brick_grid_from_numpy` takes them (``mesh`` aside)."""
    grid, _ = grid_and_nbl
    dev = grid.mesh.devices[0]

    def cat(planes):
        return all_gather(grid.mesh, torch.cat(
            [p.to(dev) for p in planes])).cpu().numpy()

    return {
        "sdf": cat(grid.sdf),
        "weight": cat(grid.weight),
        "dims": tuple(grid.dims),
        "origin": grid.origin.cpu().numpy(),
        "voxel_size": grid.voxel_size,
        "trunc": grid.trunc,
    }
