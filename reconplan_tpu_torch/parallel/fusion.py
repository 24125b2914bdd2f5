"""Spatially sharded dense TSDF fusion over a device mesh.

Port of ``reconplan_tpu.parallel.fusion``. The grid splits along z into
equal slabs, one a shard of the mesh, and never moves; the frames are
replicated onto every shard's device. Each shard sweeps its slab with
``ops.tsdf.integrate_slab``, which keeps the whole grid's z-chunks and
indexes voxels by their global row, so the gathered grid equals the one
grid of ``ops.tsdf.integrate_frames`` bit for bit (the JAX package gets
that from GSPMD computing the global iota on every shard). Nothing is
exchanged while integrating; :func:`gather_grid` all-gathers the slabs
under a process group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reconplan_tpu_torch.ops import tsdf as tsdf_ops
from reconplan_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    check_mesh,
    make_mesh,
    replicate,
    shard_grid,
)


class ShardedTSDFGrid(NamedTuple):
    """A dense grid in z-slabs: ``slabs[i]`` is local shard ``i``'s rows
    as a ``TSDFGrid`` on its device, with the whole grid's origin, voxel
    size and trunc. A colorless grid's slabs keep ``make_grid``'s empty
    color."""

    slabs: tuple
    mesh: Mesh

    @property
    def shape(self):
        D, H, W = self.slabs[0].shape
        return (D * self.mesh.size, H, W)

    @property
    def has_color(self):
        return self.slabs[0].has_color


def make_sharded_grid(dims, origin, voxel_size, mesh=None, trunc=None,
                      with_color=False) -> ShardedTSDFGrid:
    """An empty grid cut along z over ``mesh`` (default: ``make_mesh()``).
    Raises when the grid's depth does not divide by the mesh size."""
    mesh = mesh or make_mesh()
    D, H, W = dims
    if D % mesh.size:
        raise ValueError(f"grid depth {D} is not divisible by the mesh "
                         f"size {mesh.size}")
    return ShardedTSDFGrid(tuple(
        tsdf_ops.make_grid((D // mesh.size, H, W), origin, voxel_size, trunc,
                           with_color, device=d) for d in mesh.devices), mesh)


def sharded_integrate_frames(grid, depths, poses, fx, fy, cx, cy, mesh=None,
                             colors=None, **kwargs) -> ShardedTSDFGrid:
    """Integrate frames into a z-sharded grid: the frames go once to each
    distinct device, and every shard sweeps its slab in turn. ``mesh``
    may name the grid's mesh again; ``kwargs`` are
    :func:`ops.tsdf.integrate_frames`' (``depth_scale``, ``depth_max``,
    ``max_weight``). Returns the new grid."""
    check_mesh(grid, mesh)
    mesh = grid.mesh
    rep = replicate(mesh)
    f32 = dict(dtype=torch.float32)
    depths = rep.put(torch.as_tensor(depths, **f32))
    poses = rep.put(torch.as_tensor(poses, **f32))
    colors = (rep.put(torch.as_tensor(colors, **f32)) if colors is not None
              else (None,) * len(mesh.devices))
    D = grid.shape[0]
    Dl = D // mesh.size
    return grid._replace(slabs=tuple(
        tsdf_ops.integrate_slab(slab, (mesh.first_shard + i) * Dl, D,
                                depths[i], poses[i], fx, fy, cx, cy,
                                colors=colors[i], **kwargs)
        for i, slab in enumerate(grid.slabs)))


def gather_grid(grid) -> tsdf_ops.TSDFGrid:
    """The whole grid as one ``TSDFGrid`` on the first shard's device
    (for extraction); under a process group every rank gets it."""
    first = grid.slabs[0]
    dev = first.sdf.device

    def cat(field):
        return all_gather(grid.mesh, torch.cat(
            [getattr(s, field).to(dev) for s in grid.slabs]))

    return first._replace(
        sdf=cat("sdf"), weight=cat("weight"),
        color=cat("color") if grid.has_color else first.color)


def sharded_grid_from_numpy(sdf, weight, color, origin, voxel_size, trunc,
                            mesh=None) -> ShardedTSDFGrid:
    """A z-sharded grid from numpy fields in the layout ``np.asarray``
    gives for a JAX sharded ``TSDFGrid`` field by field (whole volumes;
    ``color`` (0, 0, 0, 3) when colorless), over ``mesh`` (default:
    ``make_mesh()``); this rank keeps its shards' rows."""
    mesh = mesh or make_mesh()
    whole = tsdf_ops.tsdf_grid_from_numpy(sdf, weight, color, origin,
                                          voxel_size, trunc, device="cpu")
    vol, rep = shard_grid(mesh, mesh.axis_name), replicate(mesh)
    fields = [vol.put(whole.sdf), vol.put(whole.weight),
              (vol if whole.has_color else rep).put(whole.color)]
    fields += [rep.put(x) for x in whole[3:]]
    return ShardedTSDFGrid(
        tuple(tsdf_ops.TSDFGrid(*f) for f in zip(*fields)), mesh)


def sharded_grid_to_numpy(grid) -> dict:
    """The grid's fields as numpy in that layout, keyed as
    :func:`sharded_grid_from_numpy` takes them."""
    return tsdf_ops.tsdf_grid_to_numpy(gather_grid(grid))
