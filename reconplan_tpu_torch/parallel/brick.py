"""Brick-sharded TSDF fusion over a list of devices.

Port of ``reconplan_tpu.parallel.brick``. The brick axis is the parallel
axis of the sparse engine: shard ``s`` owns the contiguous brick range
``[s * nb_local, (s + 1) * nb_local)`` as planes of its own,
``(nb_local + 1, 8, 128)`` with a scratch row, on ``devices[s]``; frames
replicate. Each shard computes the global active mask over all frames,
takes its slice, compacts it on its device to ``max_active_per_device``
ids padded with its scratch row (no host read), and launches K3 with its
global id base. Nothing is exchanged during integration;
:func:`gather_brick_grid` concatenates the shards for extraction.

A list of devices takes the place of the JAX mesh, one entry per shard
(repeats allowed: every shard on ``cuda:0`` on one card). The shards run
in turn from one process; there is no process group.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.ops.kernels.brick_integrate_fixed import (
    brick_integrate_fixed,
)
from reconplan_tpu_torch.utils.device import resolve_device

_ROW = (tb.BRICK_Z, tb.BRICK_Y * tb.BRICK_X)


class ShardedBrickGrid(NamedTuple):
    """A brick grid cut along the brick axis into equal shards, each with
    its own scratch row."""

    sdf: tuple  # per shard (nb_local + 1, 8, 128) f32 on its device
    weight: tuple  # per shard (nb_local + 1, 8, 128) f32 on its device
    dims: tuple  # (D, H, W) logical voxels
    origin: torch.Tensor  # (3,) f32 on the first shard's device
    voxel_size: float
    trunc: float

    @property
    def brick_dims(self):
        D, H, W = self.dims
        return (D // tb.BRICK_Z, H // tb.BRICK_Y, W // tb.BRICK_X)

    @property
    def devices(self):
        return tuple(a.device for a in self.sdf)


def _default_devices():
    """One shard per CUDA card; raises when there is none."""
    resolve_device(None)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_sharded_brick_grid(dims, origin, voxel_size, devices=None,
                            trunc=None):
    """An empty brick grid in ``len(devices)`` shards (default: one shard
    per card; ``["cpu"] * n`` asks for CPU shards). Returns the
    ``(grid, nb_local)`` pair the other functions take."""
    devices = [resolve_device(d) for d in (devices or _default_devices())]
    grid = tb.make_brick_grid(dims, origin, voxel_size, trunc,
                              device=devices[0])
    nb = grid.sdf.shape[0] - 1
    if nb % len(devices):
        raise ValueError(f"{nb} bricks not divisible by {len(devices)} "
                         "shards")
    nb_local = nb // len(devices)
    shape = (nb_local + 1,) + _ROW
    return ShardedBrickGrid(
        sdf=tuple(torch.ones(shape, device=d) for d in devices),
        weight=tuple(torch.zeros(shape, device=d) for d in devices),
        dims=grid.dims,
        origin=grid.origin.to(devices[0]),
        voxel_size=grid.voxel_size,
        trunc=grid.trunc,
    ), nb_local


def sharded_integrate_frames_bricked(
    grid_and_nbl,
    depths,
    poses_cam_to_world,
    fx, fy, cx, cy,
    devices=None,
    depth_scale=1000.0,
    depth_max=3.0,
    max_weight=64.0,
    max_active_per_device=4096,
):
    """Integrate all frames into a brick-sharded grid, one K3 launch per
    shard, with the shards' planes updated in place.

    The grid carries the devices of its shards; ``devices`` (the JAX
    function's ``mesh``) may name them again and must then equal them.

    A shard with more than ``max_active_per_device`` active bricks drops
    its highest-index ones. Returns ``((grid, nb_local), n_active)``,
    ``n_active`` the unclamped total active count as a 0-d i32 tensor on
    the first shard's device.
    """
    grid, nb_local = grid_and_nbl
    _check_devices(grid, devices)
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
        base = s * nb_local
        mask_local = mask[base:base + nb_local]
        ids = tb.compact_ids(mask_local, max_active_per_device, nb_local)
        counts.append(mask_local.sum().to(torch.int32))
        brick_integrate_fixed(
            sdf_l, w_l, ids, base, nb_local, T, intr, d, origin,
            grid.brick_dims, grid.voxel_size, grid.trunc, depth_scale,
            depth_max, max_weight)
    first = grid.devices[0]
    n_active = torch.stack([c.to(first) for c in counts]).sum()
    return (grid, nb_local), n_active


def _check_devices(grid, devices):
    """Raise if ``devices`` is given and is not the list the sharded
    ``grid`` was made on."""
    if devices is not None and [resolve_device(d) for d in devices] != list(
            grid.devices):
        raise ValueError(f"devices {list(devices)} are not the grid's "
                         f"{list(grid.devices)}")


def gather_brick_grid(grid_and_nbl, devices=None,
                      device=None) -> tb.BrickGrid:
    """Collect a brick-sharded grid into one ``BrickGrid`` with a single
    scratch row, on ``device`` (default: the first shard's), for
    extraction. ``devices`` as in
    :func:`sharded_integrate_frames_bricked`."""
    grid, _ = grid_and_nbl
    _check_devices(grid, devices)
    dev = resolve_device(device) if device is not None else grid.devices[0]

    def strip(planes, pad_value):
        pad = torch.full((1,) + _ROW, pad_value, dtype=torch.float32,
                         device=dev)
        return torch.cat([p[:-1].to(dev) for p in planes] + [pad])

    return tb.BrickGrid(
        sdf=strip(grid.sdf, 1.0),
        weight=strip(grid.weight, 0.0),
        dims=grid.dims,
        origin=grid.origin.to(dev),
        voxel_size=grid.voxel_size,
        trunc=grid.trunc,
    )


def sharded_brick_grid_from_numpy(sdf, weight, dims, origin, voxel_size,
                                  trunc, devices):
    """A sharded grid from numpy planes in the JAX sharded layout
    ``(n_shards * (nb_local + 1), 8, 128)`` (a JAX sharded ``BrickGrid``
    taken with ``np.asarray`` field by field), one shard per entry of
    ``devices``. Returns ``(grid, nb_local)``."""
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    sdf, weight = np.asarray(sdf), np.asarray(weight)
    if sdf.shape[0] % n:
        raise ValueError(f"{sdf.shape[0]} rows not divisible by {n} shards")

    def split(a):
        return tuple(torch.as_tensor(np.array(p), dtype=torch.float32,
                                     device=d)
                     for p, d in zip(np.split(a, n), devices))

    return ShardedBrickGrid(
        sdf=split(sdf),
        weight=split(weight),
        dims=tuple(int(v) for v in dims),
        origin=torch.as_tensor(np.array(origin, np.float32),
                               device=devices[0]),
        voxel_size=float(voxel_size),
        trunc=float(trunc),
    ), sdf.shape[0] // n - 1


def sharded_brick_grid_to_numpy(grid_and_nbl) -> dict:
    """The sharded grid's fields as numpy, its planes in the JAX sharded
    layout, keyed as :func:`sharded_brick_grid_from_numpy` takes them
    (``devices`` aside)."""
    grid, _ = grid_and_nbl

    def cat(planes):
        return np.concatenate([p.cpu().numpy() for p in planes])

    return {
        "sdf": cat(grid.sdf),
        "weight": cat(grid.weight),
        "dims": tuple(grid.dims),
        "origin": grid.origin.cpu().numpy(),
        "voxel_size": grid.voxel_size,
        "trunc": grid.trunc,
    }
