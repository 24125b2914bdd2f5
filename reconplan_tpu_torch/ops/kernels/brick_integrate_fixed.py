"""K3: fold every frame into a padded list of bricks
(``csrc/brick_integrate_fixed.cu``).

Port of ``_integrate_kernel`` / ``_integrate_bricks``
(``reconplan_tpu/ops/tsdf_brick.py:503-1163``), the fixed-grid form that
the host-compacted path (``integrate_frames_bricked``) and the
brick-sharded path (``parallel.brick``) dispatch. The JAX kernel carries
the shard's global brick-id base and its real-brick count in ``meta[6]``
and ``meta[7]``; here they are the ints ``id_base`` and ``n_real_local``.
Ids at or past ``n_real_local`` are padding (the callers pad with the
scratch row) and are skipped, wherever they stand in the list.
:func:`brick_integrate_fixed` launches the CUDA kernel for CUDA
tensors and calls :func:`brick_integrate_fixed_reference`, its plain
PyTorch version, for CPU tensors. Both sample every in-image voxel; the
TPU kernel's VMEM windows drop the outer voxels of very large footprints,
so the two may differ from it there and only there.

The sdf / weight planes are updated in place (the JAX kernel aliases them
as outputs).

The kernel's grid is one block a position of ``ids``; a block whose id is
padding returns at once (K1's persistent grid and work counter measured
slower here, see the CUDA source). A launch takes at most ``MAX_FRAMES``
frames; longer dispatches are split into launches in frame order, which
folds the same frames in the same order.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from reconplan_tpu_torch.ops.kernels.brick_integrate import (
    BRICK_VOXELS,
    _observe,
    _voxel_world,
)
from reconplan_tpu_torch.ops.kernels.build import (
    FLT,
    INT,
    PTR,
    check_launch,
    check_tensor,
    entry,
    takes_plain,
)
from reconplan_tpu_torch.utils.device import scalar_tensor
from reconplan_tpu_torch.utils.profiling import count

# frames a launch (kMaxFrames in ``csrc/brick_integrate_fixed.cu``)
MAX_FRAMES = 32


def brick_integrate_fixed_reference(sdf_b, weight_b, ids, id_base,
                                    n_real_local, T_w2c, intr, depths,
                                    origin, brick_dims, voxel_size, trunc,
                                    depth_scale, depth_max, max_weight):
    """Plain PyTorch version of the K3 kernel; updates the planes in place.

    Divisors are f32 tensors on the planes' device: PyTorch's CUDA division
    by a Python scalar multiplies by the reciprocal instead, which would
    round differently from the kernel's divide.
    """
    dev = sdf_b.device
    F = depths.shape[0]
    depth_scale = scalar_tensor(depth_scale, dev)
    trunc = scalar_tensor(float(np.float32(trunc)), dev)
    rows = ids.long()
    real = (ids < n_real_local)[:, None]
    sdf = sdf_b.reshape(-1, BRICK_VOXELS)[rows]
    w = weight_b.reshape(-1, BRICK_VOXELS)[rows]
    wx, wy, wz = _voxel_world(ids + id_base, brick_dims, origin, voxel_size)
    P = T_w2c.reshape(F, 16)
    for f in range(F):
        w_obs, tsdf_obs, _ = _observe(P[f], wx, wy, wz, depths[f], intr,
                                      depth_scale, depth_max, trunc)
        w_new = w + w_obs
        sdf_n = (sdf * w + tsdf_obs * w_obs) / torch.clamp(w_new, min=1.0)
        sdf_n = torch.where(w_new > 0, sdf_n, 1.0)
        sdf = torch.where(real, sdf_n, sdf)
        w = torch.where(real, torch.clamp(w_new, max=max_weight), w)
    # padding rows all point at the scratch row and carry its values
    # unchanged, so writing every row back is exact
    sdf_b.view(-1, BRICK_VOXELS).index_copy_(0, rows, sdf)
    weight_b.view(-1, BRICK_VOXELS).index_copy_(0, rows, w)


@functools.cache
def occupancy(device_index):
    """(blocks per SM, threads per block) of the kernel on the card, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; queried once."""
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = entry("brick_integrate_fixed_occupancy", (PTR, PTR))(
            ctypes.byref(blocks), ctypes.byref(threads))
    check_launch("brick_integrate_fixed_occupancy", err)
    return blocks.value, threads.value


def _launch(sdf_b, weight_b, ids, id_base, n_real_local, T_w2c, intr,
            depths, origin, brick_dims, voxel_size, trunc, depth_scale,
            depth_max, max_weight):
    """Launch the kernel, once for each ``MAX_FRAMES`` frames; returns the
    number of launches."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    if not (f32(depth_scale) > 0 and f32(trunc) > 0):
        raise ValueError("depth_scale and trunc must be > 0 (the kernel "
                         "skips divides whose result that makes exact)")
    dev = sdf_b.device
    if dev.type != "cuda":
        raise ValueError(f"brick_integrate_fixed: unsupported device {dev}")
    launch = entry("brick_integrate_fixed_launch",
                   (PTR,) * 3 + (INT,) * 3 + (PTR,) * 3 + (INT,) * 5
                   + (FLT,) * 9 + (PTR,))
    F, Hd, Wd = depths.shape
    _, bh, bw = brick_dims
    M = ids.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    starts = range(0, F, MAX_FRAMES)
    for f0 in starts:
        err = launch(
            sdf_b.data_ptr(), weight_b.data_ptr(), ids.data_ptr(), M,
            int(id_base), int(n_real_local), T_w2c[f0:].data_ptr(),
            origin.data_ptr(), depths[f0:].data_ptr(),
            min(MAX_FRAMES, F - f0), Hd, Wd, bh, bw, f32(voxel_size),
            f32(trunc), *map(f32, intr), f32(depth_scale), f32(depth_max),
            f32(max_weight), stream,
        )
        check_launch("brick_integrate_fixed_launch", err)
    return len(starts)


def brick_integrate_fixed(sdf_b, weight_b, ids, id_base, n_real_local,
                          T_w2c, intr, depths, origin, brick_dims,
                          voxel_size, trunc, depth_scale, depth_max,
                          max_weight):
    """Integrate all ``F`` frames into the bricks ``ids``, in place.

    ``sdf_b``/``weight_b`` (NB_local + 1, 8, 128) f32 are one shard's
    planes (the whole grid when unsharded), ``ids`` (M,) i32 local brick
    ids padded with the scratch row; ``id_base`` (the shard's first global
    brick id) and ``n_real_local`` (its real-brick count) are ints.
    ``T_w2c`` (F, 4, 4) f32, ``intr`` (fx, fy, cx, cy) floats, ``depths``
    (F, Hd, Wd) f32 raw. CUDA tensors launch the K3 kernel, once for each
    ``MAX_FRAMES`` frames (counted in ``kernel.brick_integrate_fixed``),
    which refuses ``depth_scale`` or ``trunc`` <= 0; CPU tensors take the
    plain version.
    """
    dev = sdf_b.device
    NB1 = sdf_b.shape[0]
    M = ids.shape[0]
    F, Hd, Wd = depths.shape
    if not 0 <= n_real_local < NB1:
        raise ValueError(f"n_real_local {n_real_local} outside [0, {NB1})")
    plane = (NB1, 8, 128)
    check_tensor("sdf_b", sdf_b, torch.float32, plane, dev)
    check_tensor("weight_b", weight_b, torch.float32, plane, dev)
    check_tensor("ids", ids, torch.int32, (M,), dev)
    check_tensor("T_w2c", T_w2c, torch.float32, (F, 4, 4), dev)
    check_tensor("depths", depths, torch.float32, (F, Hd, Wd), dev)
    check_tensor("origin", origin, torch.float32, (3,), dev)
    args = (sdf_b, weight_b, ids, id_base, n_real_local, T_w2c, intr,
            depths, origin, brick_dims, voxel_size, trunc, depth_scale,
            depth_max, max_weight)
    if takes_plain("brick_integrate_fixed", dev):
        brick_integrate_fixed_reference(*args)
        return
    count("kernel.brick_integrate_fixed", _launch(*args))
