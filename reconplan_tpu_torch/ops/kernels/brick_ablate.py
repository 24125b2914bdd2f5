"""The ablation arms of K1, depth only (``csrc/brick_ablate.cu``).

Port of the TPU benchmark kernels ``_ablate_kernel`` (K5,
``benchmarks/profile_brick.py:75``) and ``_ablate_kernel2`` (K4,
``benchmarks/profile_brick.py:320``): K1 with one piece switched off or
swapped, so that ``reconplan_tpu_torch.benchmarks.profile_brick`` can time
each piece against the whole. The arms are a depth-only copy of K1's loop
and fold with one piece taken the other way at compile time (see the CUDA
source for what each computes and which TPU arm it
answers):

==============  =========================================  =================
 arm             what changes against K1                    result
==============  =========================================  =================
 full            nothing (depth only)                       equals K1
 no_fbits        every frame for each live brick            its own, exact
 no_gather       d = (z * depth_scale) / depth_scale        its own, exact
 one_row         footprint prologue, d = depth[vmin, ui]    timing only
 rw_only         no frame loop                              planes unchanged
 smem_window     footprint rows staged in a shared tile     equals K1
 no_skips        every divide taken, no exact skip          equals K1
 static_stride   bricks by a fixed stride, no work counter  equals K1
 pr1_full        the first design: one brick a block        equals K1
==============  =========================================  =================

:func:`brick_ablate` launches the CUDA kernel for CUDA tensors and calls
:func:`brick_ablate_reference`, its plain PyTorch version, for CPU
tensors. The planes are updated in place, as by K1. Every arm but
``pr1_full`` runs K1's persistent grid (sized by the arm's own occupancy
query) with a work-counter slot a stream, as K1 does; the counters are the
ablation library's own, so an arm and K1 on two streams share none.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from reconplan_tpu_torch.ops.kernels.brick_integrate import (
    BRICK_VOXELS,
    _depth_obs,
    _project_voxels,
    _voxel_world,
    work_slot,
)
from reconplan_tpu_torch.ops.kernels.build import (
    check_launch,
    check_tensor,
    load_library,
)
from reconplan_tpu_torch.utils.device import scalar_tensor

# the order is the CUDA source's ``Arm`` enum
ARMS = ("full", "no_fbits", "no_gather", "one_row", "rw_only", "smem_window",
        "no_skips", "static_stride", "pr1_full")

# voxel index (sublane z * 128 + y * 16 + x) of each brick corner
_CORNERS = [lz * 128 + ly * 16 + lx
            for lx in (0, 15) for ly in (0, 7) for lz in (0, 7)]


def footprint(pose, wx, wy, wz, intr, Hd, Wd):
    """The 8-corner footprint prologue (``profile_brick.py:414-442``): the
    pixel bounding box of each brick's corner voxels, padded by one pixel
    and clamped to the image. ``wx``/``wy``/``wz`` (M, 1024) from
    ``_voxel_world``. Returns (umin, umax, vmin, vmax), each (M,) i32."""
    fx, fy, cx, cy = intr
    idx = torch.tensor(_CORNERS, device=wx.device)
    px, py, pz = wx[:, idx], wy[:, idx], wz[:, idx]
    r = pose
    xc = r[0] * px + r[1] * py + r[2] * pz + r[3]
    yc = r[4] * px + r[5] * py + r[6] * pz + r[7]
    zc = torch.clamp(r[8] * px + r[9] * py + r[10] * pz + r[11], min=1e-3)
    cu = xc / zc * fx + cx
    cv = yc / zc * fy + cy

    def edge(a, pad, lim):
        return torch.clamp(a.to(torch.int32) + pad, 0, lim - 1)

    return (edge(torch.floor(cu.amin(1)), -1, Wd),
            edge(torch.ceil(cu.amax(1)), 1, Wd),
            edge(torch.floor(cv.amin(1)), -1, Hd),
            edge(torch.ceil(cv.amax(1)), 1, Hd))


def brick_ablate_reference(arm, sdf_b, weight_b, ids, fbits, n_live, T_w2c,
                           intr, depths, origin, brick_dims, voxel_size,
                           trunc, depth_scale, depth_max, max_weight):
    """Plain PyTorch version of the ablation kernel's ``arm``; updates the
    planes in place. ``smem_window`` reads the same depth values as
    ``full`` (its tile is a copy of them), and ``no_skips``,
    ``static_stride`` and ``pr1_full`` compute what ``full`` does another
    way, so all four share ``full``'s body.
    Divisors are f32 tensors on the planes' device, as in
    ``brick_integrate_reference``."""
    if arm not in ARMS:
        raise ValueError(f"unknown ablation arm {arm!r}; arms are {ARMS}")
    dev = sdf_b.device
    M = ids.shape[0]
    F, Hd, Wd = depths.shape
    scale = scalar_tensor(depth_scale, dev)
    trunc = scalar_tensor(float(np.float32(trunc)), dev)
    rows = ids.long()
    live = torch.arange(M, device=dev) < n_live.reshape(())
    sdf = sdf_b.reshape(-1, BRICK_VOXELS)[rows]
    w = weight_b.reshape(-1, BRICK_VOXELS)[rows]
    wx, wy, wz = _voxel_world(ids, brick_dims, origin, voxel_size)
    P = T_w2c.reshape(F, 16)
    for f in range(0 if arm == "rw_only" else F):
        hit = live if arm == "no_fbits" else live & (((fbits >> f) & 1) > 0)
        z, ui, _, in_img, pix = _project_voxels(P[f], wx, wy, wz, intr, Hd,
                                                Wd)
        flat = depths[f].reshape(-1)
        if arm == "no_gather":
            d = z * scale
        elif arm == "one_row":
            vmin = footprint(P[f], wx, wy, wz, intr, Hd, Wd)[2]
            d = flat[(vmin[:, None] * Wd + ui.clamp(0, Wd - 1)).long()]
        else:
            d = flat[pix]
        w_obs, tsdf_obs = _depth_obs(d, z, in_img, scale, depth_max, trunc)
        w_new = w + w_obs
        inv = 1.0 / torch.clamp(w_new, min=1.0)
        sdf_n = (sdf * w + tsdf_obs * w_obs) * inv
        sdf_n = torch.where(w_new > 0, sdf_n, 1.0)
        sdf = torch.where(hit[:, None], sdf_n, sdf)
        w = torch.where(hit[:, None], torch.clamp(w_new, max=max_weight), w)
    # padding rows point at the scratch brick and carry its values
    sdf_b.view(-1, BRICK_VOXELS).index_copy_(0, rows, sdf)
    weight_b.view(-1, BRICK_VOXELS).index_copy_(0, rows, w)


@functools.cache
def occupancy(arm, device_index):
    """(blocks per SM, threads per block) of ``arm``'s kernel on the card,
    with the dynamic shared memory it is launched with; queried once."""
    lib = load_library()
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = lib.brick_ablate_occupancy(
            ARMS.index(arm), ctypes.byref(blocks), ctypes.byref(threads))
    check_launch("brick_ablate_occupancy", err)
    return blocks.value, threads.value


def grid_size(arm, device, max_active):
    """The blocks ``arm`` is launched with: K1's persistent grid (blocks
    per SM x SMs, at most ``max_active``), or ``max_active`` for the first
    design."""
    if arm == "pr1_full":
        return max_active
    blocks, _ = occupancy(arm, device.index or 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(max_active, blocks * sms)


def brick_ablate(arm, sdf_b, weight_b, ids, fbits, n_live, T_w2c, intr,
                 depths, origin, brick_dims, voxel_size, trunc, depth_scale,
                 depth_max, max_weight):
    """Run ablation ``arm`` (one of :data:`ARMS`) over the first
    ``n_live[0]`` of ``ids``, in place. Arguments as
    :func:`~reconplan_tpu_torch.ops.kernels.brick_integrate` without color.
    CUDA tensors launch the kernel (counted per arm in
    ``brick_ablate.launches``); CPU tensors take the plain version."""
    if arm not in ARMS:
        raise ValueError(f"unknown ablation arm {arm!r}; arms are {ARMS}")
    dev = sdf_b.device
    NB1 = sdf_b.shape[0]
    M = ids.shape[0]
    F, Hd, Wd = depths.shape
    if F > 32:
        raise ValueError(f"{F} frames do not fit a 32-bit frame mask")
    plane = (NB1, 8, 128)
    check_tensor("sdf_b", sdf_b, torch.float32, plane, dev)
    check_tensor("weight_b", weight_b, torch.float32, plane, dev)
    check_tensor("ids", ids, torch.int32, (M,), dev)
    check_tensor("fbits", fbits, torch.int32, (M,), dev)
    check_tensor("n_live", n_live, torch.int32, (1,), dev)
    check_tensor("T_w2c", T_w2c, torch.float32, (F, 4, 4), dev)
    check_tensor("depths", depths, torch.float32, (F, Hd, Wd), dev)
    check_tensor("origin", origin, torch.float32, (3,), dev)
    args = (sdf_b, weight_b, ids, fbits, n_live, T_w2c, intr, depths,
            origin, brick_dims, voxel_size, trunc, depth_scale, depth_max,
            max_weight)
    if M == 0:  # nothing to fold, and no launch to count
        return
    if dev.type == "cpu":
        brick_ablate_reference(arm, *args)
        return
    if dev.type != "cuda":
        raise ValueError(f"brick_ablate: unsupported device {dev}")
    if not (float(np.float32(depth_scale)) > 0 and float(np.float32(trunc)) > 0):
        raise ValueError("depth_scale and trunc must be > 0 (the kernel "
                         "skips divides whose result that makes exact)")
    lib = load_library()
    _, bh, bw = brick_dims
    stream = torch.cuda.current_stream(dev)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    err = lib.brick_ablate_launch(
        ARMS.index(arm), sdf_b.data_ptr(), weight_b.data_ptr(),
        ids.data_ptr(), fbits.data_ptr(), n_live.data_ptr(), M,
        work_slot(dev, stream), grid_size(arm, dev, M),
        T_w2c.data_ptr(), origin.data_ptr(), depths.data_ptr(),
        F, Hd, Wd, bh, bw,
        f32(voxel_size), f32(trunc), *map(f32, intr), f32(depth_scale),
        f32(depth_max), f32(max_weight), stream.cuda_stream,
    )
    check_launch("brick_ablate_launch", err)
    brick_ablate.launches[arm] += 1


brick_ablate.launches = dict.fromkeys(ARMS, 0)
