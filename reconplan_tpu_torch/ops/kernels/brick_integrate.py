"""K1: fold a frame chunk into the live bricks (``csrc/brick_integrate.cu``).

Port of ``_integrate_kernel_dyn`` / ``_integrate_bricks_dyn``
(``reconplan_tpu/ops/tsdf_brick.py:682-1100``). :func:`brick_integrate`
launches the CUDA kernel for CUDA tensors and calls
:func:`brick_integrate_reference`, its plain PyTorch version, for CPU
tensors. Both sample every in-image voxel, as the dense engine does; the
TPU kernel's VMEM windows drop the outer voxels of very large footprints,
so the two may differ from it there and only there.

The sdf / weight / rgb planes are updated in place (the JAX kernel aliases
them as outputs).

The kernel is persistent: its grid is the occupancy query's blocks per SM
times the card's SMs (at most ``len(ids)``), and its blocks take bricks
from a work counter in device memory, one for each stream
(:func:`work_slot`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

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

BRICK_VOXELS = 1024  # 8 (z) x 8 (y) x 16 (x)
# work counters of the kernel, one set per device (kWorkSlots in
# ``csrc/brick_integrate.cu``)
WORK_SLOTS = 1024

def _voxel_offsets(device):
    """Local (lx, ly, lz) f32 of the 1024 voxels of a brick row: sublane =
    local z, lane = local y * 16 + x."""
    v = torch.arange(BRICK_VOXELS, dtype=torch.int32, device=device)
    lane = v % 128
    return (lane % 16).float(), (lane // 16).float(), (v // 128).float()


def _voxel_world(ids, brick_dims, origin, voxel_size):
    """World (x, y, z) f32 of the 1024 voxels of each brick id, each
    (M, 1024), in the kernels' order of operations."""
    _, bh, bw = brick_dims
    voxel = float(np.float32(voxel_size))
    bz = (ids // (bh * bw)).float()[:, None]
    by = ((ids // bw) % bh).float()[:, None]
    bx = (ids % bw).float()[:, None]
    lx, ly, lz = _voxel_offsets(ids.device)
    return (origin[0] + (bx * 16 + lx) * voxel,
            origin[1] + (by * 8 + ly) * voxel,
            origin[2] + (bz * 8 + lz) * voxel)


def _project_voxels(pose, wx, wy, wz, intr, Hd, Wd):
    """Project the voxels through the (16,) row-major w2c ``pose`` and
    round to a pixel, as the kernels do. Returns (camera z, ui, vi i32,
    in-image mask, clamped pixel index)."""
    fx, fy, cx, cy = intr
    r = pose
    x = r[0] * wx + r[1] * wy + r[2] * wz + r[3]
    y = r[4] * wx + r[5] * wy + r[6] * wz + r[7]
    z = r[8] * wx + r[9] * wy + r[10] * wz + r[11]
    zs = torch.where(z.abs() < 1e-6, 1e-6, z)
    ui = torch.round(x / zs * fx + cx).to(torch.int32)
    vi = torch.round(y / zs * fy + cy).to(torch.int32)
    in_img = (ui >= 0) & (ui < Wd) & (vi >= 0) & (vi < Hd) & (z > 1e-4)
    pix = (vi.clamp(0, Hd - 1) * Wd + ui.clamp(0, Wd - 1)).long()
    return z, ui, vi, in_img, pix


def _depth_obs(d, z, in_img, depth_scale, depth_max, trunc):
    """The observation from raw depth samples ``d``: (w_obs 0/1 f32,
    tsdf_obs). ``depth_scale`` and ``trunc`` are 0-d f32 tensors."""
    d = d / depth_scale
    sdf_obs = d - z
    ok = in_img & (d > 0.0) & (d < depth_max) & (sdf_obs > -trunc)
    return ok.float(), torch.clamp(sdf_obs / trunc, -1.0, 1.0)


def _observe(pose, wx, wy, wz, depth, intr, depth_scale, depth_max, trunc):
    """One frame's observation of the voxels, as the kernels make it:
    project, round to a pixel, sample ``depth`` (Hd, Wd). Returns (w_obs
    0/1 f32, tsdf_obs, pixel index)."""
    z, _, _, in_img, pix = _project_voxels(pose, wx, wy, wz, intr,
                                           *depth.shape)
    w_obs, tsdf_obs = _depth_obs(depth.reshape(-1)[pix], z, in_img,
                                 depth_scale, depth_max, trunc)
    return w_obs, tsdf_obs, pix


def brick_integrate_reference(sdf_b, weight_b, rgb_b, ids, fbits, n_live,
                              T_w2c, intr, depths, colors, origin,
                              brick_dims, voxel_size, trunc, depth_scale,
                              depth_max, max_weight):
    """Plain PyTorch version of the K1 kernel; updates the planes in place.

    Divisors are f32 tensors on the planes' device: PyTorch's CUDA division
    by a Python scalar multiplies by the reciprocal instead, which would
    round differently from the kernel's divide.
    """
    dev = sdf_b.device
    M = ids.shape[0]
    F = depths.shape[0]
    depth_scale = scalar_tensor(depth_scale, dev)
    trunc = scalar_tensor(float(np.float32(trunc)), dev)
    rows = ids.long()
    live = torch.arange(M, device=dev) < n_live.reshape(())
    sdf = sdf_b.reshape(-1, BRICK_VOXELS)[rows]
    w = weight_b.reshape(-1, BRICK_VOXELS)[rows]
    if rgb_b is not None:
        packed = rgb_b.reshape(-1, BRICK_VOXELS)[rows]
        cr = (packed & 255).float()
        cg = ((packed >> 8) & 255).float()
        cb = ((packed >> 16) & 255).float()
    wx, wy, wz = _voxel_world(ids, brick_dims, origin, voxel_size)
    P = T_w2c.reshape(F, 16)
    for f in range(F):
        hit = (live & (((fbits >> f) & 1) > 0))[:, None]
        w_obs, tsdf_obs, pix = _observe(P[f], wx, wy, wz, depths[f], intr,
                                        depth_scale, depth_max, trunc)
        w_new = w + w_obs
        inv = 1.0 / torch.clamp(w_new, min=1.0)
        sdf_n = (sdf * w + tsdf_obs * w_obs) * inv
        sdf_n = torch.where(w_new > 0, sdf_n, 1.0)
        if rgb_b is not None:
            cpk = colors[f].reshape(-1)[pix]
            for c, shift in ((cr, 0), (cg, 8), (cb, 16)):
                obs = ((cpk >> shift) & 255).float()
                c.copy_(torch.where(hit, (c * w + obs * w_obs) * inv, c))
        sdf = torch.where(hit, sdf_n, sdf)
        w = torch.where(hit, torch.clamp(w_new, max=max_weight), w)
    # padding rows all point at the scratch brick and carry its values
    # unchanged, so writing every row back is exact
    sdf_b.view(-1, BRICK_VOXELS).index_copy_(0, rows, sdf)
    weight_b.view(-1, BRICK_VOXELS).index_copy_(0, rows, w)
    if rgb_b is not None:
        q = [torch.clamp(c + 0.5, 0.0, 255.0).to(torch.int32)
             for c in (cr, cg, cb)]
        rgb_b.view(-1, BRICK_VOXELS).index_copy_(
            0, rows, q[0] | (q[1] << 8) | (q[2] << 16))


@functools.cache
def occupancy(with_color, device_index):
    """(blocks per SM, threads per block) of the kernel on the card, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; queried once."""
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = entry("brick_integrate_occupancy", (INT, PTR, PTR))(
            int(with_color), ctypes.byref(blocks), ctypes.byref(threads))
    check_launch("brick_integrate_occupancy", err)
    return blocks.value, threads.value


def grid_size(with_color, device, max_active):
    """The persistent grid: blocks per SM x SMs, at most ``max_active``."""
    blocks, _ = occupancy(with_color, device.index or 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(max_active, blocks * sms)


_SLOTS = {}


def work_slot(device, stream):
    """The slot of the kernel's work counters that launches on ``stream``
    use: each (device, stream) gets its own, at first use. A counter is
    zero between launches (the last block of each launch resets it on the
    stream), so launches on one stream, which run in turn, share it safely.
    Graphs captured on one stream share its slot too: replay them in turn."""
    key = (device.index or 0, stream.cuda_stream)
    if key not in _SLOTS:
        taken = sum(k[0] == key[0] for k in _SLOTS)
        if taken == WORK_SLOTS:
            raise RuntimeError(f"brick_integrate: more than {WORK_SLOTS} "
                               f"streams on {device}")
        _SLOTS[key] = taken
    return _SLOTS[key]


def _check(sdf_b, weight_b, rgb_b, ids, fbits, n_live, T_w2c, depths,
           colors, origin):
    """Raise unless the arguments are what the kernel and its plain
    version take."""
    dev = sdf_b.device
    NB1 = sdf_b.shape[0]
    M = ids.shape[0]
    F, Hd, Wd = depths.shape
    if F > 32:
        raise ValueError(f"{F} frames do not fit a 32-bit frame mask")
    if (rgb_b is None) != (colors is None):
        raise ValueError("rgb_b and colors must be given together")
    plane = (NB1, 8, 128)
    check_tensor("sdf_b", sdf_b, torch.float32, plane, dev)
    check_tensor("weight_b", weight_b, torch.float32, plane, dev)
    if rgb_b is not None:
        check_tensor("rgb_b", rgb_b, torch.int32, plane, dev)
        check_tensor("colors", colors, torch.int32, (F, Hd, Wd), dev)
    check_tensor("ids", ids, torch.int32, (M,), dev)
    check_tensor("fbits", fbits, torch.int32, (M,), dev)
    check_tensor("n_live", n_live, torch.int32, (1,), dev)
    check_tensor("T_w2c", T_w2c, torch.float32, (F, 4, 4), dev)
    check_tensor("depths", depths, torch.float32, (F, Hd, Wd), dev)
    check_tensor("origin", origin, torch.float32, (3,), dev)


def _launch(sdf_b, weight_b, rgb_b, ids, fbits, n_live, T_w2c, intr,
            depths, colors, origin, brick_dims, voxel_size, trunc,
            depth_scale, depth_max, max_weight):
    dev = sdf_b.device
    if not (float(np.float32(depth_scale)) > 0 and float(np.float32(trunc)) > 0):
        raise ValueError("depth_scale and trunc must be > 0 (the kernel "
                         "skips divides whose result that makes exact)")
    F, Hd, Wd = depths.shape
    _, bh, bw = brick_dims
    M = ids.shape[0]
    stream = torch.cuda.current_stream(dev)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = entry("brick_integrate_launch",
                (PTR,) * 6 + (INT,) * 3 + (PTR,) * 4 + (INT,) * 5
                + (FLT,) * 9 + (PTR,))(
        sdf_b.data_ptr(), weight_b.data_ptr(), ptr(rgb_b), ids.data_ptr(),
        fbits.data_ptr(), n_live.data_ptr(), M, work_slot(dev, stream),
        grid_size(rgb_b is not None, dev, M),
        T_w2c.data_ptr(), origin.data_ptr(), depths.data_ptr(), ptr(colors),
        F, Hd, Wd, bh, bw,
        f32(voxel_size), f32(trunc), *map(f32, intr), f32(depth_scale),
        f32(depth_max), f32(max_weight), stream.cuda_stream,
    )
    check_launch("brick_integrate_launch", err)


def brick_integrate(sdf_b, weight_b, rgb_b, ids, fbits, n_live, T_w2c,
                    intr, depths, colors, origin, brick_dims, voxel_size,
                    trunc, depth_scale, depth_max, max_weight):
    """Integrate up to ``len(ids)`` bricks (the first ``n_live[0]`` are
    live) against the frames whose bit is set in ``fbits``, in place.

    ``ids``/``fbits`` (M,) i32, ``n_live`` (1,) i32 on the device (never
    read on the host), ``T_w2c`` (F, 4, 4) f32, ``intr`` (fx, fy, cx, cy)
    floats, ``depths`` (F, Hd, Wd) f32 raw, ``colors`` (F, Hd, Wd) i32
    packed B<<16|G<<8|R or None (then ``rgb_b`` must be None too).
    CUDA tensors launch the K1 kernel (counted in
    ``kernel.brick_integrate``); CPU tensors take the plain version.
    """
    args = (sdf_b, weight_b, rgb_b, ids, fbits, n_live, T_w2c, intr, depths,
            colors, origin, brick_dims, voxel_size, trunc, depth_scale,
            depth_max, max_weight)
    _check(sdf_b, weight_b, rgb_b, ids, fbits, n_live, T_w2c, depths,
           colors, origin)
    if ids.shape[0] == 0:  # nothing to fold, and no launch to count
        return
    if takes_plain("brick_integrate", sdf_b.device):
        brick_integrate_reference(*args)
        return
    _launch(*args)
    count("kernel.brick_integrate")
