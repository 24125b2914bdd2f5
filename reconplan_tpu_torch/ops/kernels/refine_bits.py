"""K7: the refine of the brick mask pipeline (``csrc/refine_bits.cu``).

The exact centre-sample test of K2's candidate bricks, dilated one brick
with wrap-around and intersected with K2's bits. :func:`refine_bits`
launches the CUDA kernel (three launches) for CUDA tensors and calls
:func:`refine_bits_reference`, its plain PyTorch version (an eager chain),
for CPU tensors. It replaces no TPU kernel: the JAX refine is plain XLA.
The float operations follow the plain version's order, so the two give
identical bits. ``ops/tsdf_brick`` takes the brick centres, their
projection and the dilation from here too.
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.ops.kernels.active_mask import (
    BRICK_X,
    BRICK_Y,
    BRICK_Z,
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

# bit 31 is the sign of the i32 word: the plain version's max-scatter
# drops it, and the JAX function cannot form it
MAX_FRAMES = 31
# kTile of csrc/refine_bits.cu: the count scratch holds one int a tile
TILE = 1024


def band(voxel_size, trunc):
    """trunc + brick radius as the plain version computes it, in Python
    doubles; the comparison rounds it to f32."""
    return trunc + 0.5 * voxel_size * np.sqrt(
        BRICK_X**2 + BRICK_Y**2 + BRICK_Z**2)


def _brick_centers(brick_ids, brick_dims, origin, voxel):
    """World centres (x, y, z) f32 of the given bricks."""
    _, bh, bw = brick_dims
    bz = brick_ids // (bh * bw)
    by = (brick_ids // bw) % bh
    bx = brick_ids % bw
    return (
        origin[0] + (bx.float() * BRICK_X + BRICK_X / 2) * voxel,
        origin[1] + (by.float() * BRICK_Y + BRICK_Y / 2) * voxel,
        origin[2] + (bz.float() * BRICK_Z + BRICK_Z / 2) * voxel,
    )


def _project(T, px, py, pz):
    """Camera coordinates of world points under a (4, 4) w2c pose."""
    x = T[0, 0] * px + T[0, 1] * py + T[0, 2] * pz + T[0, 3]
    y = T[1, 0] * px + T[1, 1] * py + T[1, 2] * pz + T[1, 3]
    z = T[2, 0] * px + T[2, 1] * py + T[2, 2] * pz + T[2, 3]
    return x, y, z


def _dilate(m):
    """One-brick OR dilation along each axis of a (bd, bh, bw) array, with
    the JAX path's wrap-around rolls."""
    for ax in range(3):
        m = m | torch.roll(m, 1, ax) | torch.roll(m, -1, ax)
    return m


def refine_bits_reference(bits, depths, T_w2c, origin, voxel_size, trunc,
                          intr, brick_dims, cap, depth_scale=1000.0,
                          depth_max=3.0):
    """Plain PyTorch version of the refine: ``bits`` & the per-frame exact
    centre-sample bits on its candidates (the bricks with ``bits != 0``),
    dilated one brick in each axis direction (wrap-around). Candidates past
    ``cap`` keep their ``bits`` (see the JAX function
    ``_exact_frame_bits_dilated``)."""
    bd, bh, bw = brick_dims
    NB = bd * bh * bw
    dev = bits.device
    cap = min(cap, NB)
    F, Hd, Wd = depths.shape
    fx, fy, cx, cy = intr
    occupied = bits != 0
    # stable-argsort compaction: actives first in index order, padding ->
    # the NB sentinel
    n_cand = occupied.sum()
    cand = torch.argsort(torch.where(occupied, 0, 1).to(torch.int32),
                         stable=True)[:cap]
    cand = torch.where(torch.arange(cap, device=dev) < n_cand, cand, NB)
    ccx, ccy, ccz = _brick_centers(
        torch.clamp(cand, max=NB - 1), brick_dims, origin,
        float(np.float32(voxel_size)))
    # Python-double band, as the JAX function computes it from static floats
    reach = band(voxel_size, trunc)
    scale = scalar_tensor(depth_scale, depths.device)
    ebits = torch.zeros(cand.shape, dtype=torch.int32, device=dev)
    for f in range(F):
        x, y, z = _project(T_w2c[f], ccx, ccy, ccz)
        zs = torch.clamp(z, min=1e-6)
        uf = x / zs * fx + cx
        vf = y / zs * fy + cy
        ui = torch.round(uf).to(torch.int32).clamp(0, Wd - 1)
        vi = torch.round(vf).to(torch.int32).clamp(0, Hd - 1)
        inside = (z > 1e-4) & (uf >= 0) & (uf < Wd) & (vf >= 0) & (vf < Hd)
        d = depths[f].reshape(-1)[(vi * Wd + ui).long()] / scale
        hit = inside & (d > 0) & (d < depth_max) & ((d - z).abs() < reach)
        ebits = ebits | torch.where(hit, 1 << f, 0).to(torch.int32)
    # rank = position among actives in index order, matching the stable
    # argsort compaction above, so rank < cap <=> examined
    rank = torch.cumsum(occupied, 0) - 1
    base = torch.where(occupied & (rank >= cap), bits, 0)
    dense = torch.cat([base, torch.zeros(1, dtype=torch.int32, device=dev)])
    dense = dense.scatter_reduce(0, cand, ebits, "amax")
    return bits & _dilate(dense[:NB].reshape(bd, bh, bw)).reshape(-1)


def refine_bits(bits, depths, T_w2c, origin, voxel_size, trunc, intr,
                brick_dims, cap, depth_scale=1000.0, depth_max=3.0):
    """(NB,) i32: ``bits`` & the wrap-around dilation of the exact
    per-frame centre test of the first ``cap`` bricks with ``bits != 0``
    (the rest keep their ``bits``), at most :data:`MAX_FRAMES` frames.
    CUDA tensors launch the kernel (a call counted in
    ``kernel.refine_bits``: three launches); CPU tensors take the plain
    version."""
    F, Hd, Wd = depths.shape
    if F > MAX_FRAMES:
        raise ValueError(f"{F} frames do not fit the refine's "
                         f"{MAX_FRAMES}-frame bit words")
    dev = bits.device
    bd, bh, bw = brick_dims
    NB = bd * bh * bw
    check_tensor("bits", bits, torch.int32, (NB,), dev)
    check_tensor("depths", depths, torch.float32, (F, Hd, Wd), dev)
    check_tensor("T_w2c", T_w2c, torch.float32, (F, 4, 4), dev)
    check_tensor("origin", origin, torch.float32, (3,), dev)
    if takes_plain("refine_bits", dev):
        return refine_bits_reference(bits, depths, T_w2c, origin, voxel_size,
                                     trunc, intr, brick_dims, cap,
                                     depth_scale, depth_max)
    out = torch.empty(NB, dtype=torch.int32, device=dev)
    tiles = -(-NB // TILE)
    # the tiles' candidate counts, then the undilated bits
    scratch = torch.empty(tiles + NB, dtype=torch.int32, device=dev)
    fx, fy, cx, cy = intr
    err = entry("refine_bits_launch",
                (PTR,) * 7 + (INT,) * 7 + (FLT,) * 8 + (PTR,))(
        bits.data_ptr(), depths.data_ptr(), T_w2c.data_ptr(),
        origin.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 4 * tiles,
        out.data_ptr(), bd, bh, bw, F, Hd, Wd, min(cap, NB),
        float(np.float32(voxel_size)), band(voxel_size, trunc), fx, fy, cx,
        cy, depth_scale, depth_max,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("refine_bits_launch", err)
    count("kernel.refine_bits")
    return out
