"""K2: per-(brick, frame) conservative occupancy test (``csrc/active_mask.cu``).

Port of ``active_brick_bits_pallas`` / ``_active_mask_kernel``
(``reconplan_tpu/ops/tsdf_brick.py:278-428``). :func:`active_mask` launches
the CUDA kernel for CUDA tensors and calls :func:`active_mask_reference`,
its plain PyTorch version, for CPU tensors. The float operations of both
follow the TPU kernel's order, so the two give identical bits.
"""

from __future__ import annotations

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
from reconplan_tpu_torch.utils.profiling import count

BRICK_Z, BRICK_Y, BRICK_X = 8, 8, 16  # 8x8x16 voxels = one (8, 128) row
# the cells ``_occupancy_cell`` picks; the kernel shifts by log2 of the cell
MIP_CELLS = (8, 16, 32)


def _band(voxel_size, trunc):
    """trunc + brick radius + 2 mm, rounded in f32 step by step as the TPU
    kernel computes it from its f32 meta row."""
    f32 = np.float32
    r_b = f32(f32(0.5) * f32(voxel_size)) * f32(
        np.sqrt(BRICK_X**2 + BRICK_Y**2 + BRICK_Z**2)
    )
    return float(f32(f32(trunc) + r_b) + f32(2e-3))


def _lowmask(n):
    """int64 bits [0..n] inclusive; n < 0 -> 0, n >= 31 -> all 32 ones."""
    base = (torch.ones_like(n) << torch.clamp(n + 1, 0, 31)) - 1
    base = torch.where(n >= 31, 0xFFFFFFFF, base)
    return torch.where(n < 0, 0, base)


def to_int32_bits(bits):
    """int64 holding 32 bits -> int32 with the same bit pattern."""
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)


def active_mask_reference(brick_dims, origin, voxel_size, trunc,
                          occ0, occ1, binp, T_w2c, fx, fy, cx, cy,
                          mip_cell=8):
    """Plain PyTorch version of the K2 kernel: (NB,) i32 frame bits."""
    bd, bh, bw = brick_dims
    NB = bd * bh * bw
    F, Hm, Wm = occ0.shape
    dev = occ0.device
    bid = torch.arange(NB, dtype=torch.int32, device=dev)
    bz = bid // (bh * bw)
    by = (bid // bw) % bh
    bx = bid % bw
    voxel = float(np.float32(voxel_size))
    ccx = origin[0] + (bx.float() * BRICK_X + BRICK_X / 2) * voxel
    ccy = origin[1] + (by.float() * BRICK_Y + BRICK_Y / 2) * voxel
    ccz = origin[2] + (bz.float() * BRICK_Z + BRICK_Z / 2) * voxel
    band = _band(voxel_size, trunc)
    b0 = binp[0]
    inv_bs = 1.0 / binp[1]
    mask32 = 0xFFFFFFFF
    occ0 = occ0.long() & mask32
    occ1 = occ1.long() & mask32
    P = T_w2c.reshape(F, 16)
    active = torch.zeros(NB, dtype=torch.int64, device=dev)
    for f in range(F):
        r = P[f]
        x = r[0] * ccx + r[1] * ccy + r[2] * ccz + r[3]
        y = r[4] * ccx + r[5] * ccy + r[6] * ccz + r[7]
        z = r[8] * ccx + r[9] * ccy + r[10] * ccz + r[11]
        zs = torch.clamp(z, min=1e-6)
        # astype(int32) truncates toward zero, then // floors
        uci = torch.div((x / zs * fx + cx).to(torch.int32), mip_cell,
                        rounding_mode="floor").clamp(0, Wm - 1)
        vci = torch.div((y / zs * fy + cy).to(torch.int32), mip_cell,
                        rounding_mode="floor").clamp(0, Hm - 1)
        g0 = occ0[f, vci.long(), uci.long()]
        g1 = occ1[f, vci.long(), uci.long()]
        b_lo = torch.floor((z - band - b0) * inv_bs).to(torch.int64) - 1
        b_hi = torch.floor((z + band - b0) * inv_bs).to(torch.int64)
        m0 = _lowmask(torch.clamp(b_hi, max=31)) & (
            ~_lowmask(torch.clamp(b_lo, max=32) - 1) & mask32)
        m1 = _lowmask(b_hi - 32) & (~_lowmask(b_lo - 33) & mask32)
        hit = (z > 1e-4) & (((g0 & m0) | (g1 & m1)) != 0)
        active = active | torch.where(hit, 1 << f, 0)
    return to_int32_bits(active)


def _check(occ0, occ1, binp, T_w2c, origin, mip_cell):
    """Raise unless the arguments are what the kernel and its plain
    version take."""
    F, Hm, Wm = occ0.shape
    dev = occ0.device
    if F > 32:
        raise ValueError(f"{F} frames do not fit a 32-bit frame mask")
    if mip_cell not in MIP_CELLS:
        raise ValueError(f"mip_cell {mip_cell} is not one of {MIP_CELLS}")
    check_tensor("occ0", occ0, torch.int32, (F, Hm, Wm), dev)
    check_tensor("occ1", occ1, torch.int32, (F, Hm, Wm), dev)
    check_tensor("binp", binp, torch.float32, (2,), dev)
    check_tensor("T_w2c", T_w2c, torch.float32, (F, 4, 4), dev)
    check_tensor("origin", origin, torch.float32, (3,), dev)


def _launch(brick_dims, origin, voxel_size, trunc, occ0, occ1, binp, T_w2c,
            fx, fy, cx, cy, mip_cell):
    dev = occ0.device
    if T_w2c.data_ptr() % 16:
        raise ValueError("T_w2c must be 16-byte aligned (the kernel reads "
                         "each pose row as one float4)")
    bd, bh, bw = brick_dims
    F, Hm, Wm = occ0.shape
    out = torch.empty(bd * bh * bw, dtype=torch.int32, device=dev)
    err = entry("active_mask_launch",
                (PTR,) * 6 + (INT,) * 7 + (FLT,) * 6 + (PTR,))(
        occ0.data_ptr(), occ1.data_ptr(), T_w2c.data_ptr(),
        origin.data_ptr(), binp.data_ptr(), out.data_ptr(),
        bd * bh * bw, bh, bw, F, Hm, Wm, int(mip_cell),
        float(np.float32(voxel_size)), _band(voxel_size, trunc),
        fx, fy, cx, cy, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("active_mask_launch", err)
    return out


def active_mask(brick_dims, origin, voxel_size, trunc,
                occ0, occ1, binp, T_w2c, fx, fy, cx, cy, mip_cell=8):
    """(NB,) i32 per-frame active bits (bit f set = brick active in frame
    f) from the depth-bin occupancy planes of ``occupancy_bits``.

    CUDA tensors launch the K2 kernel (counted in ``kernel.active_mask``);
    CPU tensors take the plain version. ``mip_cell`` must be one of
    :data:`MIP_CELLS`.
    """
    args = (brick_dims, origin, voxel_size, trunc, occ0, occ1, binp, T_w2c,
            fx, fy, cx, cy, mip_cell)
    _check(occ0, occ1, binp, T_w2c, origin, mip_cell)
    if takes_plain("active_mask", occ0.device):
        return active_mask_reference(*args)
    out = _launch(*args)
    count("kernel.active_mask")
    return out
