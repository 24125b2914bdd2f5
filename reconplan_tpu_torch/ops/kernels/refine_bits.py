"""The refine of the brick mask pipeline (``csrc/refine_bits.cu``).

The exact centre-sample test of K2's candidate bricks, dilated one brick
with wrap-around and intersected with K2's bits: on CUDA tensors, three
kernel launches in place of the eager chain of
``ops/tsdf_brick._exact_frame_bits_dilated``, which stays the plain
version (``tsdf_brick.refine_frame_bits`` takes it for CPU tensors). It
replaces no TPU kernel: the JAX refine is plain XLA. The float operations
follow the plain version's order, so the two give identical bits.
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
    check_launch,
    check_tensor,
    load_library,
)

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


def check_frames(n_frames):
    """Raise unless ``n_frames`` fits the refine's bit words."""
    if n_frames > MAX_FRAMES:
        raise ValueError(f"{n_frames} frames do not fit the refine's "
                         f"{MAX_FRAMES}-frame bit words")


def refine_bits(bits, depths, T_w2c, origin, voxel_size, trunc, intr,
                brick_dims, cap, depth_scale=1000.0, depth_max=3.0):
    """(NB,) i32: ``bits`` & the wrap-around dilation of the exact
    per-frame centre test of the first ``cap`` bricks with ``bits != 0``
    (the rest keep their ``bits``), on CUDA tensors; the arguments of the
    plain version, ``ops/tsdf_brick._exact_frame_bits_dilated``. Counts
    the call in ``refine_bits.launches`` (three kernel launches a call)."""
    F, Hd, Wd = depths.shape
    check_frames(F)
    dev = bits.device
    if dev.type != "cuda":
        raise ValueError(f"refine_bits: unsupported device {dev}")
    bd, bh, bw = brick_dims
    NB = bd * bh * bw
    check_tensor("bits", bits, torch.int32, (NB,), dev)
    check_tensor("depths", depths, torch.float32, (F, Hd, Wd), dev)
    check_tensor("T_w2c", T_w2c, torch.float32, (F, 4, 4), dev)
    check_tensor("origin", origin, torch.float32, (3,), dev)
    out = torch.empty(NB, dtype=torch.int32, device=dev)
    tiles = -(-NB // TILE)
    # the tiles' candidate counts, then the undilated bits
    scratch = torch.empty(tiles + NB, dtype=torch.int32, device=dev)
    fx, fy, cx, cy = intr
    err = load_library().refine_bits_launch(
        bits.data_ptr(), depths.data_ptr(), T_w2c.data_ptr(),
        origin.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 4 * tiles,
        out.data_ptr(), bd, bh, bw, F, Hd, Wd, min(cap, NB),
        float(np.float32(voxel_size)), band(voxel_size, trunc), fx, fy, cx,
        cy, depth_scale, depth_max,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("refine_bits_launch", err)
    refine_bits.launches += 1
    return out


refine_bits.launches = 0
