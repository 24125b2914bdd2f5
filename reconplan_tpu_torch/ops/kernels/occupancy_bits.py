"""The occupancy mip of the brick mask pipeline (``csrc/occupancy_bits.cu``).

Per mip cell of each frame, the presence of 64 depth bins over the chunk's
valid-depth range, packed into two i32 planes and OR-dilated over a
wrap-around box, with the bins' ``(b0, bin_size)``: on CUDA tensors, three
kernel launches in place of the eager chain of
``ops/tsdf_brick._build_depth_occupancy``, which stays the plain version
(``tsdf_brick.depth_occupancy`` takes it for CPU tensors). It replaces no
TPU kernel: the JAX occupancy is plain XLA. The float operations follow
the plain version's order, so the two give identical bits.
"""

from __future__ import annotations

import torch

from reconplan_tpu_torch.ops.kernels.active_mask import MIP_CELLS
from reconplan_tpu_torch.ops.kernels.build import (
    check_launch,
    check_tensor,
    load_library,
)

# kPartials of csrc/occupancy_bits.cu: the range pass's blocks, each a
# partial min and max in the scratch
PARTIALS = 512
# kMaxWidth and kMaxRounds: the dilation's rows in static shared memory
MAX_WIDTH = 128
MAX_ROUNDS = 16


def occupancy_bits(depths, depth_scale=1000.0, depth_max=3.0, mip_cell=8,
                   mip_rounds=4):
    """(occ0, occ1, binp): the two dilated (F, Hd // mip_cell, Wd //
    mip_cell) i32 planes and the (2,) f32 bin parameters of the CUDA
    ``depths`` (F, Hd, Wd) f32; the arguments and results of the plain
    version, ``ops/tsdf_brick._build_depth_occupancy``. Counts the call in
    ``occupancy_bits.launches`` (three kernel launches a call)."""
    F, Hd, Wd = depths.shape
    dev = depths.device
    if dev.type != "cuda":
        raise ValueError(f"occupancy_bits: unsupported device {dev}")
    check_tensor("depths", depths, torch.float32, (F, Hd, Wd), dev)
    if mip_cell not in MIP_CELLS or Hd % mip_cell or Wd % mip_cell:
        raise ValueError(f"mip_cell {mip_cell} must be one of {MIP_CELLS} "
                         f"and divide the {Hd}x{Wd} frames")
    Hm, Wm = Hd // mip_cell, Wd // mip_cell
    if F < 1 or Wm > MAX_WIDTH or not 0 <= mip_rounds <= MAX_ROUNDS:
        raise ValueError(f"occupancy_bits takes 1 frame or more, at most "
                         f"{MAX_WIDTH} cells across and {MAX_ROUNDS} rounds")
    n = F * Hm * Wm
    # the dilated planes, binp, then the scratch: the undilated planes and
    # the range pass's partials; one allocation, never zeroed
    buf = torch.empty(4 * n + 2 + 2 * PARTIALS, dtype=torch.int32, device=dev)
    at = buf.data_ptr()
    err = load_library().occupancy_bits_launch(
        depths.data_ptr(), at + 4 * (4 * n + 2), at + 4 * (2 * n + 2), at,
        at + 4 * (2 * n), F, Hd, Wd, mip_cell, mip_rounds, depth_scale,
        depth_max, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("occupancy_bits_launch", err)
    occupancy_bits.launches += 1
    planes = buf[:2 * n].view(2, F, Hm, Wm)
    return planes[0], planes[1], buf[2 * n:2 * n + 2].view(torch.float32)


occupancy_bits.launches = 0
