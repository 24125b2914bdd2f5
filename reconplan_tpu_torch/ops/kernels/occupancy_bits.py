"""K8: the occupancy mip of the brick mask pipeline
(``csrc/occupancy_bits.cu``).

Per mip cell of each frame, the presence of 64 depth bins over the chunk's
valid-depth range, packed into two i32 planes and OR-dilated over a
wrap-around box, with the bins' ``(b0, bin_size)``.
:func:`occupancy_bits` launches the CUDA kernel (three launches) for CUDA
tensors and calls :func:`occupancy_bits_reference`, its plain PyTorch
version (an eager chain), for CPU tensors. It replaces no TPU kernel: the
JAX occupancy is plain XLA. The float operations follow the plain
version's order, so the two give identical bits.
"""

from __future__ import annotations

import torch

from reconplan_tpu_torch.ops.kernels.active_mask import (
    MIP_CELLS,
    to_int32_bits,
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

# kPartials of csrc/occupancy_bits.cu: the range pass's blocks, each a
# partial min and max in the scratch
PARTIALS = 512
# kMaxWidth and kMaxRounds: the dilation's rows in static shared memory
MAX_WIDTH = 128
MAX_ROUNDS = 16


def occupancy_bits_reference(depths, depth_scale=1000.0, depth_max=3.0,
                             mip_cell=8, mip_rounds=4):
    """Plain PyTorch version of the occupancy mip: per-cell
    depth-occupancy bitmask over 64 adaptive bins spanning the chunk's
    valid-depth range, as two i32 planes (bins 0-31, 32-63) plus the
    (b0, bin_size) parameters, OR-dilated ``mip_rounds`` times with
    wrap-around rolls (see the JAX function for the design)."""
    F, Hd, Wd = depths.shape
    Hm, Wm = Hd // mip_cell, Wd // mip_cell
    d = depths.float() / scalar_tensor(depth_scale, depths.device)
    valid = (d > 0.0) & (d < depth_max)
    inf = float("inf")
    gmin = torch.where(valid, d, inf).amin()
    gmax = torch.where(valid, d, -inf).amax()
    gmin = torch.where(torch.isfinite(gmin), gmin, 0.0)
    gmax = torch.where(torch.isfinite(gmax), gmax, 0.0)
    bs = torch.clamp((gmax - gmin) / scalar_tensor(62.0, d.device), min=0.002)
    b0 = gmin - bs  # bin 1 starts at gmin; 0 and 63 stay as margin
    bins = torch.clamp(((d - b0) / bs).to(torch.int32), 0, 63)

    def cells(a):  # (F, Hd, Wd) -> (F*Hm*Wm, mip_cell**2), one row per cell
        a = a.reshape(F, Hm, mip_cell, Wm, mip_cell).permute(0, 1, 3, 2, 4)
        return a.reshape(F * Hm * Wm, mip_cell * mip_cell)

    # bitwise OR over a cell = presence of each bin among its valid pixels
    present = torch.zeros((F * Hm * Wm, 64), dtype=torch.int32,
                          device=d.device)
    present.scatter_reduce_(1, cells(bins).long(), cells(valid).int(), "amax")
    weights = torch.ones(32, dtype=torch.int64, device=d.device) << torch.arange(
        32, device=d.device)
    planes = []
    for half in (present[:, :32], present[:, 32:]):
        bits = to_int32_bits((half.long() * weights).sum(dim=1))
        planes.append(bits.reshape(F, Hm, Wm))
    occ0, occ1 = planes
    for _ in range(mip_rounds):  # separable 3x3 OR dilation
        for ax in (1, 2):
            occ0 = occ0 | torch.roll(occ0, 1, ax) | torch.roll(occ0, -1, ax)
            occ1 = occ1 | torch.roll(occ1, 1, ax) | torch.roll(occ1, -1, ax)
    return occ0, occ1, torch.stack([b0, bs])


def occupancy_bits(depths, depth_scale=1000.0, depth_max=3.0, mip_cell=8,
                   mip_rounds=4):
    """(occ0, occ1, binp): the two dilated (F, Hd // mip_cell, Wd //
    mip_cell) i32 planes and the (2,) f32 bin parameters of ``depths``
    (F, Hd, Wd) f32. CUDA tensors launch the kernel (a call counted in
    ``kernel.occupancy_bits``: three launches); CPU tensors take the plain
    version."""
    F, Hd, Wd = depths.shape
    dev = depths.device
    check_tensor("depths", depths, torch.float32, (F, Hd, Wd), dev)
    if mip_cell not in MIP_CELLS or Hd % mip_cell or Wd % mip_cell:
        raise ValueError(f"mip_cell {mip_cell} must be one of {MIP_CELLS} "
                         f"and divide the {Hd}x{Wd} frames")
    Hm, Wm = Hd // mip_cell, Wd // mip_cell
    if F < 1 or Wm > MAX_WIDTH or not 0 <= mip_rounds <= MAX_ROUNDS:
        raise ValueError(f"occupancy_bits takes 1 frame or more, at most "
                         f"{MAX_WIDTH} cells across and {MAX_ROUNDS} rounds")
    if takes_plain("occupancy_bits", dev):
        return occupancy_bits_reference(depths, depth_scale, depth_max,
                                        mip_cell, mip_rounds)
    n = F * Hm * Wm
    # the dilated planes, binp, then the scratch: the undilated planes and
    # the range pass's partials; one allocation, never zeroed
    buf = torch.empty(4 * n + 2 + 2 * PARTIALS, dtype=torch.int32, device=dev)
    at = buf.data_ptr()
    err = entry("occupancy_bits_launch",
                (PTR,) * 5 + (INT,) * 5 + (FLT,) * 2 + (PTR,))(
        depths.data_ptr(), at + 4 * (4 * n + 2), at + 4 * (2 * n + 2), at,
        at + 4 * (2 * n), F, Hd, Wd, mip_cell, mip_rounds, depth_scale,
        depth_max, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch("occupancy_bits_launch", err)
    count("kernel.occupancy_bits")
    planes = buf[:2 * n].view(2, F, Hm, Wm)
    return planes[0], planes[1], buf[2 * n:2 * n + 2].view(torch.float32)
