"""The depth-sampling microprobe (``csrc/gather_probe.cu``).

Port of the TPU microprobe kernel of ``_mk(kind)``
(``benchmarks/probe_sublane_ops.py:35``, K6): each arm sums ``LOOP`` rows
of an ``(H, W)`` f32 window, shifted by ``s0``, into an ``(8, 128)``
output whose rows are all the same, ``GRID`` times over (the TPU probe's
grid steps). :func:`gather_probe` launches the CUDA kernel for a CUDA
tensor and calls :func:`gather_probe_reference`, its plain PyTorch
version, for a CPU tensor. The plain version adds the rows in a Python
loop, in order, as the kernel does, so its bits equal the kernel's
(``x.sum(0)`` reduces in another order).

The kernel's grid is sized to the card: a few blocks of 128 threads an SM
(:func:`blocks_per_sm`), each walking its share of the steps.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from reconplan_tpu_torch.ops.kernels.build import (
    INT,
    PTR,
    check_launch,
    check_tensor,
    entry,
    takes_plain,
)
from reconplan_tpu_torch.utils.profiling import count

# the order is the CUDA source's ``Arm`` enum; the TPU kinds they answer
ARMS = ("baseline", "smem_roll", "smem_slice", "rowload")
TPU_KIND = {"baseline": "baseline", "smem_roll": "roll",
            "smem_slice": "dynslice", "rowload": "rowload"}
H, W, LOOP = 32, 256, 24
GRID = 2048  # steps, as the TPU probe's grid
COLS = 128


def probe_rows(arm, s0):
    """The window rows ``arm`` adds, in order."""
    if arm == "baseline":
        return list(range(H))
    if arm == "smem_roll":
        return [(s0 + r) % H for r in range(LOOP)]
    if arm == "smem_slice":
        base = min(s0, H - LOOP)
        return [base + r for r in range(LOOP)]
    if arm == "rowload":
        return [s0 + r for r in range(LOOP)]
    raise ValueError(f"unknown probe arm {arm!r}; arms are {ARMS}")


def gather_probe_reference(arm, x, s0):
    """Plain PyTorch version: the in-order f32 sum of the arm's rows of
    ``x[:, :128]``, broadcast to (8, 128)."""
    acc = torch.zeros(COLS, dtype=torch.float32, device=x.device)
    for r in probe_rows(arm, s0):
        acc = acc + x[r, :COLS]
    return acc.expand(8, COLS).contiguous()


@functools.cache
def blocks_per_sm(arm, device_index):
    """(the most blocks of ``arm``'s kernel an SM holds, by
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; the blocks an SM
    the probe's grid takes); queried once."""
    most, taken = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = entry("gather_probe_occupancy", (INT, PTR, PTR))(
            ARMS.index(arm), ctypes.byref(most), ctypes.byref(taken))
    check_launch("gather_probe_occupancy", err)
    return most.value, taken.value


def grid_size(arm, device, steps):
    """The kernel's grid: blocks per SM x SMs, at most ``steps``."""
    _, taken = blocks_per_sm(arm, device.index or 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(steps, taken * sms)


def _launch(arm, x, s0, steps, blocks):
    """Launch ``arm``'s kernel on a grid of ``blocks`` blocks; returns the
    (8, 128) output."""
    out = torch.empty((8, COLS), dtype=torch.float32, device=x.device)
    err = entry("gather_probe_launch",
                (INT,) + (PTR,) * 2 + (INT,) * 6 + (PTR,))(
        ARMS.index(arm), x.data_ptr(), out.data_ptr(), H, W, LOOP, int(s0),
        int(steps), int(blocks),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("gather_probe_launch", err)
    return out


def gather_probe(arm, x, s0, steps=GRID):
    """Run probe ``arm`` (one of :data:`ARMS`) on ``x`` (H, W) f32 with the
    row shift ``s0`` (an int), ``steps`` times over; returns (8, 128) f32,
    the same for any ``steps``. CUDA tensors launch the kernel (counted
    per arm in ``kernel.gather_probe.<arm>``); CPU tensors take the plain
    version."""
    if arm not in ARMS:
        raise ValueError(f"unknown probe arm {arm!r}; arms are {ARMS}")
    check_tensor("x", x, torch.float32, (H, W), x.device)
    if not 0 <= s0 < H:
        raise ValueError(f"s0 {s0} outside [0, {H})")
    if arm == "rowload" and s0 + LOOP > H:
        raise ValueError(f"rowload reads rows {s0}..{s0 + LOOP - 1} of {H}")
    if steps < 1:
        raise ValueError(f"steps {steps} must be at least 1")
    if takes_plain("gather_probe", x.device):
        return gather_probe_reference(arm, x, s0)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the window is staged "
                         "with 16-byte copies)")
    out = _launch(arm, x, s0, steps, grid_size(arm, x.device, steps))
    count(f"kernel.gather_probe.{arm}")
    return out
