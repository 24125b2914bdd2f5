"""The depth-sampling microprobe (``csrc/gather_probe.cu``).

Port of the TPU microprobe kernel of ``_mk(kind)``
(``benchmarks/probe_sublane_ops.py:35``, K6): each arm sums ``LOOP`` rows
of an ``(H, W)`` f32 window, shifted by ``s0``, into an ``(8, 128)``
output whose rows are all the same. :func:`gather_probe` launches the CUDA
kernel for a CUDA tensor and calls :func:`gather_probe_reference`, its
plain PyTorch version, for a CPU tensor. The plain version adds the rows
in a Python loop, in order, as the kernel does, so its bits equal the
kernel's (``x.sum(0)`` reduces in another order).
"""

from __future__ import annotations

import torch

from reconplan_tpu_torch.ops.kernels.build import (
    check_launch,
    check_tensor,
    load_library,
)

# the order is the CUDA source's ``Arm`` enum; the TPU kinds they answer
ARMS = ("baseline", "smem_roll", "smem_slice", "rowload")
TPU_KIND = {"baseline": "baseline", "smem_roll": "roll",
            "smem_slice": "dynslice", "rowload": "rowload"}
H, W, LOOP = 32, 256, 24
GRID = 2048  # blocks, as the TPU probe's grid
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


def gather_probe(arm, x, s0):
    """Run probe ``arm`` (one of :data:`ARMS`) on ``x`` (H, W) f32 with the
    row shift ``s0`` (an int); returns (8, 128) f32. CUDA tensors launch
    the kernel over ``GRID`` blocks (counted per arm in
    ``gather_probe.launches``); CPU tensors take the plain version."""
    if arm not in ARMS:
        raise ValueError(f"unknown probe arm {arm!r}; arms are {ARMS}")
    check_tensor("x", x, torch.float32, (H, W), x.device)
    if not 0 <= s0 < H:
        raise ValueError(f"s0 {s0} outside [0, {H})")
    if arm == "rowload" and s0 + LOOP > H:
        raise ValueError(f"rowload reads rows {s0}..{s0 + LOOP - 1} of {H}")
    if x.device.type == "cpu":
        return gather_probe_reference(arm, x, s0)
    if x.device.type != "cuda":
        raise ValueError(f"gather_probe: unsupported device {x.device}")
    lib = load_library()
    out = torch.empty((8, COLS), dtype=torch.float32, device=x.device)
    err = lib.gather_probe_launch(
        ARMS.index(arm), x.data_ptr(), out.data_ptr(), H, W, LOOP, int(s0),
        GRID, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("gather_probe_launch", err)
    gather_probe.launches[arm] += 1
    return out


gather_probe.launches = dict.fromkeys(ARMS, 0)
