"""Device resolution: one place that turns a user's device request into a
``torch.device`` and refuses to pretend."""

from __future__ import annotations

import subprocess

import torch


def card_summary() -> str:
    """``nvidia-smi``'s name and power limit of the card(s), one line each
    (``name, power.limit``). Every timing is reported beside it: a card
    set below its maximum power runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def scalar_tensor(value, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device``, for use as a divisor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead, which
    rounds differently from a divide (and from the CUDA kernels)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; any other request as given.

    The card is the default device of every entry point. With no CUDA
    device, ``None`` and an explicit CUDA request both raise: a run never
    silently lands on the CPU. Pass ``device="cpu"`` to ask for the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        asked = "no device given" if device is None else f"device {device!r}"
        raise RuntimeError(
            f"{asked}: the default device is the cuda card, but "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "on the CPU"
        )
    return dev


def robot_device(robot, device):
    """``device`` resolved (None: the card), which must be the robot's:
    whatever is built for the robot feeds its FK and IK."""
    device = resolve_device(device)
    if (device.type, device.index or 0) != (robot.device.type,
                                            robot.device.index or 0):
        raise ValueError(f"the robot is on {robot.device}, and "
                         f"{device} was asked for")
    return device
