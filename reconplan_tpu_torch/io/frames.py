"""RGBD frame batches — the host->device boundary for camera data.

Port of ``reconplan_tpu.io.frames.FrameSet``. The arrays may be numpy
arrays or torch tensors (the port's splat renderer leaves its frames on
the card); consumers move them with ``torch.as_tensor(..., device=...)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class FrameSet:
    """A batch of RGBD frames with optional camera poses (cam->world)."""

    depth: np.ndarray | torch.Tensor  # (F, H, W) raw depth (depth_scale units)
    color: np.ndarray | torch.Tensor | None = None  # (F, H, W, 3) uint8 or float [0,1]
    poses: np.ndarray | torch.Tensor | None = None  # (F, 4, 4) cam->world, if known
    depth_scale: float = 1000.0
    intrinsics: tuple | None = None  # (fx, fy, cx, cy)

    def __len__(self):
        return len(self.depth)
