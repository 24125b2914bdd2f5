"""RGBD frame batches and feeds — the host->device boundary for camera
data.

Port of ``reconplan_tpu.io.frames``: ``FrameSet`` and the recorded-folder
and in-memory feeds. A ``FrameSet``'s arrays may be numpy arrays or torch
tensors (the port's splat renderer leaves its frames on the card);
consumers move them with ``torch.as_tensor(..., device=...)``. The
loaders return numpy: files are read on the host.
"""

from __future__ import annotations

import json
import os
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


def _read_image(path):
    import PIL.Image

    return np.asarray(PIL.Image.open(path))


def load_rgbd_folder(
    folder_path,
    rgb_foldername="rgb",
    depth_foldername="depth",
    truncate_to_multiple=None,
) -> FrameSet:
    """Load a recorded capture directory.

    Handles both recorded layouts: PNG depth (the simulator's) and
    ``.npy`` float depth (a RealSense capture). ``truncate_to_multiple``
    trims the frame count to a multiple, as the stitcher's optimisation
    modulus wants. Reads ``metadata.json`` for intrinsics when present.
    """
    rgb_dir = os.path.join(folder_path, rgb_foldername)
    depth_dir = os.path.join(folder_path, depth_foldername)
    rgbs, depths = [], []
    for name in sorted(os.listdir(rgb_dir)):
        rgbs.append(_read_image(os.path.join(rgb_dir, name))[..., :3])
    for name in sorted(os.listdir(depth_dir)):
        p = os.path.join(depth_dir, name)
        if name.endswith(".npy"):
            depths.append(np.load(p))
        else:
            depths.append(_read_image(p))
    if truncate_to_multiple:
        n = len(rgbs) - (len(rgbs) % truncate_to_multiple)
        rgbs, depths = rgbs[:n], depths[:n]

    intrinsics = None
    meta_path = os.path.join(folder_path, "metadata.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        intr = meta.get("camera_intrinsics") or meta.get("intrinsics")
        if intr:
            intrinsics = (intr["fx"], intr["fy"],
                          intr["cx"] if "cx" in intr else intr["ppx"],
                          intr["cy"] if "cy" in intr else intr["ppy"])
    return FrameSet(
        depth=np.stack(depths).astype(np.float32),
        color=np.stack(rgbs),
        intrinsics=intrinsics,
    )


def _batches(f: FrameSet, batch_size):
    for i in range(0, len(f), batch_size):
        sl = slice(i, i + batch_size)
        yield FrameSet(
            f.depth[sl],
            f.color[sl] if f.color is not None else None,
            f.poses[sl] if f.poses is not None else None,
            f.depth_scale,
            f.intrinsics,
        )


class DirectoryFrameFeed:
    """Iterate a recorded directory in fixed-size batches."""

    def __init__(self, folder_path, batch_size=8, **kwargs):
        self.frames = load_rgbd_folder(folder_path, **kwargs)
        self.batch_size = batch_size

    def __iter__(self):
        return _batches(self.frames, self.batch_size)


class ArrayFrameFeed:
    """Feed over in-memory arrays (synthetic renders, tests)."""

    def __init__(self, frameset: FrameSet, batch_size=8):
        self.frames = frameset
        self.batch_size = batch_size

    def __iter__(self):
        return _batches(self.frames, self.batch_size)
