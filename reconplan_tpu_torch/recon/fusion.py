"""TSDF fusion pipelines: frames -> grid -> mesh.

Port of ``FusionPipeline`` and ``fuse_frameset`` from
``reconplan_tpu.recon.fusion``. RGBD frames and camera poses go through
the brick engine (``ops.tsdf_brick``: the K2 / K1 CUDA kernels on a
card, their plain versions on the CPU) or the dense engine
(``ops.tsdf``), and meshes come out through table marching cubes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from reconplan_tpu_torch.io.frames import FrameSet
from reconplan_tpu_torch.ops import tsdf as tsdf_ops
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.ops.marching import marching_cubes
from reconplan_tpu_torch.utils.device import resolve_device


@dataclass
class FusionPipeline:
    """Stateful fusion session around one TSDF grid on one device.

    ``engine``:
      * "brick" (default): the brick-sparse engine — surface-proportional
        work; color integrates as a packed-RGB brick plane with the dense
        engine's averaging. The grid is updated in place.
      * "dense": the voxel-centric gather engine — the CPU oracle.
    """

    dims: tuple = (256, 256, 256)
    origin: tuple = (-0.25, -0.25, -0.25)
    voxel_size: float = 0.5 / 255
    trunc: float | None = None
    with_color: bool = False
    depth_scale: float = 1000.0
    depth_max: float = 3.0
    engine: str = "brick"
    device: str | torch.device | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.engine == "brick":
            self.grid = tb.make_brick_grid(
                self.dims, self.origin, self.voxel_size, self.trunc,
                with_color=self.with_color, device=self.device,
            )
        elif self.engine == "dense":
            self.grid = tsdf_ops.make_grid(
                self.dims, self.origin, self.voxel_size, self.trunc,
                self.with_color, device=self.device,
            )
        else:
            raise ValueError(f"unknown engine {self.engine!r}")

    def integrate(self, frames: FrameSet, intrinsics=None):
        """Integrate a FrameSet (poses required) into the grid."""
        if frames.poses is None:
            raise ValueError("FusionPipeline.integrate requires camera poses")
        fx, fy, cx, cy = intrinsics or frames.intrinsics
        depth_scale = frames.depth_scale or self.depth_scale
        if self.engine == "brick":
            self.grid, _ = tb.integrate_frames_bricked_device(
                self.grid, frames.depth, frames.poses, fx, fy, cx, cy,
                colors=(frames.color
                        if self.with_color and frames.color is not None
                        else None),
                depth_scale=depth_scale, depth_max=self.depth_max,
            )
            return self
        colors = None
        if self.with_color and frames.color is not None:
            colors = torch.as_tensor(frames.color, device=self.device).float()
            colors = torch.where(colors.max() > 1.5, colors / 255.0, colors)
        self.grid = tsdf_ops.integrate_frames(
            self.grid, frames.depth, frames.poses, fx, fy, cx, cy,
            colors=colors, depth_scale=depth_scale, depth_max=self.depth_max,
        )
        return self

    def _dense_grid(self):
        if self.engine == "brick":
            sdf, weight = tb.to_dense(self.grid)
            color = (
                tb.to_dense_color(self.grid)
                if self.grid.rgb is not None
                else torch.zeros((0, 0, 0, 3), dtype=torch.float32,
                                 device=self.device)
            )
            f32 = dict(dtype=torch.float32, device=self.device)
            return tsdf_ops.TSDFGrid(
                sdf, weight, color, self.grid.origin,
                torch.tensor(self.grid.voxel_size, **f32),
                torch.tensor(self.grid.trunc, **f32),
            )
        return self.grid

    def extract_mesh(self, weight_min=1.0, with_colors=False):
        """Zero iso-surface as a (T, 3, 3) triangle tensor (world frame).
        ``with_colors`` also returns (T, 3, 3) per-vertex RGB in [0, 1]
        sampled from the color volume (nearest voxel)."""
        grid = self._dense_grid()
        tris = marching_cubes(grid, weight_min=weight_min)
        if not with_colors:
            return tris
        return tris, self._sample_colors(grid, tris.reshape(-1, 3)).reshape(
            tris.shape)

    @staticmethod
    def _sample_colors(grid, points):
        """Nearest-voxel color lookup for world-space points."""
        if not grid.has_color:
            raise ValueError("grid has no color channel")
        D, H, W = grid.sdf.shape
        ijk = torch.round(
            (points - grid.origin) / grid.voxel_size
        ).to(torch.int32)
        k = ijk[:, 0].clamp(0, W - 1).long()
        j = ijk[:, 1].clamp(0, H - 1).long()
        i = ijk[:, 2].clamp(0, D - 1).long()
        return grid.color[i, j, k]

    def extract_points(self, weight_min=1.0, with_colors=False):
        grid = self._dense_grid()
        pts, mask = tsdf_ops.extract_surface_points(grid, weight_min)
        pts = pts[mask]
        if not with_colors:
            return pts
        return pts, self._sample_colors(grid, pts)


def fuse_frameset(frames: FrameSet, dims=(256, 256, 256), origin=None,
                  voxel_size=None, with_color=False, weight_min=1.0,
                  device=None):
    """One-shot fusion of a posed FrameSet. Auto-fits the grid to the
    observed volume when origin/voxel_size are omitted (from the poses'
    look directions at the median depth). ``weight_min`` is accepted and
    unused, as in the JAX function: the extraction methods of the
    returned pipeline take it."""
    if origin is None or voxel_size is None:
        poses = np.asarray(torch.as_tensor(frames.poses).cpu())
        depth = np.asarray(torch.as_tensor(frames.depth).cpu())
        eyes = poses[:, :3, 3]
        centers = eyes + poses[:, :3, 2] * np.median(
            depth[depth > 0] / (frames.depth_scale or 1000.0)
        )
        lo = centers.min(axis=0) - 0.2
        hi = centers.max(axis=0) + 0.2
        origin = tuple(lo)
        voxel_size = float((hi - lo).max() / (max(dims) - 1))
    pipe = FusionPipeline(
        dims=dims, origin=tuple(origin), voxel_size=voxel_size,
        with_color=with_color, device=device,
    )
    pipe.integrate(frames)
    return pipe
