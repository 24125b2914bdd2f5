"""Synthetic RGBD rendering by point splatting with a z-buffer.

Port of ``camera_look_at``, ``splat_depth_color`` and ``SplatCamera``
from ``reconplan_tpu.io.render``. The mesh is pre-sampled into dense
surface splats once (numpy, seeded); each frame is a project +
``scatter_reduce_("amin")`` z-buffer and an ``index_add_`` color pass.
The JAX package pins this to its host CPU because TPU scatters
serialize; here it runs on whichever device the camera was built for,
and the frames stay there.
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.io.meshio import load_mesh, sample_mesh_surface
from reconplan_tpu_torch.utils.device import resolve_device


def camera_look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """cam->world pose (4, 4) f32 numpy with OpenCV pinhole axes (z
    forward, y down)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    n = np.linalg.norm(x)
    if n < 1e-9:  # looking straight along up
        x = np.cross(z, np.array([1.0, 0.0, 0.0]))
        n = np.linalg.norm(x)
    x = x / n
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T.astype(np.float32)


def splat_depth_color(points, colors, T_world_to_cam, fx, fy, cx, cy,
                      height: int, width: int, near: float = 0.05,
                      far: float = 5.0):
    """Render one RGBD frame by z-buffered point splatting.

    ``points``/``colors`` (N, 3) f32 tensors, ``T_world_to_cam`` (4, 4).
    Returns (depth (H, W) meters with 0 = no hit, color (H, W, 3)).
    """
    dev = points.device
    T = torch.as_tensor(T_world_to_cam, dtype=torch.float32, device=dev)
    R = T[:3, :3]
    t = T[:3, 3]
    cam = torch.matmul(points, R.T) + t
    z = cam[:, 2]
    u = torch.round(cam[:, 0] / z * fx + cx).to(torch.int32)
    v = torch.round(cam[:, 1] / z * fy + cy).to(torch.int32)
    ok = (z > near) & (z < far) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    n_pix = height * width
    flat = torch.where(ok, v * width + u, n_pix).long()  # overflow slot

    # z-buffer: scatter-min of depth per pixel (+1 dummy slot)
    inf = float("inf")
    zbuf = torch.full((n_pix + 1,), inf, dtype=torch.float32, device=dev)
    zbuf.scatter_reduce_(0, flat, torch.where(ok, z, inf), "amin")

    # color pass: a point wins its pixel if its z matches the buffer
    won = ok & (z <= zbuf[flat] * (1.0 + 1e-4))
    cbuf = torch.zeros((n_pix + 1, 3), dtype=torch.float32, device=dev)
    wbuf = torch.zeros(n_pix + 1, dtype=torch.float32, device=dev)
    cbuf.index_add_(0, flat, torch.where(won[:, None], colors, 0.0))
    wbuf.index_add_(0, flat, won.float())
    color = cbuf[:n_pix] / torch.clamp(wbuf[:n_pix, None], min=1.0)

    depth = zbuf[:n_pix]
    depth = torch.where(torch.isinf(depth), 0.0, depth)
    return depth.reshape(height, width), color.reshape(height, width, 3)


class SplatCamera:
    """Simulated RGBD camera over a static scene of meshes.

    Construct with a scene, call :meth:`take_picture` with an eye position
    and a look-at target; depth comes back metric (mm) like the real
    RealSense path, on the camera's ``device``.
    """

    def __init__(self, width=640, height=480, fx=615.67, fy=615.96,
                 cx=326.06, cy=240.56, samples_per_mesh=1_500_000, seed=0,
                 device=None):
        self.width, self.height = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.device = resolve_device(device)
        self._points = torch.zeros((0, 3), dtype=torch.float32,
                                   device=self.device)
        self._colors = torch.zeros((0, 3), dtype=torch.float32,
                                   device=self.device)
        self._samples = samples_per_mesh
        self._seed = seed

    @property
    def intrinsics(self):
        return (self.fx, self.fy, self.cx, self.cy)

    def add_mesh(self, vertices, faces, translate=(0, 0, 0), color=None,
                 samples=None):
        """Add a mesh to the scene (pre-sampled into surface splats),
        moved by ``translate``. ``color=None`` shades by normal
        (lambertian, light from +z); else one RGB in [0, 1]."""
        pts, nrm = sample_mesh_surface(vertices, faces,
                                       samples or self._samples,
                                       seed=self._seed)
        pts = pts + np.asarray(translate, dtype=np.float64)
        if color is None:
            lam = np.clip(nrm @ np.array([0.3, 0.2, 0.93]), 0.15, 1.0)
            cols = np.stack([lam * 0.9, lam * 0.8, lam * 0.2], axis=-1)  # banana-ish
        else:
            cols = np.broadcast_to(np.asarray(color, dtype=np.float64),
                                   pts.shape)
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            a.astype(np.float32), device=self.device)
        self._points = torch.cat([self._points, as_t(pts)])
        self._colors = torch.cat([self._colors, as_t(cols)])
        return self

    def add_mesh_file(self, path, **kwargs):
        v, f = load_mesh(path)
        return self.add_mesh(v, f, **kwargs)

    def add_checker_floor(self, center=(0.0, 0.0), size=0.5, tiles=8,
                          z=0.0, samples_per_tile=4000, seed=3):
        """Add a floor patch of randomly colored tiles around ``center``.

        A planar, textured context under the object is what makes
        pose-free sequential registration well-posed (a lone smooth object
        is near-ambiguous for ICP). The tile colors are random, not a
        two-color checkerboard, whose 180-degree symmetry would leave
        global registration a perfect wrong optimum.
        """
        cx, cy = center
        tile = size / tiles
        x0, y0 = cx - size / 2, cy - size / 2
        quad_f = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
        palette = np.random.RandomState(seed).uniform(
            0.15, 0.85, (tiles, tiles, 3))
        for i in range(tiles):
            for j in range(tiles):
                xa, ya = x0 + i * tile, y0 + j * tile
                v = np.array([[xa, ya, z], [xa + tile, ya, z],
                              [xa + tile, ya + tile, z], [xa, ya + tile, z]],
                             dtype=np.float64)
                self.add_mesh(v, quad_f, color=palette[i, j],
                              samples=samples_per_tile)
        return self

    def take_picture(self, eye, target):
        """Render from ``eye`` looking at ``target``.

        Returns (depth_mm (H, W) f32 tensor, color_uint8 (H, W, 3) tensor,
        T_cam_to_world (4, 4) f32 numpy) — depth in millimeters
        (depth_scale 1000).
        """
        T_c2w = camera_look_at(eye, target)
        T_w2c = np.linalg.inv(T_c2w).astype(np.float32)
        depth, color = splat_depth_color(
            self._points, self._colors, T_w2c,
            self.fx, self.fy, self.cx, self.cy, self.height, self.width,
        )
        depth_mm = depth * 1000.0
        color_u8 = (torch.clamp(color, 0, 1) * 255).to(torch.uint8)
        return depth_mm, color_u8, T_c2w
