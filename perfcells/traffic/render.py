"""Synthetic RGBD frames by z-buffered point splatting.

A frozen copy of the port's ``io/render.py`` (``camera_look_at``,
``splat_depth_color``, ``SplatCamera``) and of the mesh reading and
surface sampling it uses (``io/meshio.py``), so that the frames a cell
fuses or stitches stay what they were when its bounds were set.
"""

from __future__ import annotations

import numpy as np
import torch

_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


def load_ply(path):
    """(vertices (V, 3) f64, faces (F, 3) int64) of a binary little-endian
    PLY whose faces are triangles."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        raw = f.read()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError(f"{path}: only binary little-endian PLY is read")
    elems, cur = [], None
    for line in header:
        parts = line.split()
        if parts and parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elems.append(cur)
        elif parts and parts[0] == "property" and cur is not None:
            cur[2].append(parts[1:])
    verts = faces = None
    off = 0
    for name, count, props in elems:
        if name == "vertex":
            dt = np.dtype([(p[1], "<" + _PLY_TYPES[p[0]]) for p in props])
            data = np.frombuffer(raw, dtype=dt, count=count, offset=off)
            off += dt.itemsize * count
            verts = np.stack([data[k].astype(np.float64)
                              for k in ("x", "y", "z")], axis=-1)
        elif name == "face":
            (_, cnt_t, idx_t, _) = props[0]
            dt = np.dtype([("n", "<" + _PLY_TYPES[cnt_t]),
                           ("v", "<" + _PLY_TYPES[idx_t], (3,))])
            data = np.frombuffer(raw, dtype=dt, count=count, offset=off)
            if (data["n"] != 3).any():
                raise ValueError(f"{path}: faces must be triangles")
            off += dt.itemsize * count
            faces = data["v"].astype(np.int64)
    return verts, faces


def sample_mesh_surface(vertices, faces, n_points, seed=0):
    """Area-weighted barycentric samples of a mesh: (points, normals)."""
    rng = np.random.default_rng(seed)
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    prob = area / area.sum()
    tri = rng.choice(len(faces), size=n_points, p=prob)
    u = rng.uniform(size=(n_points, 1))
    v = rng.uniform(size=(n_points, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pts = v0[tri] + u * (v1[tri] - v0[tri]) + v * (v2[tri] - v0[tri])
    nrm = cross[tri]
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    return pts, nrm


def camera_look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """cam->world pose (4, 4) f32 with OpenCV pinhole axes (z forward, y
    down)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    n = np.linalg.norm(x)
    if n < 1e-9:
        x = np.cross(z, np.array([1.0, 0.0, 0.0]))
        n = np.linalg.norm(x)
    x = x / n
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T.astype(np.float32)


def splat_depth_color(points, colors, T_world_to_cam, fx, fy, cx, cy,
                      height, width, near=0.05, far=5.0):
    """One RGBD frame: (depth (H, W) metres, 0 = no hit; color (H, W, 3))."""
    dev = points.device
    T = torch.as_tensor(T_world_to_cam, dtype=torch.float32, device=dev)
    cam = torch.matmul(points, T[:3, :3].T) + T[:3, 3]
    z = cam[:, 2]
    u = torch.round(cam[:, 0] / z * fx + cx).to(torch.int32)
    v = torch.round(cam[:, 1] / z * fy + cy).to(torch.int32)
    ok = ((z > near) & (z < far) & (u >= 0) & (u < width) & (v >= 0)
          & (v < height))
    n_pix = height * width
    flat = torch.where(ok, v * width + u, n_pix).long()
    inf = float("inf")
    zbuf = torch.full((n_pix + 1,), inf, dtype=torch.float32, device=dev)
    zbuf.scatter_reduce_(0, flat, torch.where(ok, z, inf), "amin")
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
    """A simulated RGBD camera over a static scene of sampled meshes.
    ``take_picture`` returns depth in millimetres, as a D435 does."""

    def __init__(self, width=640, height=480, fx=615.67, fy=615.96,
                 cx=326.06, cy=240.56, samples_per_mesh=1_500_000, seed=0,
                 device="cuda"):
        self.width, self.height = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.device = torch.device(device)
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
        pts, nrm = sample_mesh_surface(vertices, faces,
                                       samples or self._samples,
                                       seed=self._seed)
        pts = pts + np.asarray(translate, dtype=np.float64)
        if color is None:
            lam = np.clip(nrm @ np.array([0.3, 0.2, 0.93]), 0.15, 1.0)
            cols = np.stack([lam * 0.9, lam * 0.8, lam * 0.2], axis=-1)
        else:
            cols = np.broadcast_to(np.asarray(color, dtype=np.float64),
                                   pts.shape)
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            a.astype(np.float32), device=self.device)
        self._points = torch.cat([self._points, as_t(pts)])
        self._colors = torch.cat([self._colors, as_t(cols)])
        return self

    def add_mesh_file(self, path, **kwargs):
        v, f = load_ply(path)
        return self.add_mesh(v, f, **kwargs)

    def add_checker_floor(self, center=(0.0, 0.0), size=0.5, tiles=8,
                          z=0.0, samples_per_tile=4000, seed=3):
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
        """(depth_mm (H, W) f32, color_uint8 (H, W, 3), T_cam_to_world
        (4, 4) f32 numpy)."""
        T_c2w = camera_look_at(eye, target)
        T_w2c = np.linalg.inv(T_c2w).astype(np.float32)
        depth, color = splat_depth_color(
            self._points, self._colors, T_w2c,
            self.fx, self.fy, self.cx, self.cy, self.height, self.width,
        )
        color_u8 = (torch.clamp(color, 0, 1) * 255).to(torch.uint8)
        return depth * 1000.0, color_u8, T_c2w
