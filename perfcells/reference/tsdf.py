"""Plain PyTorch TSDF fusion over a dense voxel grid, and the comparison
that judges a fused grid against it.

Semantics (the projective TSDF of KinectFusion, as the repo states it):
voxel (z, y, x) sits at ``origin + (x, y, z) * voxel``; a frame projects
it through its world->camera pose, rounds to a pixel (half to even), and
observes it when the pixel is inside the image, ``z > 1e-4`` and the depth
``d`` (raw / ``depth_scale``) lies in ``(0, depth_max)``: ``sdf = d - z``.
An observation with ``sdf > -trunc`` adds ``clip(sdf / trunc, -1, 1)``
with weight 1 to the voxel's running average; the weight is capped at
``max_weight``.

A brick engine integrates a frame only into bricks (8 z x 8 y x 16 x
voxels) near that frame's surface. So the reference keeps, per voxel:

- ``count_m`` and ``sum_m``: the observations of the frames for which the
  voxel's brick holds a voxel in band (``|sdf| < trunc``): these every
  engine must integrate;
- ``count_plus``: the observations of the other frames. All of them have
  ``sdf >= trunc`` and add exactly +1, so an engine that takes a superset
  of the bricks may add some of them.

A grid is right when each voxel's weight lies in
``[min(count_m, W), min(count_m + count_plus, W)]`` and, where its weight
``w`` stayed under the cap, its sdf is the average of the ``count_m``
observations and ``w - count_m`` extra +1s.
"""

from __future__ import annotations

import numpy as np
import torch

BRICK = (8, 8, 16)  # z, y, x voxels of a brick


def world_to_camera(poses_c2w):
    """(F, 4, 4) f64 numpy inverses of the camera->world poses."""
    return np.linalg.inv(np.asarray(poses_c2w, dtype=np.float64))


def reference_slabs(depths, T_w2c, intr, dims, origin, voxel, trunc,
                    depth_scale=1000.0, depth_max=3.0, dtype=torch.float32,
                    slab=64):
    """Yield, for each slab of ``slab`` z-planes (a multiple of 8), ``(z0,
    count_m (Z, H, W) i32, sum_m (Z, H, W) dtype, count_plus (Z, H, W)
    i32, band (F, Z/8, H/8, W/16) bool)``, ``band`` the bricks each frame
    holds a voxel in band of. All arithmetic is in ``dtype``; the control
    passes a lower precision than float32."""
    D, H, W = dims
    F, Hd, Wd = depths.shape
    dev = depths.device
    kw = dict(dtype=dtype, device=dev)
    T = torch.as_tensor(np.asarray(T_w2c), **kw).reshape(F, 16)
    org = torch.as_tensor(np.asarray(origin, np.float32), **kw)
    vox = torch.tensor(float(np.float32(voxel)), **kw)
    tr = torch.tensor(float(np.float32(trunc)), **kw)
    scale = torch.tensor(float(depth_scale), **kw)
    fx, fy, cx, cy = (float(np.float32(v)) for v in intr)
    dep = depths.to(dtype).reshape(F, -1)
    wx = (org[0] + torch.arange(W, **kw) * vox).reshape(1, 1, W)
    wy = (org[1] + torch.arange(H, **kw) * vox).reshape(1, H, 1)
    bz, by, bx = BRICK
    for z0 in range(0, D, slab):
        Z = min(slab, D - z0)
        wz = (org[2] + torch.arange(z0, z0 + Z, **kw) * vox).reshape(Z, 1, 1)
        count_m = torch.zeros((Z, H, W), dtype=torch.int32, device=dev)
        count_p = torch.zeros((Z, H, W), dtype=torch.int32, device=dev)
        sum_m = torch.zeros((Z, H, W), **kw)
        bands = []
        for f in range(F):
            r = T[f]
            x = r[0] * wx + r[1] * wy + r[2] * wz + r[3]
            y = r[4] * wx + r[5] * wy + r[6] * wz + r[7]
            z = r[8] * wx + r[9] * wy + r[10] * wz + r[11]
            zs = torch.where(z.abs() < 1e-6, 1e-6, z)
            u = torch.round(x / zs * fx + cx).to(torch.int32)
            v = torch.round(y / zs * fy + cy).to(torch.int32)
            inside = (u >= 0) & (u < Wd) & (v >= 0) & (v < Hd) & (z > 1e-4)
            pix = (v.clamp(0, Hd - 1) * Wd + u.clamp(0, Wd - 1)).long()
            d = dep[f][pix] / scale
            sdf = d - z
            valid = inside & (d > 0) & (d < depth_max)
            obs = valid & (sdf > -tr)
            band = (valid & (sdf.abs() < tr)).reshape(
                Z // bz, bz, H // by, by, W // bx, bx).any(5).any(3).any(1)
            bands.append(band)
            in_m = band[:, None, :, None, :, None].expand(
                -1, bz, -1, by, -1, bx).reshape(Z, H, W)
            m = obs & in_m
            count_m += m
            count_p += obs & ~in_m
            sum_m += torch.where(m, torch.clamp(sdf / tr, -1.0, 1.0), 0.0)
        yield z0, count_m, sum_m, count_p, torch.stack(bands)


class GridJudge:
    """Counts, slab by slab, the voxels of a fused grid that the reference
    refutes. ``tol`` is in tsdf units (sdf / trunc)."""

    def __init__(self, max_weight=64.0, tol=5e-4):
        self.max_weight = float(max_weight)
        self.tol = tol
        self.touched = self.bad_weight = self.compared = self.bad_sdf = 0
        self.brick_frames = self.bricks = 0

    def add(self, weight, sdf, count_m, sum_m, count_p, band):
        """One slab of the program's dense ``weight`` and ``sdf`` (Z, H, W)
        against the reference's slab."""
        cap = self.max_weight
        cm = count_m.float()
        lo = torch.clamp(cm, max=cap)
        hi = torch.clamp(cm + count_p.float(), max=cap)
        touched = (hi > 0) | (weight > 0)
        bad_w = touched & ((weight < lo) | (weight > hi))
        cmp = touched & ~bad_w & (weight > 0) & (weight < cap)
        expect = (sum_m.float() + (weight - cm)) / torch.clamp(weight, min=1)
        bad_s = cmp & ((sdf - expect).abs() > self.tol)
        self.touched += int(touched.sum())
        self.bad_weight += int(bad_w.sum())
        self.compared += int(cmp.sum())
        self.bad_sdf += int(bad_s.sum())
        self.brick_frames += int(band.sum())
        self.bricks += int(band.any(0).sum())

    def shares(self):
        """(bad weight share, bad sdf share) of the touched and compared
        voxels."""
        return (self.bad_weight / max(self.touched, 1),
                self.bad_sdf / max(self.compared, 1))


def fuse_and_judge(depths, poses_c2w, intr, geometry, program_slab,
                   dtype=torch.float32, slab=64, control_slab=None):
    """Run the reference slab by slab and judge ``program_slab(z0, Z) ->
    (weight, sdf)`` against it. ``geometry`` holds dims, origin, voxel,
    trunc, depth_scale, depth_max, max_weight. With ``control_slab`` the
    program is replaced by a reference grid computed in ``dtype`` (the
    control), judged against the float32 reference. Returns the judge."""
    g = geometry
    T = world_to_camera(poses_c2w).astype(np.float32)
    judge = GridJudge(g["max_weight"])
    args = (depths, T, intr, g["dims"], g["origin"], g["voxel"], g["trunc"],
            g["depth_scale"], g["depth_max"])
    ref = reference_slabs(*args, slab=slab)
    low = (reference_slabs(*args, dtype=dtype, slab=slab)
           if control_slab else None)
    for z0, cm, sm, cp, band in ref:
        Z = cm.shape[0]
        if low is not None:
            _, lcm, lsm, _, _ = next(low)
            weight, sdf = control_slab(lcm, lsm, g["max_weight"])
        else:
            weight, sdf = program_slab(z0, Z)
        judge.add(weight, sdf, cm, sm, cp, band)
    return judge


def control_grid(count_m, sum_m, max_weight):
    """The grid a lower-precision reference fuses: weight min(count, cap),
    sdf the average of its observations (1 where it has none)."""
    c = count_m.float()
    sdf = torch.where(c > 0, sum_m.float() / torch.clamp(c, min=1), 1.0)
    return torch.clamp(c, max=max_weight), sdf
