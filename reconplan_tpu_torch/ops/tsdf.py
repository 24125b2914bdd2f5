"""Dense TSDF volumetric fusion (KinectFusion-style), voxel-centric gather.

Port of ``reconplan_tpu.ops.tsdf``: ``TSDFGrid``, ``make_grid``,
``integrate_frames``, ``extract_surface_points`` and ``raycast_depth``.
It keeps the JAX engine's per-frame update order and its z-chunking
(chunks of ~16M voxels bound the temporaries at 512^3), so the same
inputs give the same floats op for op. ``integrate_slab`` sweeps a z
range of a grid with the whole grid's chunks, which is how a z-sharded
grid (``parallel.fusion``) gives the one grid's bits. It is the CPU
oracle of the brick path and of its color semantics, and runs on either
device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reconplan_tpu_torch.utils.device import resolve_device, scalar_tensor


class TSDFGrid(NamedTuple):
    """Dense truncated signed distance grid.

    sdf is stored in truncation units (range [-1, 1], 1 = empty space in
    front of any surface by >= trunc meters). weight counts integrated
    observations (clamped at ``max_weight``). ``origin``, ``voxel_size``
    and ``trunc`` are f32 tensors on the grid's device, as in the JAX
    grid, so derived quantities round in f32 the same way.
    """

    sdf: torch.Tensor  # (D, H, W) f32, init +1
    weight: torch.Tensor  # (D, H, W) f32, init 0
    color: torch.Tensor  # (D, H, W, 3) f32 or (0, 0, 0, 3) when colorless
    origin: torch.Tensor  # (3,) world position of voxel (0,0,0) CENTER
    voxel_size: torch.Tensor  # () meters
    trunc: torch.Tensor  # () meters

    @property
    def shape(self):
        return tuple(self.sdf.shape)

    @property
    def has_color(self):
        return tuple(self.color.shape[:3]) == tuple(self.sdf.shape)


def make_grid(dims, origin, voxel_size, trunc=None, with_color=False,
              dtype=torch.float32, device=None) -> TSDFGrid:
    """Allocate an empty grid. ``dims`` = (D, H, W) voxels; ``origin`` is
    the world position of the (0,0,0) voxel center; ``trunc`` defaults to
    5 voxels. ``dtype`` is that of the sdf, weight and color volumes (the
    origin, voxel size and trunc stay f32). ``device`` defaults to the
    card (``"cpu"`` asks for the CPU)."""
    device = resolve_device(device)
    D, H, W = dims
    if trunc is None:
        trunc = 5.0 * voxel_size
    f32 = dict(dtype=torch.float32, device=device)
    vol = dict(dtype=dtype, device=device)
    return TSDFGrid(
        sdf=torch.ones((D, H, W), **vol),
        weight=torch.zeros((D, H, W), **vol),
        color=torch.zeros((D, H, W, 3) if with_color else (0, 0, 0, 3), **vol),
        origin=torch.as_tensor(np.array(origin, np.float32), device=device),
        voxel_size=torch.tensor(voxel_size, **f32),
        trunc=torch.tensor(trunc, **f32),
    )


def tsdf_grid_from_numpy(sdf, weight, color, origin, voxel_size, trunc,
                         device=None) -> TSDFGrid:
    """A grid from numpy arrays (e.g. a JAX ``TSDFGrid`` taken with
    ``np.asarray`` field by field), on ``device`` (default: the card)."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return TSDFGrid(
        sdf=torch.as_tensor(np.array(sdf), **f32),
        weight=torch.as_tensor(np.array(weight), **f32),
        color=torch.as_tensor(np.array(color), **f32),
        origin=torch.as_tensor(np.array(origin, np.float32), device=device),
        voxel_size=torch.tensor(float(np.float32(voxel_size)), **f32),
        trunc=torch.tensor(float(np.float32(trunc)), **f32),
    )


def tsdf_grid_to_numpy(grid: TSDFGrid) -> dict:
    """The grid's fields as numpy, keyed as :func:`tsdf_grid_from_numpy`
    takes them."""
    return {
        "sdf": grid.sdf.cpu().numpy(),
        "weight": grid.weight.cpu().numpy(),
        "color": grid.color.cpu().numpy(),
        "origin": grid.origin.cpu().numpy(),
        "voxel_size": float(grid.voxel_size),
        "trunc": float(grid.trunc),
    }


def _iota(shape, dim, device, start=0):
    """f32 index plane along ``dim`` (lax.broadcasted_iota), counting from
    ``start``."""
    n = shape[dim]
    view = [1] * len(shape)
    view[dim] = n
    return torch.arange(start, start + n, dtype=torch.float32,
                        device=device).view(view)


def _voxel_world_coords(grid: TSDFGrid):
    """(D, H, W, 3) world coordinates of voxel centers."""
    shape = grid.sdf.shape
    dev = grid.sdf.device
    coords = torch.stack(
        torch.broadcast_tensors(
            _iota(shape, 2, dev), _iota(shape, 1, dev), _iota(shape, 0, dev)
        ),
        dim=-1,
    )
    return grid.origin + coords * grid.voxel_size


def _chunk_cam_coords(shape, origin, z0, z_off, voxel, T_w2c):
    """Camera coordinates of the voxels of a z-chunk from its row ``z_off``
    on, as 9 scalar multiply-adds over index planes (never an (..., 3)
    world tensor)."""
    dev = origin.device
    wx = origin[0] + _iota(shape, 2, dev) * voxel
    wy = origin[1] + _iota(shape, 1, dev) * voxel
    wz = z0 + _iota(shape, 0, dev, z_off) * voxel
    R = T_w2c[:3, :3]
    t = T_w2c[:3, 3]
    cx_ = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + t[0]
    cy_ = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + t[1]
    cz_ = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + t[2]
    return cx_, cy_, cz_


def _integrate_chunk(sdf, weight, color, z0, z_off, origin, voxel,
                     depths, colors, T_w2c_all, params):
    """Fold all F frames into the rows of one z-chunk of the grid from its
    row ``z_off`` on (the JAX engine's per-frame update,
    :func:`reconplan_tpu.ops.tsdf._integrate_chunk`)."""
    fx, fy, cx, cy, depth_scale, depth_max, trunc, max_weight = params
    F = depths.shape[0]
    Hd, Wd = depths.shape[1], depths.shape[2]

    for f in range(F):
        x, y, z = _chunk_cam_coords(sdf.shape, origin, z0, z_off, voxel,
                                    T_w2c_all[f])
        z_safe = torch.where(z.abs() < 1e-6, 1e-6, z)
        ui = torch.round(x / z_safe * fx + cx).to(torch.int32)
        vi = torch.round(y / z_safe * fy + cy).to(torch.int32)
        inside = (z > 1e-4) & (ui >= 0) & (ui < Wd) & (vi >= 0) & (vi < Hd)
        ui = ui.clamp(0, Wd - 1)
        vi = vi.clamp(0, Hd - 1)
        flat = (vi * Wd + ui).long()
        d = depths[f].reshape(-1)[flat] / depth_scale
        ok = inside & (d > 0.0) & (d < depth_max)

        sdf_obs = d - z  # meters, positive in front of the surface
        ok = ok & (sdf_obs > -trunc)
        tsdf_obs = torch.clamp(sdf_obs / trunc, -1.0, 1.0)
        w_obs = ok.to(sdf.dtype)
        w_new = weight + w_obs
        sdf = (sdf * weight + tsdf_obs * w_obs) / torch.clamp(w_new, min=1.0)
        sdf = torch.where(w_new > 0, sdf, 1.0)
        if color is not None and colors is not None:
            c_obs = colors[f].reshape(-1, 3)[flat].to(sdf.dtype)
            color = (
                color * weight[..., None] + c_obs * w_obs[..., None]
            ) / torch.clamp(w_new, min=1.0)[..., None]
        weight = torch.clamp(w_new, max=max_weight)
    return sdf, weight, color


def _chunking(D, H, W):
    """(n_chunks, Dc): the z-chunks of a grid D deep, ~16M voxels each to
    bound temporaries (as the JAX engine cuts them)."""
    target = 1 << 24
    n_chunks = 1
    while (D % (2 * n_chunks) == 0) and (D // n_chunks) * H * W > target:
        n_chunks *= 2
    return n_chunks, D // n_chunks


def integrate_frames(
    grid: TSDFGrid,
    depths,  # (F, H, W) raw depth
    poses_cam_to_world,  # (F, 4, 4)
    fx, fy, cx, cy,
    colors=None,  # (F, H, W, 3) in [0,1]
    depth_scale: float = 1000.0,
    depth_max: float = 3.0,
    max_weight: float = 64.0,
) -> TSDFGrid:
    """Integrate a batch of F frames into the grid in one sweep of z-chunks.

    Within a chunk the frame loop runs in order, so sdf/weight are read and
    written once per chunk for the whole batch. Poses are camera->world,
    inverted once. Returns a new grid; the input grid is left as it was.
    """
    return integrate_slab(grid, 0, grid.sdf.shape[0], depths,
                          poses_cam_to_world, fx, fy, cx, cy, colors=colors,
                          depth_scale=depth_scale, depth_max=depth_max,
                          max_weight=max_weight)


def integrate_slab(slab: TSDFGrid, z_lo, grid_depth, depths,
                   poses_cam_to_world, fx, fy, cx, cy, colors=None,
                   depth_scale=1000.0, depth_max=3.0,
                   max_weight=64.0) -> TSDFGrid:
    """:func:`integrate_frames` on the rows ``[z_lo, z_lo + len)`` of a
    grid ``grid_depth`` voxels deep. ``slab`` holds those rows (sdf,
    weight, color) and the whole grid's origin, voxel size and trunc.

    The sweep cuts the whole grid into its z-chunks, gives each chunk its
    own ``z0`` and indexes a voxel by its row in the chunk, so every voxel
    of a slab rounds as it does in the whole grid's sweep, bit for bit,
    wherever the slab's bounds fall. Returns the new slab.
    """
    dev = slab.sdf.device
    Dl, H, W = slab.sdf.shape
    z_hi = z_lo + Dl
    if not 0 <= z_lo <= z_hi <= grid_depth:
        raise ValueError(f"rows [{z_lo}, {z_hi}) are not in a grid "
                         f"{grid_depth} deep")
    depths = torch.as_tensor(depths, dtype=torch.float32, device=dev)
    poses = torch.as_tensor(poses_cam_to_world, dtype=torch.float32, device=dev)
    T_w2c = torch.linalg.inv(poses)
    if colors is not None:
        colors = torch.as_tensor(colors, dtype=torch.float32, device=dev)
    f32 = lambda v: float(np.float32(v))  # noqa: E731  (JAX's jnp.float32)
    depth_scale = scalar_tensor(depth_scale, dev)
    params = (f32(fx), f32(fy), f32(cx), f32(cy), depth_scale, depth_max,
              slab.trunc, max_weight)
    n_chunks, Dc = _chunking(grid_depth, H, W)

    has_color = slab.has_color
    z0s = slab.origin[2] + (
        torch.arange(n_chunks, dtype=torch.float32, device=dev) * Dc
        * slab.voxel_size
    )
    sdf_out = torch.empty_like(slab.sdf)
    w_out = torch.empty_like(slab.weight)
    col_out = torch.empty_like(slab.color) if has_color else slab.color
    for k in range(z_lo // Dc, -(-z_hi // Dc)):
        a, b = max(z_lo, k * Dc), min(z_hi, (k + 1) * Dc)
        sl = slice(a - z_lo, b - z_lo)
        s_k, w_k, c_k = _integrate_chunk(
            slab.sdf[sl], slab.weight[sl],
            slab.color[sl] if has_color else None,
            z0s[k], a - k * Dc, slab.origin, slab.voxel_size, depths,
            colors if has_color else None, T_w2c, params,
        )
        sdf_out[sl] = s_k
        w_out[sl] = w_k
        if has_color:
            col_out[sl] = c_k
    return slab._replace(sdf=sdf_out, weight=w_out, color=col_out)


def extract_surface_points(grid: TSDFGrid, weight_min: float = 1.0,
                           max_points: int = 0):
    """Surface voxel centers (|sdf| < 1 voxel) with validity mask.

    Returns (points (N, 3), valid (N,)) with N = D*H*W. ``max_points`` is
    accepted and unused, as in the JAX function, whose output has that
    fixed shape whatever it is given.
    """
    world = _voxel_world_coords(grid)
    band = grid.voxel_size / grid.trunc
    mask = (grid.sdf.abs() < band) & (grid.weight >= weight_min)
    return world.reshape(-1, 3), mask.reshape(-1)


def raycast_depth(grid: TSDFGrid, T_cam_to_world, fx, fy, cx, cy,
                  height: int, width: int, near: float = 0.1,
                  far: float = 3.0, n_steps: int = 192):
    """Render an (height, width) depth map in meters (0 = no hit) from the
    TSDF by fixed-step ray marching with sign-change interpolation (the
    KinectFusion surface prediction step).

    The arithmetic is the JAX function's, in f32: ray directions as
    explicit three-term sums (not a matmul, whose summation order is the
    BLAS's), the march parameter ``near + i * step`` rounded in f32, the
    nearest-voxel sample, and the first crossing from + to - interpolated
    linearly. Camera z of the ray directions is 1, so ``t`` is the depth.
    """
    dev = grid.sdf.device
    f32 = np.float32
    T = torch.as_tensor(np.asarray(T_cam_to_world, np.float32), device=dev)
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    dc = (((u - float(f32(cx))) / scalar_tensor(f32(fx), dev)).expand(
              height, width),
          ((v - float(f32(cy))) / scalar_tensor(f32(fy), dev)).expand(
              height, width),
          torch.ones((height, width), dtype=torch.float32, device=dev))
    R, eye = T[:3, :3], T[:3, 3]
    dirs = [dc[0] * R[k, 0] + dc[1] * R[k, 1] + dc[2] * R[k, 2]
            for k in range(3)]
    D, H, W = grid.sdf.shape
    inv_vox = 1.0 / grid.voxel_size
    sdf_flat, w_flat = grid.sdf.reshape(-1), grid.weight.reshape(-1)

    def sample_sdf(t):
        g = [(eye[k] + dirs[k] * t - grid.origin[k]) * inv_vox
             for k in range(3)]
        inside = torch.ones_like(g[0], dtype=torch.bool)
        idx = []
        for gk, n in zip(g, (W, H, D)):
            inside &= (gk >= 0) & (gk <= n - 1)
            idx.append(torch.round(gk).to(torch.int32).clamp(0, n - 1))
        flat = ((idx[2] * H + idx[1]) * W + idx[0]).long()
        s = sdf_flat[flat]
        return torch.where(inside & (w_flat[flat] > 0), s, 1.0)

    step = f32((far - near) / n_steps)
    t_hit = torch.full((height, width), -1.0, device=dev)
    prev_s = torch.ones((height, width), device=dev)
    for i in range(n_steps):
        t = f32(near) + f32(i) * step  # f32, as the JAX loop's near + i * step
        s = sample_sdf(float(t))
        crossed = (prev_s > 0) & (s <= 0) & (t_hit < 0)
        frac = prev_s / torch.clamp(prev_s - s, min=1e-9)
        t_cross = float(t - step) + frac * float(step)
        t_hit = torch.where(crossed, t_cross, t_hit)
        prev_s = s
    return torch.where(t_hit > 0, t_hit, 0.0)
