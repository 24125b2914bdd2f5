"""Poisson surface reconstruction via a spectral (FFT) solve.

Port of ``reconplan_tpu.recon.poisson``: ``_trilinear_splat``,
``_trilinear_gather``, ``_poisson_indicator``, ``_sample_iso_field`` and
``poisson_reconstruct``, with ``torch.fft`` full complex transforms in
complex64 as the JAX package has them.

Method (Kazhdan, "Reconstruction of Solid Models from Oriented Point
Sets", SGP 2005 — the Fourier formulation of Poisson reconstruction):
  1. splat the oriented normal field V onto a regular grid (trilinear),
  2. smooth V with a Gaussian in Fourier space,
  3. solve the Poisson equation  div grad chi = div V  spectrally:
     chi_hat(k) = (i k . V_hat(k)) / (-|k|^2),
  4. pick the iso-level as the mean of chi over the input samples,
  5. extract the iso-surface with marching cubes.

The splat is ``index_put_(..., accumulate=True)``: one pass in order on
the CPU, atomic adds in no fixed order on the card, so the card agrees
with the CPU within a tolerance, not bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reconplan_tpu_torch.ops.marching import marching_cubes
from reconplan_tpu_torch.ops.tsdf import TSDFGrid
from reconplan_tpu_torch.utils.device import resolve_device


def _corners(idx_f, shape):
    """The 8 trilinear corners of fractional [x, y, z] coords: (weight,
    zi, yi, xi) each, the indices clipped into the grid."""
    D, H, W = shape
    base = torch.floor(idx_f)
    frac = idx_f - base
    base = base.to(torch.int64)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                yield (w,
                       torch.clamp(base[:, 2] + dz, 0, D - 1),
                       torch.clamp(base[:, 1] + dy, 0, H - 1),
                       torch.clamp(base[:, 0] + dx, 0, W - 1))


def _trilinear_splat(grid_shape, idx_f, values):
    """Scatter-add values (N, C) at fractional grid coords idx_f (N, 3)
    [x, y, z order] into a (D, H, W, C) grid."""
    D, H, W = grid_shape
    out = torch.zeros((D, H, W, values.shape[-1]), dtype=values.dtype,
                      device=values.device)
    for w, zi, yi, xi in _corners(idx_f, grid_shape):
        out.index_put_((zi, yi, xi), values * w[:, None], accumulate=True)
    return out


def _trilinear_gather(vol, idx_f):
    """Sample (D, H, W) volume at fractional [x, y, z] coords (N, 3)."""
    acc = 0.0
    for w, zi, yi, xi in _corners(idx_f, vol.shape):
        acc = acc + vol[zi, yi, xi] * w
    return acc


def _fftfreq(D, scale, device):
    """``jnp.fft.fftfreq(D) * scale`` (scale a 0-d f32 tensor)."""
    return torch.fft.fftfreq(D, device=device) * scale


def _smooth(x, g):
    """real(ifftn(fftn(x) * g))."""
    return torch.fft.ifftn(torch.fft.fftn(x) * g).real


def _poisson_indicator(points, normals, origin, voxel, depth: int,
                       smooth_sigma=0.85, screen=0.0):
    """Solve for the indicator-like field chi on a depth^3 grid.

    The normal field is density-normalized before the solve: the raw
    trilinear splat carries local sampling density as amplitude, so
    densely-sampled high-curvature regions overdrive the divergence and
    bias the iso-surface. Dividing by the smoothed scalar density
    recovers a unit-magnitude surface-delta approximation (Kazhdan's
    density weighting).

    ``screen`` > 0 adds a uniform Tikhonov/screening term: chi_hat =
    div_hat / (-(k2 + screen/extent^2)), damping the weakly-constrained
    low-frequency modes of the pure Poisson solve.

    ``points``, ``normals`` (N, 3), ``origin`` (3,) and ``voxel`` (0-d)
    are f32 tensors on one device. Returns (chi (D, D, D), iso 0-d).
    """
    D = depth
    idx_f = (points - origin) / voxel  # fractional [x, y, z] grid coords

    V = _trilinear_splat((D, D, D), idx_f, normals)  # (D, D, D, 3)
    rho = _trilinear_splat((D, D, D), idx_f,
                           torch.ones_like(points[:, :1]))[..., 0]

    k1 = _fftfreq(D, 2.0 * math.pi / voxel, points.device)
    kz = k1[:, None, None]
    ky = k1[None, :, None]
    kx = k1[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz

    g = torch.exp(-0.5 * (smooth_sigma * voxel) ** 2 * k2)

    # smooth the density with the same kernel, then normalize the
    # (smoothed) normal field where points exist
    rho_s = _smooth(rho, g)
    mean_rho = rho.sum() / torch.clamp(
        (rho_s > 1e-6).to(torch.float32).sum(), min=1.0)
    norm = torch.maximum(rho_s, 0.05 * mean_rho)

    Vx = torch.fft.fftn(_smooth(V[..., 0], g) / norm)
    Vy = torch.fft.fftn(_smooth(V[..., 1], g) / norm)
    Vz = torch.fft.fftn(_smooth(V[..., 2], g) / norm)

    alpha = screen / (D * voxel) ** 2
    div_hat = 1j * (kx * Vx + ky * Vy + kz * Vz)
    zero = k2 == 0
    denom = torch.where(zero, 1.0, -(k2 + alpha))
    chi_hat = torch.where(zero, 0.0, div_hat / denom)
    chi = torch.fft.ifftn(chi_hat).real

    iso = _trilinear_gather(chi, idx_f).mean()
    return chi, iso


def _sample_iso_field(chi, idx_f, depth: int, iso_sigma_frac=0.08):
    """Spatially-varying iso-level: the smooth field of per-sample chi.

    Gather chi at every sample, splat those values (density-weighted)
    onto the grid, smooth both with a wide Gaussian whose width is a
    fraction of the domain, and divide — a smoothly-extrapolated local
    iso-level b(x). The final field chi - b(x) is zero exactly where the
    surface should pass and the shape spectrum is untouched.
    """
    D = depth
    chi_s = _trilinear_gather(chi, idx_f)  # (N,)
    num = _trilinear_splat((D, D, D), idx_f, chi_s[:, None])[..., 0]
    den = _trilinear_splat((D, D, D), idx_f,
                           torch.ones_like(chi_s[:, None]))[..., 0]
    k1 = torch.fft.fftfreq(D, device=chi.device) * 2.0 * math.pi
    k2 = (k1[:, None, None] ** 2 + k1[None, :, None] ** 2
          + k1[None, None, :] ** 2)
    g = torch.exp(-0.5 * (iso_sigma_frac * D) ** 2 * k2)
    num_s = _smooth(num, g)
    den_s = _smooth(den, g)
    global_iso = chi_s.sum() / idx_f.shape[0]
    # far from any sample the ratio degrades to the global iso
    eps = 1e-3 * den_s.abs().max()
    return (num_s + eps * global_iso) / (den_s + eps)


def poisson_reconstruct(points, normals, depth=128, padding=0.2,
                        return_grid=False, screen=4.0, local_iso=False,
                        smooth_sigma=0.85, device=None):
    """Reconstruct a triangle mesh from an oriented point cloud.

    Args:
        points: (N, 3) float array (meters).
        normals: (N, 3) outward-oriented unit normals.
        depth: grid resolution per axis (power of two recommended for FFT).
        padding: bounding-box padding fraction (pushes the periodic wrap
            of the spectral solve away from the surface).
        return_grid: also return the (TSDFGrid-shaped) chi field.
        screen: uniform spectral screening strength (0 = classic Poisson);
            damps the weakly-constrained low-frequency modes (units of
            inverse squared box extents).
        local_iso: subtract the spatially-varying sample-iso field
            (:func:`_sample_iso_field`) instead of one global iso level.
        smooth_sigma: Gaussian pre-smoothing width of the splatted
            normal field, in voxels.
        device: where the solve runs (default: the card); the inputs are
            read on the host for the bounding box.

    Returns triangles (T, 3, 3) world-space on ``device`` (and the grid
    if requested).
    """
    device = resolve_device(device)
    points = np.asarray(torch.as_tensor(points).cpu(), dtype=np.float32)
    normals = np.asarray(torch.as_tensor(normals).cpu(), dtype=np.float32)
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    extent = float((hi - lo).max())
    pad = extent * padding
    origin = torch.as_tensor(lo - pad, dtype=torch.float32, device=device)
    voxel = torch.tensor((extent + 2 * pad) / (depth - 1),
                         dtype=torch.float32, device=device)
    pts = torch.as_tensor(points, device=device)
    chi, iso = _poisson_indicator(
        pts, torch.as_tensor(normals, device=device), origin, voxel, depth,
        smooth_sigma=smooth_sigma, screen=screen)
    # With the indicator convention chi=1 inside and OUTWARD normals n, the
    # smoothed indicator satisfies grad chi = -n*delta, so solving
    # lap chi = div V (V = n*delta) yields chi LOWER inside. marching
    # expects sdf < 0 inside, so (chi - iso) is already correctly signed.
    if local_iso:
        iso = _sample_iso_field(chi, (pts - origin) / voxel, depth)
    field = (chi - iso).to(torch.float32)
    grid = TSDFGrid(
        sdf=field,
        weight=torch.ones_like(field),
        color=torch.zeros((0, 0, 0, 3), dtype=torch.float32, device=device),
        origin=origin,
        voxel_size=voxel,
        trunc=voxel.clone(),
    )
    tris = marching_cubes(grid)
    if return_grid:
        return tris, grid
    return tris
