"""Reconstruction accuracy metrics: Chamfer distance and exact
point-to-mesh distance.

Port of ``chamfer_distance``, ``chamfer_to_mesh`` and
``points_to_mesh_distance`` from ``reconplan_tpu.recon.metrics`` — the
accuracy half of the north star (<= 1 mm Chamfer against the YCB
``011_banana`` mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.io.meshio import sample_mesh_surface
from reconplan_tpu_torch.ops.nn import knn, nearest_neighbor
from reconplan_tpu_torch.utils.device import resolve_device


def _input_device(points, device):
    """A tensor keeps its device; numpy input goes to ``device`` (``None``:
    the card)."""
    return points.device if torch.is_tensor(points) else resolve_device(device)


def chamfer_distance(points_a, points_b, valid_a=None, valid_b=None,
                     device=None):
    """Symmetric Chamfer distance between two point sets (meters).

    The average of the two directed mean nearest-neighbour distances.
    Returns (chamfer, directed_ab, directed_ba) as 0-d tensors on
    ``points_a``'s device (for numpy input: ``device``, by default the
    card).
    """
    device = _input_device(points_a, device)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    points_a = as_t(points_a, torch.float32)
    points_b = as_t(points_b, torch.float32)
    if valid_a is not None:
        valid_a = as_t(valid_a, torch.bool)
    if valid_b is not None:
        valid_b = as_t(valid_b, torch.bool)
    d_ab, _ = nearest_neighbor(points_a, points_b, valid=valid_b)
    d_ba, _ = nearest_neighbor(points_b, points_a, valid=valid_a)

    def directed_mean(d, valid):
        if valid is None:
            return d.mean()
        w = valid.float()
        return (d * w).sum() / torch.clamp(w.sum(), min=1.0)

    mean_ab = directed_mean(d_ab, valid_a)
    mean_ba = directed_mean(d_ba, valid_b)
    return 0.5 * (mean_ab + mean_ba), mean_ab, mean_ba


def chamfer_to_mesh(points, mesh_vertices, mesh_faces,
                    n_surface_samples=200_000, seed=0, device=None):
    """Chamfer between a reconstructed point set and a ground-truth mesh,
    via dense area-weighted surface sampling of the mesh (numpy, seeded),
    on ``points``' device (for numpy ``points``: ``device``, by default the
    card). Returns (chamfer, directed_ab, directed_ba) as floats."""
    surf, _ = sample_mesh_surface(mesh_vertices, mesh_faces,
                                  n_surface_samples, seed=seed)
    ch, ab, ba = chamfer_distance(points, surf.astype(np.float32),
                                  device=device)
    return float(ch), float(ab), float(ba)


def _closest_point_on_triangles(p, tri):
    """Exact squared distance from each query point to each of its k
    triangles. ``p``: (..., 3), ``tri``: (..., k, 3, 3); returns (..., k).

    Ericson, *Real-Time Collision Detection* §5.1.5, branchless over all 7
    Voronoi regions, in the JAX function's order of operations (which
    takes one point at a time and is vmapped)."""
    p = p[..., None, :]
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab, ac, ap = b - a, c - a, p - a
    dot = lambda x, y: (x * y).sum(-1)  # noqa: E731
    d1, d2 = dot(ab, ap), dot(ac, ap)
    bp = p - b
    d3, d4 = dot(ab, bp), dot(ac, bp)
    cp = p - c
    d5, d6 = dot(ab, cp), dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-30)
    v_face, w_face = vb / denom, vc / denom
    q = a + v_face[..., None] * ab + w_face[..., None] * ac  # interior

    def region(cond, point):
        return torch.where(cond[..., None], point, q)

    t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-30), 0.0, 1.0)
    q = region((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + t_ab[..., None] * ab)
    t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-30), 0.0, 1.0)
    q = region((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + t_ac[..., None] * ac)
    t_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6),
                                               min=1e-30), 0.0, 1.0)
    q = region((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0),
               b + t_bc[..., None] * (c - b))
    q = region((d1 <= 0) & (d2 <= 0), a)  # vertex regions
    q = region((d3 >= 0) & (d4 <= d3), b)
    q = region((d6 >= 0) & (d5 <= d6), c)
    return ((p - q) ** 2).sum(-1)


def points_to_mesh_distance(points, triangles, k=16, row_chunk=2048,
                            device=None):
    """Exact distance (meters) from each query point to a triangle soup:
    the mesh is a continuous surface here, not a point sample, so this
    direction has no sampling floor and sees missing surface.

    Candidate triangles are the ``k`` nearest by centroid
    (:func:`~reconplan_tpu_torch.ops.nn.knn`); each point's distance is
    the least exact point-triangle distance among them. ``points`` (Q, 3)
    and ``triangles`` (T, 3, 3) as tensors or numpy; returns a (Q,) f32
    tensor on ``points``' device (for numpy input: ``device``, by default
    the card).
    """
    device = _input_device(points, device)
    points = torch.as_tensor(points, dtype=torch.float32, device=device)
    triangles = torch.as_tensor(triangles, dtype=torch.float32,
                                device=device)
    cent = triangles.mean(dim=1)
    _, idx = knn(points, cent, min(k, cent.shape[0]), row_chunk=row_chunk)
    out = []
    for s in range(0, points.shape[0], row_chunk):
        sl = slice(s, s + row_chunk)
        d2 = _closest_point_on_triangles(points[sl], triangles[idx[sl]])
        out.append(torch.sqrt(d2.min(dim=-1).values))
    return torch.cat(out)
