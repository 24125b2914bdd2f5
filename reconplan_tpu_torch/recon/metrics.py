"""Reconstruction accuracy metrics: Chamfer distance.

Port of ``chamfer_distance`` and ``chamfer_to_mesh`` from
``reconplan_tpu.recon.metrics`` — the accuracy half of the north star
(<= 1 mm Chamfer against the YCB ``011_banana`` mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.io.meshio import sample_mesh_surface
from reconplan_tpu_torch.ops.nn import nearest_neighbor


def chamfer_distance(points_a, points_b, valid_a=None, valid_b=None):
    """Symmetric Chamfer distance between two point sets (meters).

    The average of the two directed mean nearest-neighbour distances.
    Returns (chamfer, directed_ab, directed_ba) as 0-d tensors on
    ``points_a``'s device (the CPU for numpy input).
    """
    device = points_a.device if torch.is_tensor(points_a) else "cpu"
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
                    n_surface_samples=200_000, seed=0):
    """Chamfer between a reconstructed point set and a ground-truth mesh,
    via dense area-weighted surface sampling of the mesh (numpy, seeded),
    on ``points``' device. Returns (chamfer, directed_ab, directed_ba) as
    floats."""
    surf, _ = sample_mesh_surface(mesh_vertices, mesh_faces,
                                  n_surface_samples, seed=seed)
    ch, ab, ba = chamfer_distance(points, surf.astype(np.float32))
    return float(ch), float(ab), float(ba)
