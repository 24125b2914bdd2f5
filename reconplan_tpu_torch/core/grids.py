"""Workspace sampling grids (numpy in, numpy out).

Copy of ``reconplan_tpu.core.grids``: staggered R^3 grids and
Super-Fibonacci SO(3) grids. These build *static* roadmap data once per
problem; the arrays they return are then shipped to the device as padded
roadmaps. The one piece of tensor math, the Euler-to-quaternion
conversion of ``get_so3_grid``, runs on ``device`` (default: the card).

Edges come from ``scipy.spatial.cKDTree`` (position grids) and a
brute-force quaternion-angle top-k (SO(3) grids, tiny N).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def get_staggered_grid(n_points, domain):
    """Staggered (corner + center) grid over a box domain.

    Constant dimensions are held out,
    ~n_points/2 corner points on an odd-count grid per dimension, center
    points at cell midpoints, edges connect corner<->corner at one spacing
    and center->surrounding corners.

    Returns ``(points (N, d), edges (E, 2) int)``.
    """
    domain = [tuple(map(float, d)) for d in domain]
    constant = {i: d[0] for i, d in enumerate(domain) if d[0] == d[1]}
    free_dims = [i for i in range(len(domain)) if i not in constant]
    ranges = np.array([domain[i][1] - domain[i][0] for i in free_dims])
    prop = ranges / ranges.sum()

    n_corners_target = round(n_points / 2)
    p = np.power(n_corners_target / np.prod(prop), 1.0 / len(prop))
    per_dim = [round(pr * p) for pr in prop]
    per_dim = [q + 1 if q % 2 == 0 else q for q in per_dim]
    spacing = ranges[0] / (per_dim[0] - 1)

    corners_1d = [
        np.linspace(domain[i][0], domain[i][1], per_dim[k])
        for k, i in enumerate(free_dims)
    ]
    centers_1d = [
        np.linspace(
            domain[i][0] + spacing / 2, domain[i][1] - spacing / 2,
            per_dim[k] - 1,
        )
        for k, i in enumerate(free_dims)
    ]

    corner_points = np.vstack(
        [m.ravel() for m in np.meshgrid(*corners_1d)]
    ).T
    center_points = np.vstack(
        [m.ravel() for m in np.meshgrid(*centers_1d)]
    ).T
    # re-insert constant dimensions
    for i in sorted(constant):
        corner_points = np.insert(corner_points, i, constant[i], axis=1)
        center_points = np.insert(center_points, i, constant[i], axis=1)

    tree = cKDTree(corner_points)
    edges = []
    # corner-corner edges within one spacing
    pairs = tree.query_pairs(spacing * 1.01, output_type="ndarray")
    edges.extend([(int(i), int(j)) for i, j in pairs])
    # center-corner edges within one spacing
    n_corners = len(corner_points)
    for ci, cpt in enumerate(center_points):
        for j in tree.query_ball_point(cpt, spacing):
            edges.append((ci + n_corners, int(j)))

    points = np.vstack([corner_points, center_points])
    return points, np.asarray(edges, dtype=np.int64)


def super_fibonacci_so3(n_points):
    """Super-Fibonacci low-discrepancy SO(3) sampling.

    Marc Alexa, "Super-Fibonacci Spirals: Fast, Low-Discrepancy Sampling of
    SO(3)", CVPR 2022. Returns quaternions (n, 4) xyzw.
    """
    phi = np.sqrt(2.0)
    psi = 1.533751168755204288118041
    s = np.arange(n_points, dtype=np.float64) + 0.5
    t = s / n_points
    r1 = np.sqrt(t)
    r2 = np.sqrt(1.0 - t)
    alpha = 2.0 * np.pi * s / phi
    beta = 2.0 * np.pi * s / psi
    return np.stack(
        [
            r1 * np.sin(alpha),
            r1 * np.cos(alpha),
            r2 * np.sin(beta),
            r2 * np.cos(beta),
        ],
        axis=-1,
    )


def _quaternion_angle_np(q1, q2):
    d = np.minimum(np.abs(q1 @ q2.T), 1.0)
    return 2.0 * np.arccos(d)


def get_so3_grid(n_points, rot_domain, fixed_rotation_euler, num_neighbors,
                 device=None):
    """Uniform SO(3) grid + k-NN edges.

    * 1 free rotation axis: evenly spaced angles in [-pi, pi) on that axis,
      other axes held at ``fixed_rotation_euler``.
    * 3 free axes: Super-Fibonacci quaternions.
    Edges connect each point to its ``num_neighbors`` nearest by quaternion
    arc length (brute force; dedup i < j).

    Returns ``(quats (n, 4), edges (E, 2) int)``.
    """
    from reconplan_tpu_torch.core import maths
    from reconplan_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    rot_domain = list(rot_domain)
    n_free = int(np.sum(rot_domain))
    if n_free == 0:
        raise ValueError("No domain is specified for rotation grid")
    if n_free == 1:
        angles = np.linspace(-np.pi, np.pi, n_points, endpoint=False)
        eulers = np.tile(
            np.asarray(fixed_rotation_euler, dtype=np.float64), (n_points, 1))
        eulers[:, rot_domain.index(1)] = angles
        quats = maths.euler_to_quat(
            eulers, seq=maths.PROBLEM_EULER_SEQ, device=device).cpu().numpy()
    elif n_free == 3:
        quats = super_fibonacci_so3(n_points)
    else:
        raise NotImplementedError("2-axis rotation grids not supported")

    ang = _quaternion_angle_np(np.asarray(quats), np.asarray(quats))
    np.fill_diagonal(ang, np.inf)
    order = np.argsort(ang, axis=1)[:, :num_neighbors]
    edges = []
    for i in range(len(quats)):
        for j in order[i]:
            if i < j:
                edges.append((i, int(j)))
    return np.asarray(quats), np.asarray(edges, dtype=np.int64)
