"""Capsule and sphere-cloud self-collision checking.

Port of ``reconplan_tpu.kin.collision``. Klampt checks mesh pairs; here
each link mesh (.off) is fitted once on the host, with a principal-axis
capsule or a covering sphere cloud, and a configuration's collision check
is a handful of distances: branch-free and batch-first (leading
dimensions of the link transforms are the batch), so one call checks a
whole batch of configurations on the device. The two fitting functions
are numpy f64, copied verbatim, so both packages fit the same shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reconplan_tpu_torch.core.maths import rotate_points
from reconplan_tpu_torch.kin.chain import _matvec3
from reconplan_tpu_torch.utils.device import resolve_device


class Capsule(NamedTuple):
    """Capsule in link-local coordinates: segment [a, b] with radius r."""

    a: torch.Tensor  # (3,)
    b: torch.Tensor  # (3,)
    r: torch.Tensor  # ()


def fit_capsule_off(vertices: np.ndarray, radius_quantile: float = 0.75,
                    device=None) -> Capsule:
    """Fit a capsule to mesh vertices via PCA.

    The axis is the principal component; endpoints are the extreme
    projections; the radius is the ``radius_quantile`` of radial distances.
    A max-radius capsule over-approximates so badly (joint housings inflate
    the radius) that valid working configurations get rejected; 0.75
    keeps the accept/reject behavior of a mesh check on the UR10 scan-arc
    workload while still catching true interpenetrations. The tensors land
    on ``device`` (default: the card).
    """
    v = np.asarray(vertices, dtype=np.float64)
    c = v.mean(axis=0)
    centered = v - c
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    axis = vt[0]
    proj = centered @ axis
    a = c + axis * proj.min()
    b = c + axis * proj.max()
    radial = np.linalg.norm(centered - np.outer(proj, axis), axis=1)
    r = np.quantile(radial, radius_quantile)
    device = resolve_device(device)
    return Capsule(*(torch.as_tensor(np.asarray(x, dtype=np.float32),
                                     device=device) for x in (a, b, r)))


def _dot(a, b):
    return (a * b).sum(dim=-1)


def segment_segment_distance(p1, q1, p2, q2, eps=1e-9):
    """Minimum distance between segments [p1,q1] and [p2,q2], each (..., 3).

    Branch-free version of the classic clamped closest-point algorithm
    (Ericson, Real-Time Collision Detection §5.1.9), so it broadcasts over
    leading dimensions.
    """
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b

    # general (non-parallel, non-degenerate) candidates
    s_gen = torch.where(denom > eps,
                        (b * f - c * e) / torch.clamp(denom, min=eps), 0.0)
    s = torch.clamp(s_gen, 0.0, 1.0)
    t = (b * s + f) / torch.clamp(e, min=eps)
    t_clamped = torch.clamp(t, 0.0, 1.0)
    s2 = torch.clamp((b * t_clamped - c) / torch.clamp(a, min=eps), 0.0, 1.0)
    # degenerate segments fall back to point projections
    s2 = torch.where(a <= eps, 0.0, s2)
    t_clamped = torch.where(e <= eps, 0.0, t_clamped)

    closest1 = p1 + d1 * s2[..., None]
    closest2 = p2 + d2 * t_clamped[..., None]
    return torch.linalg.norm(closest1 - closest2, dim=-1)


def pairwise_segment_distances(caps_a_world, caps_b_world):
    """(..., Na, 2, 3) x (..., Nb, 2, 3) -> (..., Na, Nb) segment-segment
    distances."""
    a = caps_a_world[..., :, None, :, :]
    b = caps_b_world[..., None, :, :, :]
    return segment_segment_distance(a[..., 0, :], a[..., 1, :],
                                    b[..., 0, :], b[..., 1, :])


def capsule_group_collision(
    caps_a_world,  # (..., Na, 2, 3) world segments
    radii_a,  # (Na,)
    caps_b_world,  # (..., Nb, 2, 3)
    radii_b,  # (Nb,)
    thresholds=None,  # (Na, Nb) optional per-pair collision distances
):
    """(...,) bool: whether any capsule in group A intersects any capsule
    in group B.

    Capsules over-approximate meshes, so pairs that are geometrically
    close in every configuration (wrist <-> gripper base) would
    false-positive with raw ``r_a + r_b`` thresholds; callers pass a
    calibrated ``thresholds`` matrix instead, the capsule analogue of a
    MoveIt allowed-collision matrix.
    """
    d = pairwise_segment_distances(caps_a_world, caps_b_world)
    if thresholds is None:
        thresholds = radii_a[:, None] + radii_b[None, :]
    return (d < thresholds).any(dim=-1).any(dim=-1)


def transform_capsules(R, t, caps_a, caps_b):
    """Move local capsule endpoints (N, 3) pairs into world frame given link
    rotations R (..., N, 3, 3) and origins t (..., N, 3): (..., N, 2, 3)."""
    a_w = _matvec3(R, caps_a) + t
    b_w = _matvec3(R, caps_b) + t
    return torch.stack([a_w, b_w], dim=-2)


# ----------------------------------------------------------------------
# sphere-cloud collision (tight over-approximation)
# ----------------------------------------------------------------------
#
# Single capsules over-approximate long link meshes so coarsely that the
# scan-arc workload rejects configurations whose true mesh clearance is
# >6 cm (the forearm <-> gripper pair fires at capsule distance 0.095 m
# when the meshes are 0.063 m apart). A mesh-pair check has no false
# negatives; the equivalent with the same guarantee is a k-means sphere
# cloud per link: every mesh vertex lies inside its cluster's sphere, so
# the union of spheres contains the mesh surface and a sum-of-radii test
# can only err on the conservative side — by the cluster radius margin
# (~1-2 cm at 24 spheres/link) instead of the whole-link capsule radius
# (~10 cm). The check itself is a dense (La*S, Lb*S) distance matrix:
# branch-free and batched.

# radius marking an inert (padding / empty-cluster) sphere; large enough
# negative that d - r_i - r_j can never go below any sane threshold
PAD_RADIUS = -1e6


def fit_spheres_off(
    vertices: np.ndarray, n_spheres: int = 24, n_iters: int = 12
):
    """Fit a covering sphere cloud to mesh vertices.

    Deterministic farthest-point initialisation + Lloyd iterations;
    each sphere's radius is the max distance of its cluster's vertices
    (cover guarantee). Returns (centers (S, 3), radii (S,)) float32; S
    may be < ``n_spheres`` for tiny meshes.
    """
    v = np.asarray(vertices, dtype=np.float64)
    n = min(n_spheres, len(v))
    # farthest-point seeding from the centroid-nearest vertex
    c0 = np.argmin(np.linalg.norm(v - v.mean(axis=0), axis=1))
    centers_idx = [c0]
    d = np.linalg.norm(v - v[c0], axis=1)
    for _ in range(1, n):
        nxt = int(np.argmax(d))
        centers_idx.append(nxt)
        d = np.minimum(d, np.linalg.norm(v - v[nxt], axis=1))
    centers = v[centers_idx]
    for _ in range(n_iters):
        d2 = ((v[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = np.argmin(d2, axis=1)
        for k in range(n):
            m = assign == k
            if m.any():
                centers[k] = v[m].mean(axis=0)
    d2 = ((v[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    assign = np.argmin(d2, axis=1)
    # empty clusters (stale Lloyd centers) are marked inert so they can
    # never fire a collision test
    radii = np.full(n, PAD_RADIUS)
    for k in range(n):
        m = assign == k
        if m.any():
            radii[k] = np.sqrt(d2[m, k].max())
    return centers.astype(np.float32), radii.astype(np.float32)


def transform_spheres(R, t, centers):
    """(..., L, 3, 3), (..., L, 3), (L, S, 3) local centers -> (..., L, S,
    3) world, in full f32 (no matmul)."""
    return rotate_points(R, centers) + t[..., :, None, :]


def sphere_group_clearance(centers_a, radii_a, centers_b, radii_b):
    """Per-link-pair signed clearance between two sphere-cloud groups.

    ``centers_*``: (..., L, S, 3) world-frame; ``radii_*``: (L, S).
    Returns (..., La, Lb) of ``min over sphere pairs of (|c_i - c_j| - r_i
    - r_j)``; negative means the clouds of that link pair overlap. Inert
    spheres (radius == PAD_RADIUS) yield huge clearances and never
    dominate the min.
    """
    a = centers_a[..., :, :, None, None, :]
    b = centers_b[..., None, None, :, :, :]
    # the three squared differences added in turn: the (..., La, S, Lb, S,
    # 3) difference tensor is never made
    d2 = sum((a[..., k] - b[..., k]) ** 2 for k in range(3))
    d = torch.sqrt(torch.clamp(d2, min=0.0))  # (..., La, S, Lb, S)
    clr = d - radii_a[:, :, None, None] - radii_b[None, None, :, :]
    return clr.amin(dim=(-3, -1))  # (..., La, Lb)


def sphere_group_collision(
    centers_a, radii_a, centers_b, radii_b, thresholds=None
):
    """(...,) bool: whether any link of group A collides with any link of
    group B.

    Collision for a link pair = signed clearance below its threshold
    (default 0: actual sphere-cloud overlap). ``thresholds`` (La, Lb) is
    the sphere analogue of a MoveIt allowed-collision matrix: pairs that
    are adjacent at the home configuration get a slightly-below-home
    threshold so the permanently-close wrist <-> gripper-base pair does
    not fire (see ``Robot._calibrate_collision_thresholds``).
    """
    clr = sphere_group_clearance(centers_a, radii_a, centers_b, radii_b)
    if thresholds is None:
        thresholds = torch.zeros_like(clr)
    return (clr < thresholds).any(dim=-1).any(dim=-1)
