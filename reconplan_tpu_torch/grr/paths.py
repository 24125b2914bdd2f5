"""Geometric Cartesian path generators.

Port of ``reconplan_tpu.grr.paths``: arc and linear paths with SLERP
rotation; used by demos and the trajectory generator. Vectorized: each
returns all waypoints in one shot. Numpy in and numpy out; the f32
quaternion math (``core.maths``) runs on ``device`` (default: the card,
as the reference runs it on its default device; ``device="cpu"`` asks
for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.utils.device import resolve_device


def _f32(a, device):
    """A numpy array as an f32 tensor on ``device`` (as ``jnp.asarray``
    makes f32 of f64)."""
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _np(x):
    return x.cpu().numpy()


def arc_interpolate(start, axis, u, device=None):
    """Rotate ``start`` (pos [+quat]) about an axis line by u * angle.
    ``axis`` = [px, py, pz, rx, ry, rz]
    (point on axis + rotation vector)."""
    device = resolve_device(device)
    start = np.asarray(start, dtype=np.float64)
    axis = np.asarray(axis, dtype=np.float64)
    R = _np(maths.quat_to_matrix(
        maths.rotvec_to_quat(_f32(axis[3:] * u, device))))
    point = R @ (start[:3] - axis[:3]) + axis[:3]
    if len(start) > 3:
        Rs = _np(maths.quat_to_matrix(_f32(start[3:7], device)))
        quat = _np(maths.matrix_to_quat(_f32(R @ Rs, device)))
        return np.concatenate([point, quat])
    return point


def linear_interpolate(start, goal, u, device=None):
    """Lerp position + slerp rotation."""
    device = resolve_device(device)
    start = np.asarray(start, dtype=np.float64)
    goal = np.asarray(goal, dtype=np.float64)
    point = start[:3] + u * (goal[:3] - start[:3])
    if len(start) > 3:
        quat = _np(maths.slerp(_f32(start[3:7], device),
                               _f32(goal[3:7], device), u))
        return np.concatenate([point, quat])
    return point


def get_arc_path(start, axis, path_duration, num_points, device=None):
    """Timestamped arc path."""
    device = resolve_device(device)
    assert path_duration > 0, "Path duration must be greater than 0."
    assert num_points > 2, "Number of points must be greater than 2."
    return [
        (path_duration * (i / (num_points - 1)),
         arc_interpolate(start, axis, i / (num_points - 1), device))
        for i in range(num_points)
    ]


def get_linear_path(start, goal, path_duration, num_points, device=None):
    """Timestamped linear path."""
    device = resolve_device(device)
    assert path_duration > 0, "Path duration must be greater than 0."
    assert num_points > 2, "Number of points must be greater than 2."
    return [
        (path_duration * (i / (num_points - 1)),
         linear_interpolate(start, goal, i / (num_points - 1), device))
        for i in range(num_points)
    ]


def scan_arc(obj_pos, radius=0.3, height=0.15, num_points=500,
             azimuth=3 * np.pi / 4, max_horiz=None, device=None):
    """The flagship scan arc: a tilted half-circle of look-at poses over
    the object. Returns (num_points, 7) poses.

    ``azimuth`` orients the vertical plane the arc sweeps through. A
    single arc only observes the object's top and two ends; sweeping
    additional rotated arcs covers the flanks a one-arc scan never
    sees.

    ``max_horiz``, when set, clamps each eye's horizontal distance from
    the robot base (origin) by sliding it radially inward — coverage
    planning that respects the arm's reach envelope: the far side of an
    arc around an off-center object otherwise sweeps outside the UR10's
    ~1.1 m comfortable look-at reach and no solver can configure it.
    """
    device = resolve_device(device)
    obj = np.asarray(obj_pos, dtype=np.float64)
    t = np.linspace(0, np.pi, num_points)
    x = obj[0] - 0.15 * np.cos(np.pi / 4) + radius * np.cos(t) * np.cos(azimuth)
    y = obj[1] - 0.15 * np.cos(np.pi / 4) + radius * np.cos(t) * np.sin(azimuth)
    z = height + obj[2] + radius * np.sin(t)
    if max_horiz is not None:
        h = np.hypot(x, y)
        s = np.minimum(1.0, max_horiz / np.maximum(h, 1e-9))
        x, y = x * s, y * s
    eyes = np.stack([x, y, z], axis=-1).astype(np.float32)
    quats = _np(maths.look_at_quat(_f32(eyes, device), _f32(obj, device)))
    return np.concatenate([eyes, quats], axis=-1)
