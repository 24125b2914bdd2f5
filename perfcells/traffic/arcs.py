"""The scan's viewpoint arcs, frozen.

A numpy copy of the port's ``grr/paths.scan_arc`` and
``apps/scan.make_arc_schedule``: tilted half-circles of look-at poses
over the object (the reference's ``main.py:68-136`` arc). Poses are
``(x, y, z, qx, qy, qz, qw)``; the look-at quaternion is the port's
``core/maths.look_at_quat`` (the transposed frame's euler ZYX with its yaw
zeroed) worked out in closed form.
"""

from __future__ import annotations

import numpy as np

OBJECT_POINT = (0.75, 0.75, 0.0)  # the reference's main.py:45
BASE_AZIMUTH = 3 * np.pi / 4


def look_at_quat(eyes, target):
    """(N, 4) xyzw quaternions of the scan arc's look-at frames."""
    eyes = np.asarray(eyes, dtype=np.float64)
    z = np.asarray(target, dtype=np.float64) - eyes
    z = z / np.linalg.norm(z, axis=-1, keepdims=True)
    # the rows x, y, z of the port's transposed frame form m; its euler
    # ZYX angles (yaw atan2(m10, m00), pitch asin(-m20), roll atan2(m21,
    # m22)) read only the z row, and the yaw is zeroed
    pitch = np.arcsin(np.clip(-z[:, 0], -1.0, 1.0))
    roll = np.arctan2(z[:, 1], z[:, 2])
    sy, cy = np.sin(pitch / 2), np.cos(pitch / 2)
    sx, cx = np.sin(roll / 2), np.cos(roll / 2)
    # q_y(pitch) * q_x(roll), Hamilton product, xyzw
    return np.stack([cy * sx, sy * cx, -sy * sx, cy * cx], axis=-1)


def scan_arc(obj_pos, radius=0.3, height=0.15, num_points=500,
             azimuth=BASE_AZIMUTH, max_horiz=None):
    """(num_points, 7) f32 look-at poses along one arc."""
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
    quats = look_at_quat(eyes, obj).astype(np.float32)
    return np.concatenate([eyes, quats], axis=-1)


def make_arc_schedule(n_arcs, per_arc, base_az=BASE_AZIMUTH):
    """The scan's arcs: one arc is the reference demo's overhead arc (r
    0.3 m, h 0.15 m); more alternate MID (r 0.25, h 0.10) and LOW grazing
    (r 0.22, h 0.035) arcs spread over 360 degrees of azimuth, inside the
    UR10's look-at reach."""
    if n_arcs <= 1:
        return [scan_arc(OBJECT_POINT, radius=0.3, height=0.15,
                         num_points=per_arc, azimuth=base_az)]
    return [
        scan_arc(
            OBJECT_POINT,
            radius=0.25 if a % 2 == 0 else 0.22,
            height=0.10 if a % 2 == 0 else 0.035,
            num_points=per_arc,
            azimuth=base_az + a * 2 * np.pi / n_arcs,
            max_horiz=1.03,
        )
        for a in range(n_arcs)
    ]


def seeded_azimuth(seed, turn):
    """The base azimuth a seed gives: ``BASE_AZIMUTH`` turned by a uniform
    draw from ``turn`` = [low, high] radians."""
    rng = np.random.default_rng(seed)
    return BASE_AZIMUTH + float(rng.uniform(*turn))
