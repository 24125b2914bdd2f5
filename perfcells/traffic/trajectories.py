"""Teleop target trajectories, frozen.

The ``circle_random`` kind of the reference's trajectory generator
(Expansion-GRR ``trajectory_generator.py:20-249``, ported as the port's
``grr/experiment.generate_trajectories``): the start is a workspace
sample of the problem's domain (a uniform position, the fixed rotation
with a uniform yaw), the goal another sample's rotation at a position
within a fifth of the domain's smallest side of the start, and the pair
is kept when an IK reaches both endpoints. Start and goal are the
diameter of a circle whose plane comes from a random up-vector, the
rotation slerps start -> goal -> start, the loop closes at the start; 4 s
at 50 Hz gives 202 targets.

The reference asks its robot's IK whether an endpoint is reachable
(three random restarts; converged, above the floor, free of self
collision). Here the plain IK of ``reference/kinematics.py`` answers, so
that the traffic does not depend on the system under test: three random
restarts within the joint limits, converged to the reference's
tolerance, every active joint's origin above the floor. It has no
self-collision model. Nothing else is filtered: a circle may leave the
arm's reach between its endpoints, as the reference's do.
"""

from __future__ import annotations

import numpy as np


def _unit(rng):
    while True:
        v = rng.normal(0, 1, 3)
        n = np.linalg.norm(v)
        if n > 1e-6:
            return v / n


def _rotation(axis, angle):
    """(K, 3, 3) rotations about one unit axis by each angle (Rodrigues)."""
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    s, c = np.sin(angle)[:, None, None], np.cos(angle)[:, None, None]
    return np.eye(3) + s * k + (1 - c) * (k @ k)


def _slerp(q1, q2, u):
    q1 = q1 / np.linalg.norm(q1)
    q2 = q2 / np.linalg.norm(q2)
    dot = float(np.dot(q1, q2))
    if dot < 0:
        q2, dot = -q2, -dot
    theta = np.arccos(min(dot, 1.0))
    if np.sin(theta) < 1e-6:
        q = (1 - u)[:, None] * q1 + u[:, None] * q2
    else:
        q = (np.sin((1 - u) * theta)[:, None] * q1
             + np.sin(u * theta)[:, None] * q2) / np.sin(theta)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def circle_path(start, goal, n_points, rng):
    """(n_points + 2, 7) targets of one closed circle."""
    start = np.asarray(start, dtype=np.float64)
    goal = np.asarray(goal, dtype=np.float64)
    center = (start[:3] + goal[:3]) / 2
    diameter = goal[:3] - start[:3]
    dn = diameter / max(np.linalg.norm(diameter), 1e-9)
    up = _unit(rng)
    while np.isclose(abs(np.dot(up, dn)), 1.0):
        up = _unit(rng)
    base = np.cross(diameter, up)
    base /= max(np.linalg.norm(base), 1e-9)
    angles = np.linspace(0, 2 * np.pi, n_points + 1, endpoint=True)
    path = center + _rotation(base, angles) @ (start[:3] - center)
    u = 2 * np.arange(n_points + 1) / n_points
    u = np.where(u > 1, 2 - u, u)
    path = np.concatenate([path, _slerp(start[3:7], goal[3:7], u)], axis=-1)
    return np.concatenate([path, path[:1]]).astype(np.float32)


def yaw_pose(position, fixed_rpy, yaw):
    """(7,) xyz + xyzw: the fixed roll and pitch, the yaw replaced
    (extrinsic x-y-z Euler angles, R = Rz(yaw) Ry(pitch) Rx(roll))."""
    def axis_quat(i, a):
        q = np.zeros(4)
        q[i], q[3] = np.sin(a / 2), np.cos(a / 2)
        return q

    q = axis_quat(0, fixed_rpy[0])
    for i, a in ((1, fixed_rpy[1]), (2, yaw)):
        q = _quat_mul(axis_quat(i, a), q)
    return np.concatenate([position, q])


def _quat_mul(a, b):
    """Hamilton product of xyzw quaternions."""
    v = a[3] * b[:3] + b[3] * a[:3] + np.cross(a[:3], b[:3])
    return np.append(v, a[3] * b[3] - np.dot(a[:3], b[:3]))


def workspace_sample(rng, domain, fixed_rpy):
    """One workspace point of a variable-yaw problem."""
    pos = np.array([rng.uniform(a, b) for a, b in domain])
    return yaw_pose(pos, fixed_rpy, rng.uniform(-np.pi, np.pi))


def reachable(chain, points, rng, rounds=3, tol=1e-3, iters=100,
              floor_z=0.0):
    """(N,) whether the plain IK reaches each of ``points`` (N, 7) from one
    of ``rounds`` random starts within the joint limits, ending within
    the limits with every active joint's origin above ``floor_z``."""
    lo = np.where(chain.cyclic, -np.pi, chain.qmin)
    hi = np.where(chain.cyclic, np.pi, chain.qmax)
    pts = np.asarray(points, dtype=np.float64)
    ok = np.zeros(len(pts), dtype=bool)
    for _ in range(rounds):
        rows = np.flatnonzero(~ok)
        if not len(rows):
            break
        q0 = rng.uniform(lo, hi, (len(rows), len(lo)))
        q, conv = chain.ik(q0, pts[rows], iters=iters, tol=tol)
        _, _, (_, origins) = chain.fk(q, frames=True)
        inside = np.all(chain.cyclic | ((q >= chain.qmin)
                                        & (q <= chain.qmax)), axis=1)
        ok[rows] = conv & inside & np.all(origins[..., 2] > floor_z, axis=1)
    return ok


def circle_random(chain, domain, fixed_rpy, n_trajectories, seed,
                  duration=4.0, hz=50, batch=1024, floor_z=0.0):
    """``n_trajectories`` (202, 7) f32 target circles from ``seed``.

    ``domain`` is the problem's box [[lo, hi]] * 3, ``fixed_rpy`` its
    fixed rotation (roll, pitch, yaw) of which the yaw varies; ``chain``
    the plain kinematics whose IK decides an endpoint's reach."""
    rng = np.random.default_rng(seed)
    n_points = max(int(duration * hz), 1)
    thresh = 0.2 * min(b - a for a, b in domain)
    out = []
    while len(out) < n_trajectories:
        starts = np.stack([workspace_sample(rng, domain, fixed_rpy)
                           for _ in range(batch)])
        goals = np.stack([workspace_sample(rng, domain, fixed_rpy)
                          for _ in range(batch)])
        dist = rng.uniform(0, thresh, size=batch)
        dirs = np.stack([_unit(rng) for _ in range(batch)])
        goals[:, :3] = starts[:, :3] + dist[:, None] * dirs
        ok = reachable(chain, starts, rng, floor_z=floor_z)
        ok[ok] = reachable(chain, goals[ok], rng, floor_z=floor_z)
        for i in np.flatnonzero(ok):
            if len(out) < n_trajectories:
                out.append(circle_path(starts[i], goals[i], n_points, rng))
    return out
