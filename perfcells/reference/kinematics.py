"""Forward kinematics of a Klampt ``.rob`` chain, in float64 numpy.

Reads ``links``, ``parents``, ``axis``, ``jointtype``, ``Tparent`` (a 3x3
rotation in row-major order, then a translation), ``qmin`` and ``qmax``.
A revolute joint turns its link about ``axis`` in the link's frame, a
prismatic one slides along it. The active joints are given; the rest
stay at 0. Checked against the golden
``data/golden/ctraj.txt`` -> ``wtraj.txt`` pairs (the reference robot's own
FK) in the harness's tests.
"""

from __future__ import annotations

import re

import numpy as np

_TOKEN = re.compile(r'"([^"]*)"|(\S+)')


def _fields(path):
    out, buf = {}, ""
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].rstrip()
            if line.endswith("\\"):
                buf += line[:-1] + " "
                continue
            buf += line
            toks = [m.group(1) if m.group(1) is not None else m.group(2)
                    for m in _TOKEN.finditer(buf)]
            buf = ""
            if toks:
                out.setdefault(toks[0].lower(), toks[1:])
    return out


def _floats(toks):
    return np.array([float(t) for t in toks])


class Chain:
    """One robot's kinematic tree."""

    def __init__(self, path, ee_link, active):
        f = _fields(path)
        self.links = f["links"]
        self.parents = [int(p) for p in f["parents"]]
        self.axes = _floats(f["axis"]).reshape(-1, 3)
        self.prismatic = [t.lower() == "p" for t in f["jointtype"]]
        tp = _floats(f["tparent"]).reshape(-1, 12)
        self.R_parent = tp[:, :9].reshape(-1, 3, 3)
        self.t_parent = tp[:, 9:]
        qmin, qmax = _floats(f["qmin"]), _floats(f["qmax"])
        self.active = list(active)
        self.qmin, self.qmax = qmin[self.active], qmax[self.active]
        self.cyclic = np.array([np.isinf(qmin[i]) or np.isinf(qmax[i])
                                for i in self.active])
        self.ee = self.links.index(ee_link)
        # the links from the root to the end effector, root first
        path_ = [self.ee]
        while self.parents[path_[-1]] >= 0:
            path_.append(self.parents[path_[-1]])
        self.path = path_[::-1]

    def fk(self, q_active, frames=False):
        """(N, A) active joint values -> (R (N, 3, 3), t (N, 3)) of the end
        effector in the world; with ``frames``, also each active joint's
        world axis and origin, (N, A, 3) each."""
        q_active = np.asarray(q_active, dtype=np.float64)
        N = q_active.shape[0]
        q = np.zeros((N, len(self.links)))
        q[:, self.active] = q_active
        R = np.broadcast_to(np.eye(3), (N, 3, 3)).copy()
        t = np.zeros((N, 3))
        axes, origins = {}, {}
        for i in self.path:
            if self.prismatic[i]:
                Rj = np.broadcast_to(np.eye(3), (N, 3, 3))
                tj = self.axes[i] * q[:, i:i + 1]
            else:
                Rj = axis_rotation(self.axes[i], q[:, i])
                tj = np.zeros((N, 3))
            t = R @ self.t_parent[i] + t
            R = R @ self.R_parent[i]
            axes[i], origins[i] = R @ self.axes[i], t.copy()
            t = np.einsum("nij,nj->ni", R, tj) + t
            R = R @ Rj
        if not frames:
            return R, t
        return R, t, (np.stack([axes[i] for i in self.active], 1),
                      np.stack([origins[i] for i in self.active], 1))

    def ik(self, q0, targets, iters=60, tol=1e-6, damping=1e-4):
        """Damped least squares from ``q0`` (N, A) to poses ``targets``
        (N, 7) xyz + xyzw, revolute joints only, every row at once.
        Returns (q (N, A), converged (N,))."""
        Rt = quat_to_matrix(targets[:, 3:7])
        pt = np.asarray(targets, np.float64)[:, :3]
        q = np.asarray(q0, np.float64).copy()
        eye = damping * np.eye(6)
        for _ in range(iters):
            R, t, (ax, org) = self.fk(q, frames=True)
            e = np.concatenate([pt - t, rotation_vector(
                Rt @ R.transpose(0, 2, 1))], axis=1)
            live = np.linalg.norm(e, axis=1) >= tol
            if not live.any():
                break
            J = np.concatenate([np.cross(ax, (t[:, None] - org)), ax],
                               axis=2).transpose(0, 2, 1)  # (N, 6, A)
            dq = (J.transpose(0, 2, 1) @ np.linalg.solve(
                J @ J.transpose(0, 2, 1) + eye, e[..., None]))[..., 0]
            q = np.where(live[:, None], q + dq, q)
        R, t = self.fk(q)
        e = np.concatenate([pt - t, rotation_vector(
            Rt @ R.transpose(0, 2, 1))], axis=1)
        return q, np.linalg.norm(e, axis=1) < tol

    def step(self, q_from, q_to):
        """(N,) largest joint move from ``q_from`` to ``q_to``, the cyclic
        joints taken the short way round."""
        d = np.asarray(q_to, np.float64) - np.asarray(q_from, np.float64)
        d = np.where(self.cyclic, (d + np.pi) % (2 * np.pi) - np.pi, d)
        return np.abs(d).max(axis=-1)


def axis_rotation(axis, angle):
    """(N, 3, 3) rotations about a unit axis (Rodrigues)."""
    a = np.asarray(axis, dtype=np.float64)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    s = np.sin(angle)[:, None, None]
    c = np.cos(angle)[:, None, None]
    return np.eye(3) + s * k + (1 - c) * (k @ k)


def rotation_vector(R):
    """(N, 3) axis times angle of rotation matrices (N, 3, 3)."""
    c = np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2, -1.0, 1.0)
    angle = np.arccos(c)
    w = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                  R[:, 1, 0] - R[:, 0, 1]], axis=1)
    s = np.sin(angle)
    small = angle < 1e-6
    # near pi the axis comes from the diagonal, signed by w
    diag = np.sqrt(np.clip((np.diagonal(R, axis1=1, axis2=2) + 1) / 2, 0,
                           None)) * np.where(w >= 0, 1.0, -1.0)
    diag /= np.maximum(np.linalg.norm(diag, axis=1, keepdims=True), 1e-12)
    general = w / np.maximum(2 * s, 1e-12)[:, None]
    axis = np.where((s < 1e-9)[:, None], diag, general)
    return np.where(small[:, None], w / 2, axis * angle[:, None])


def quat_to_matrix(q):
    """(N, 4) xyzw -> (N, 3, 3), normalising first."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3)


def pose_errors(chain, q, targets):
    """(position error (N,) m, rotation error (N,) rad) of the end effector
    at joint values ``q`` (N, A) against ``targets`` (N, 7) xyz + xyzw."""
    targets = np.asarray(targets, dtype=np.float64)
    R, t = chain.fk(q)
    pos = np.linalg.norm(t - targets[:, :3], axis=-1)
    Rt = quat_to_matrix(targets[:, 3:7])
    tr = np.einsum("nij,nij->n", R, Rt)  # trace(R^T Rt)
    rot = np.arccos(np.clip((tr - 1) / 2, -1.0, 1.0))
    return pos, rot
