"""Relaxed-IK style multi-objective teleop solver (C26 parity).

Port of ``reconplan_tpu.kin.relaxed``. The reference benchmarked against
a Rust ``relaxed_ik`` cdylib via ctypes
(``experiment/relaxed_ik_core/relaxed_ik.py``; the binary is a missing
blob there); the JAX package reimplements the idea behind RelaxedIK
(Rakita et al., RSS 2018): per-tick pose tracking as a WEIGHTED SOFT
OBJECTIVE rather than a hard constraint, trading end-effector accuracy
for joint-motion smoothness and limit avoidance.

Objective terms: position error ||p(q) - p*||^2, rotation error
||rotvec(R* R(q)^T)||^2, joint velocity ||q - q_prev||^2 (smoothness) and
a softplus joint-limit barrier near qmin/qmax. Each step is a damped
Gauss-Newton step on the geometric Jacobian: the velocity/smoothness
weight enters as Levenberg damping, and the barrier as a gradient term.
The step is written out (the JAX package's ``objective`` is never called,
so it is not carried over) and needs no autograd. Batch-first: the
configurations are (N, A) or (A,), and one call steps them all.
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.kin.chain import _index, fk_all, jacobian_from_fk
from reconplan_tpu_torch.kin.ik import _rotation_error
from reconplan_tpu_torch.utils.device import robot_device, scalar_tensor


def _relaxed_step(
    model, active, ee_link, q_prev, target_pos, target_quat, q_rest,
    weights, lr=0.02, n_steps=10,
):
    """``n_steps`` damped Gauss-Newton steps from ``q_prev`` (..., A)
    toward ``target_pos`` (..., 3) / ``target_quat`` (..., 4) under
    ``weights`` = (w_pos, w_rot, w_vel, w_lim) (4,). ``lr`` is accepted
    and unused, as in the JAX package."""
    dev = q_prev.device
    lead = q_prev.shape[:-1]
    A = q_prev.shape[-1]
    q = q_prev.reshape(-1, A)
    B = q.shape[0]
    pos = target_pos.reshape(B, 3)
    R_target = maths.quat_to_matrix(target_quat.reshape(B, 4))
    active_idx = _index(tuple(active), dev)
    qmin = model.qmin[active_idx]
    qmax = model.qmax[active_idx]
    w_pos, w_rot, w_vel, w_lim = weights
    margin = scalar_tensor(0.1, dev)
    eye = torch.eye(6, dtype=torch.float32, device=dev)
    # damping from the smoothness/pose weight ratio: large w_vel relaxes
    # tracking into smoother, smaller steps (the RelaxedIK tradeoff)
    lam2 = (w_vel + 1e-3) / (w_pos + 1e-3)
    rot_scale = torch.sqrt(w_rot / w_pos)

    for _ in range(n_steps):
        full = q_rest.expand(B, -1).index_copy(1, active_idx, q)
        R, t = fk_all(model, full)
        e_pos = pos - t[:, ee_link]
        e_rot = _rotation_error(R_target, R[:, ee_link]) * rot_scale
        e = torch.cat([e_pos, e_rot], dim=-1)
        J = jacobian_from_fk(model, R, t, ee_link, active)  # (B, 6, A)
        JJt = (J[:, :, None, :] * J[:, None, :, :]).sum(dim=-1)
        y = torch.linalg.solve_ex(JJt + lam2 * eye, e[:, :, None])[0]
        dq = (J * y).sum(dim=1)
        limit_grad = w_lim * (
            -torch.sigmoid((qmin + margin - q) / margin) / margin
            + torch.sigmoid((q - qmax + margin) / margin) / margin
        )
        dq = dq - 0.01 * limit_grad
        dq = torch.clamp(dq, -0.1, 0.1)  # per-tick trust region
        q = torch.minimum(torch.maximum(q + dq, qmin), qmax)
    return q.reshape(lead + (A,))


class RelaxedIK:
    """Stateful per-tick solver mirroring the reference's ctypes wrapper
    surface (``RelaxedIKRust.solve / solve_precise / reset``), on the
    robot's device (``device=None``: the card)."""

    def __init__(self, robot, w_pos=50.0, w_rot=10.0, w_vel=5.0, w_lim=1.0,
                 device=None):
        self.robot = robot
        self.device = robot_device(robot, device)
        self.weights = torch.tensor([w_pos, w_rot, w_vel, w_lim],
                                    dtype=torch.float32, device=self.device)
        self.q = torch.zeros(robot.num_joints, dtype=torch.float32,
                             device=self.device)

    def reset(self, q):
        self.q = self.robot._tensor(q)

    def solve(self, positions, orientations):
        """One soft-objective tick toward (pos (3,), quat xyzw (4,))."""
        robot = self.robot
        self.q = _relaxed_step(
            robot.model,
            robot._active_tuple,
            robot.ee_link,
            self.q,
            robot._tensor(positions),
            maths.quat_normalize(robot._tensor(orientations)),
            robot._q_rest,
            self.weights,
        )
        return self.q.cpu().numpy()

    def solve_precise(self, positions, orientations, n_rounds=10):
        """Iterate ticks until the pose converges (reference's
        solve_precise analog)."""
        out = None
        for _ in range(n_rounds):
            out = self.solve(positions, orientations)
        return out


def relaxed_teleop_solver(robot, trajectory, q0, max_change=0.04,
                          converge_steps=100):
    """Trajectory-tracking driver matching the experiment harness
    (``trajectory_quality.py:110-144``): RelaxedIK ticks with the same
    per-step clamp as the other solvers."""
    from reconplan_tpu_torch.grr.experiment import _step_toward

    solver = RelaxedIK(robot, device=robot.device)
    solver.reset(np.asarray(q0, dtype=np.float32))
    q = np.asarray(q0, dtype=np.float64)
    c_traj = [q]
    for point in trajectory:
        pos, quat = point[:3], point[3:7] if len(point) > 3 else [0, 0, 0, 1]
        target = solver.solve(pos, quat)
        q = _step_toward(robot, q, target, max_change)
        solver.reset(q)
        c_traj.append(q)
    for _ in range(converge_steps):
        pos = trajectory[-1][:3]
        quat = trajectory[-1][3:7] if len(trajectory[-1]) > 3 else [0, 0, 0, 1]
        target = solver.solve(pos, quat)
        q_new = _step_toward(robot, q, target, max_change)
        if np.allclose(q_new, q, atol=1e-6):
            break
        q = q_new
        solver.reset(q)
        c_traj.append(q)
    return np.asarray(c_traj)
