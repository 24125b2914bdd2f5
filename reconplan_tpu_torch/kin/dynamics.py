"""Servo-dynamics trajectory execution (the reference's physics-based
playback, ``main.py:218-234``: PyBullet POSITION_CONTROL motors stepped
at 240 Hz while the camera captures, so the executed joints LAG the
command and executed-vs-planned tracking error is a measurable quantity).

Port of ``reconplan_tpu.kin.dynamics``. What the reference's
``stepSimulation`` loop exercises during playback is each joint's motor
servo, a velocity-clamped, acceleration-limited position regulator; it
is modelled directly, as in the JAX package (no link inertia coupling or
contact forces). The JAX package integrates it with one ``lax.scan``
padded to a power of two of ticks (one compile a length bucket); here it
is a loop over exactly ``n_ticks`` on the executor's device, about eight
small ops a tick, with the commanded waypoint of every tick looked up
once before the loop.

Defaults follow the UR10's published joint limits (base/shoulder
2.09 rad/s, others 3.14 rad/s; accel ~= 5 rad/s^2 is the conservative
end of UR's 180-800 deg/s^2 envelope).
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.utils.device import resolve_device, robot_device

UR10_VMAX = np.asarray([2.09, 2.09, 3.14, 3.14, 3.14, 3.14], np.float32)


def _servo_scan(q0, qd0, times, ctraj, vmax, amax, kp, n_ticks, hz):
    """Integrate the per-joint position servo over ``n_ticks`` at ``hz``.

    Command = zero-order hold of the active waypoint (the reference holds
    each motor target until the waypoint's timestamp passes,
    ``main.py:218-234``). All tensors f32 on one device; returns the
    (n_ticks, A) positions and velocities after each tick."""
    dev = q0.device
    dt = 1.0 / hz
    # f32 products, as the JAX package rounds its weakly typed scalars
    a_dt = float(np.float32(amax) * np.float32(dt))
    t = torch.arange(n_ticks, dtype=torch.float32, device=dev) * dt
    # active waypoint: first timestamp >= t
    w = torch.searchsorted(times, t, right=False).clamp_(0, ctraj.shape[0] - 1)
    q_cmd = ctraj[w]
    qs = torch.empty((n_ticks,) + q0.shape, dtype=torch.float32, device=dev)
    qds = torch.empty_like(qs)
    q, qd = q0, qd0
    for i in range(n_ticks):
        # velocity-clamped position regulator (POSITION_CONTROL: drive
        # toward the target at <= maxVelocity), with a slew limit standing
        # in for finite motor force
        qd_des = torch.minimum(torch.maximum(kp * (q_cmd[i] - q), -vmax), vmax)
        qd = qd + torch.clamp(qd_des - qd, -a_dt, a_dt)
        q = q + qd * dt
        qs[i] = q
        qds[i] = qd
    return qs, qds


class ServoExecutor:
    """Execute a timestamped joint trajectory through servo dynamics.

    ``execute(times, ctraj)`` -> dict with the 240 Hz executed trace,
    the executed config at each waypoint timestamp, and tracking-error
    statistics (joint-space and, when a robot is given, workspace EE
    deviation via FK), numpy throughout.

    The servo runs on ``device``: by default the robot's, which must be
    the card when no device is named (``"cpu"`` asks for the CPU).
    """

    def __init__(self, robot=None, hz=240, vmax=None, amax=5.0, kp=8.0,
                 device=None):
        self.robot = robot
        self.device = (robot_device(robot, device) if robot is not None
                       else resolve_device(device))
        self.hz = int(hz)
        if vmax is None:
            n = robot.num_joints if robot is not None else 6
            vmax = UR10_VMAX[:n] if n <= 6 else np.full(n, 3.14, np.float32)
        self.vmax = np.asarray(vmax, np.float32)
        self.amax = float(amax)
        self.kp = float(kp)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def execute(self, times, ctraj, q0=None, qd0=None):
        times = np.asarray(times, np.float32)
        ctraj = np.asarray(ctraj, np.float32)
        if q0 is None:
            q0 = ctraj[0]
        q0 = np.asarray(q0, np.float32)
        qd0 = (np.zeros_like(q0) if qd0 is None
               else np.asarray(qd0, np.float32))
        n_ticks = int(np.ceil(float(times[-1]) * self.hz)) + 1
        qs, qds = _servo_scan(
            self._tensor(q0), self._tensor(qd0), self._tensor(times),
            self._tensor(ctraj), self._tensor(self.vmax), self.amax, self.kp,
            n_ticks, self.hz,
        )
        qs = qs.cpu().numpy()
        qds = qds.cpu().numpy()
        # executed config at each waypoint timestamp
        idx = np.minimum((times * self.hz).astype(np.int64), n_ticks - 1)
        q_at_wp = qs[idx]
        err = np.abs(q_at_wp - ctraj)
        out = {
            "q_ticks": qs,
            "qd_ticks": qds,
            "q_at_waypoints": q_at_wp,
            "joint_err_max": float(err.max()) if err.size else 0.0,
            "joint_err_mean": float(err.mean()) if err.size else 0.0,
        }
        if self.robot is not None:
            ee_exec = self.robot.fk_point_batch(q_at_wp)[:, :3].cpu().numpy()
            ee_plan = self.robot.fk_point_batch(ctraj)[:, :3].cpu().numpy()
            d = np.linalg.norm(ee_exec - ee_plan, axis=-1)
            out["ee_err_max_mm"] = float(d.max() * 1e3) if d.size else 0.0
            out["ee_err_mean_mm"] = float(d.mean() * 1e3) if d.size else 0.0
        return out
