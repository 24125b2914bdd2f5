"""``reconplan_tpu_torch.kin.relaxed`` and ``kin.dynamics``, and the two
arms of the teleop benchmark that need no roadmap (``newton_teleop_batch``,
``relaxed_teleop_batch``), against the JAX package on the CPU.

One UR10 in each package (``tests/test_kin.py``'s: yaw-variable rotation,
so targets are 7D poses), built once a module. Inputs are seeded numpy
configurations and their FK poses, and ``data/golden/ctraj.txt``.

Tolerances and why (each test states its measured max):
* ``_relaxed_step``: 1e-5 rad after 1 step, 1e-4 after 10. Each step is
  an f32 6x6 solve; XLA's dot products and the port's multiply-sums round
  apart in the last bits, and ten steps carry that forward.
* the servo model: 1e-5 (f32 positions integrated over 2,401 ticks).
* the Newton and RelaxedIK arms: histories within 1e-4 rad.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.grr import teleop_batch as jtb
from reconplan_tpu.kin import UR10 as JUR10
from reconplan_tpu.kin import dynamics as jdyn
from reconplan_tpu.kin import relaxed as jrel
from reconplan_tpu_torch.grr import teleop_batch as ttb
from reconplan_tpu_torch.io.drivers import SimRTDE
from reconplan_tpu_torch.kin import UR10 as TUR10
from reconplan_tpu_torch.kin import dynamics as tdyn
from reconplan_tpu_torch.kin import relaxed as trel
from torch_parity import jax_eager, wrapped

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q_HOME = np.array([0.0, -1.0, 1.7, -2.27, -1.57, 1.57], dtype=np.float32)
ARGS = ("ur10", [[-1, 1], [-1, 1], [-0.5, 1]], [0, 0, 1], [-np.pi, 0, 0])


@pytest.fixture(scope="module")
def ur10():
    """(JAX, port) UR10 of ``tests/test_kin.py``."""
    return JUR10(*ARGS), TUR10(*ARGS, device="cpu")


def golden_timed():
    times, qs = [], []
    for line in open(os.path.join(REPO, "data", "golden", "ctraj.txt")):
        t, rest = line.split(",", 1)
        times.append(float(t))
        qs.append([float(x) for x in re.findall(
            r"-?\d+\.?\d*(?:[eE][+-]?\d+)?", rest)])
    return np.asarray(times, np.float32), np.asarray(qs, np.float32)


def seeded_poses(robot, n, seed, spread=0.3):
    """n configurations around the home pose and the FK poses of a second
    set 0.05 rad from them: (q0 (n, 6) f32, targets (n, 7) f32)."""
    rng = np.random.default_rng(seed)
    q0 = (Q_HOME + rng.uniform(-spread, spread, (n, 6))).astype(np.float32)
    q1 = (q0 + rng.uniform(-0.05, 0.05, (n, 6))).astype(np.float32)
    return q0, robot.fk_point_batch(q1).numpy()


# --- kin.relaxed -------------------------------------------------------------


@pytest.mark.parametrize("n_steps,tol", [(1, 1e-5), (10, 1e-4)])
@pytest.mark.parametrize("w_vel", [1.0, 5.0, 500.0])
def test_relaxed_step_matches_jax(ur10, n_steps, tol, w_vel):
    """Eight seeded configurations at once in the port, one by one in the
    JAX package. Measured max: 2.4e-7 rad after 1 step and after 10."""
    jr, tr = ur10
    q0, tgt = seeded_poses(tr, 8, seed=int(w_vel) + n_steps)
    w = np.asarray([50.0, 10.0, w_vel, 1.0], np.float32)
    quat = tgt[:, 3:7] / np.linalg.norm(tgt[:, 3:7], axis=-1, keepdims=True)
    port = trel._relaxed_step(
        tr.model, tr._active_tuple, tr.ee_link, torch.as_tensor(q0),
        torch.as_tensor(tgt[:, :3]), torch.as_tensor(quat), tr._q_rest,
        torch.as_tensor(w), n_steps=n_steps).numpy()
    ref = np.stack([np.asarray(jrel._relaxed_step(
        jr.model, jr._active_tuple, jr.ee_link, jnp.asarray(q0[i]),
        jnp.asarray(tgt[i, :3]), jnp.asarray(quat[i]), jr._q_rest,
        jnp.asarray(w), n_steps=n_steps)) for i in range(len(q0))])
    assert np.abs(port - ref).max() <= tol
    # the step moves (nothing above holds trivially)
    assert np.abs(port - q0).max() > 1e-3


def test_relaxed_ik_solve_matches_jax(ur10):
    """The stateful solver's tick, from the JAX twin's start: three
    ticks within 1e-4 rad (measured max 2.4e-7)."""
    jr, tr = ur10
    pt = tr.fk_point_batch(Q_HOME[None]).numpy()[0]
    out = []
    for cls, rob in ((jrel.RelaxedIK, jr), (trel.RelaxedIK, tr)):
        kw = {} if cls is jrel.RelaxedIK else {"device": "cpu"}
        solver = cls(rob, **kw)
        solver.reset(Q_HOME + 0.1)
        out.append([solver.solve(pt[:3], pt[3:7]) for _ in range(3)])
    assert np.abs(np.asarray(out[0]) - np.asarray(out[1])).max() <= 1e-4


class TestRelaxedIK:
    """Twins of ``tests/test_kin.py::TestRelaxedIK`` on the port."""

    @pytest.mark.slow
    def test_converges_with_smooth_motion(self, ur10):
        tr = ur10[1]
        pt = tr.fk_point_batch(Q_HOME[None]).numpy()[0]
        solver = trel.RelaxedIK(tr, device="cpu")
        solver.reset(Q_HOME + 0.1)
        q = solver.solve_precise(pt[:3], pt[3:7], n_rounds=10)
        ee = tr.fk_point_batch(np.asarray(q, np.float32)[None]).numpy()[0]
        assert np.linalg.norm(ee[:3] - pt[:3]) < 2e-3
        assert abs(np.dot(ee[3:7], pt[3:7])) > 0.999
        assert np.abs(np.asarray(q) - (Q_HOME + 0.1)).max() < 0.5

    def test_velocity_weight_relaxes_tracking(self, ur10):
        """Higher smoothness weight (damping) -> smaller single-step motion."""
        tr = ur10[1]
        q0 = torch.as_tensor(Q_HOME)
        target = tr.fk_point_batch((Q_HOME + 0.05)[None])[0]
        moves = []
        for w_vel in (0.5, 500.0):
            w = torch.tensor([50.0, 10.0, w_vel, 1.0])
            q = trel._relaxed_step(tr.model, tr._active_tuple, tr.ee_link,
                                   q0, target[:3], target[3:7], tr._q_rest,
                                   w, n_steps=1)
            moves.append(float((q - q0).abs().max()))
        assert moves[1] < moves[0]


# --- kin.dynamics ------------------------------------------------------------


def test_servo_on_the_golden_trajectory_matches_jax(ur10):
    """``ServoExecutor.execute`` of the 500 timed golden configurations
    (2,401 ticks at 240 Hz): the trace, its velocities and the statistics
    within 1e-5 (the statistics 1e-5 relative). Measured max: positions
    4.8e-7 rad, velocities 3.8e-6 rad/s (the jitted JAX scan contracts
    multiply-adds into FMAs), mean EE error 3.2e-5 mm of about 10."""
    jr, tr = ur10
    times, qs = golden_timed()
    ref = jdyn.ServoExecutor(jr).execute(times, qs)
    port = tdyn.ServoExecutor(tr, device="cpu").execute(times, qs)
    assert port["q_ticks"].shape == ref["q_ticks"].shape == (2401, 6)
    for key in ("q_ticks", "qd_ticks", "q_at_waypoints"):
        assert np.abs(port[key] - ref[key]).max() <= 1e-5, key
    for key in ("joint_err_max", "joint_err_mean", "ee_err_max_mm",
                "ee_err_mean_mm"):
        assert port[key] == pytest.approx(ref[key], rel=1e-5, abs=1e-5), key


def test_servo_scan_matches_jax_from_a_moving_start(ur10):
    """``_servo_scan`` itself from a nonzero velocity, with a waypoint
    held past the end (the JAX scan's padding ticks dropped), against the
    JAX scan op by op: measured max 0 (bit-identical). The jitted JAX scan
    contracts multiply-adds into FMAs: over 12 waypoints (760 ticks) of
    the same kind it parts from its own op-by-op run by 1.43e-5 rad/s in
    the velocities (ROADMAP Queue 3)."""
    rng = np.random.default_rng(4)
    times = np.cumsum(rng.uniform(0.02, 0.1, 6)).astype(np.float32)
    ctraj = (Q_HOME + rng.uniform(-0.5, 0.5, (6, 6))).astype(np.float32)
    q0 = ctraj[0] - 0.2
    qd0 = rng.uniform(-1, 1, 6).astype(np.float32)
    vmax = tdyn.UR10_VMAX
    n = int(np.ceil(float(times[-1]) * 240)) + 1
    with jax_eager():
        jq, jqd = jdyn._servo_scan(jnp.asarray(q0), jnp.asarray(qd0),
                                   jnp.asarray(times), jnp.asarray(ctraj),
                                   jnp.asarray(vmax), 5.0, 8.0, n + 7, 240)
    tq, tqd = tdyn._servo_scan(*(torch.as_tensor(a) for a in (
        q0, qd0, times, ctraj, vmax)), 5.0, 8.0, n, 240)
    assert np.abs(tq.numpy() - np.asarray(jq)[:n]).max() <= 1e-5
    assert np.abs(tqd.numpy() - np.asarray(jqd)[:n]).max() <= 1e-5


def test_servo_executor_device_rules(ur10):
    """The executor takes its robot's device, and without a robot the
    device it is given."""
    assert tdyn.ServoExecutor(ur10[1], device="cpu").device.type == "cpu"
    assert tdyn.ServoExecutor(device="cpu").vmax.shape == (6,)
    with pytest.raises(ValueError, match="robot is on cpu"):
        tdyn.ServoExecutor(ur10[1], device="meta")


class TestServoDynamics:
    """Twins of ``tests/test_kin.py::TestServoDynamics`` on the port."""

    def test_converges_and_respects_velocity_limits(self, ur10):
        ex = tdyn.ServoExecutor(ur10[1], device="cpu")
        q0 = np.zeros(6, np.float32)
        qt = np.asarray([0.4, -0.3, 0.5, 0.2, -0.2, 0.3], np.float32)
        res = ex.execute(np.asarray([3.0]), qt[None], q0=q0)
        assert np.abs(res["q_ticks"][-1] - qt).max() < 1e-3
        assert np.all(np.abs(res["qd_ticks"]) <= ex.vmax + 1e-4)

    def test_golden_ctraj_execution_lags_but_tracks(self, ur10):
        times, qs = golden_timed()
        res = tdyn.ServoExecutor(ur10[1], device="cpu").execute(times, qs)
        assert res["joint_err_max"] > 1e-4
        assert res["joint_err_mean"] < 0.05, res
        assert res["ee_err_mean_mm"] < 25.0, res

    def test_simrtde_dynamics_mode(self, ur10):
        sim = SimRTDE(ur10[1], dynamics=True, device="cpu")
        target = [0.3, -0.2, 0.4, 0.1, -0.1, 0.2]
        sim.move_joint(target)
        assert np.abs(np.asarray(sim.get_joint_values()) - target).max() < 5e-3
        path = [[*np.linspace(0, 0.3, 5)[i].repeat(6), 1.05, 1.4, 0.02]
                for i in range(5)]
        sim.move_joint_trajectory(path)
        assert sim.last_execution["joint_err_max"] >= 0.0


def test_simrtde_dynamics_matches_jax(ur10):
    """A blocking move and a streamed path through the servo model: the
    joint state after each within 1e-5 (measured max 2.4e-7)."""
    from reconplan_tpu.io.drivers import SimRTDE as JSimRTDE

    out = []
    for sim in (JSimRTDE(ur10[0], dynamics=True),
                SimRTDE(ur10[1], dynamics=True, device="cpu")):
        sim.move_joint([0.3, -0.2, 0.4, 0.1, -0.1, 0.2])
        a = sim.get_joint_values()
        sim.servo_joint([0.35, -0.25, 0.45, 0.1, -0.1, 0.25])
        sim.move_joint_trajectory(
            [[*np.linspace(0.3, 0.6, 4)[i].repeat(6), 1.05] for i in range(4)])
        out.append(np.concatenate([a, sim.get_joint_values(),
                                   sim.get_joint_speed()]))
    assert np.abs(out[0] - out[1]).max() <= 1e-5


# --- the Newton and RelaxedIK arms ---------------------------------------------


@pytest.fixture(scope="module")
def arm_inputs(ur10):
    """Three 7D trajectories of 14 ticks from seeded starts (FK along a
    joint-space line), the third row not alive."""
    tr = ur10[1]
    rng = np.random.default_rng(11)
    q0s = (Q_HOME + rng.uniform(-0.3, 0.3, (3, 6))).astype(np.float64)
    q1s = q0s + rng.uniform(-0.3, 0.3, (3, 6))
    u = np.linspace(0, 1, 14)[None, :, None]
    path = (q0s[:, None] * (1 - u) + q1s[:, None] * u).astype(np.float32)
    trajs = tr.fk_point_batch(path.reshape(-1, 6)).numpy().reshape(3, 14, 7)
    alive = np.array([True, True, False])
    return trajs.astype(np.float64), q0s, alive


@pytest.mark.parametrize("arm", ["newton_teleop_batch",
                                 "relaxed_teleop_batch"])
def test_arm_histories_match_jax(ur10, arm_inputs, arm):
    """14 ticks and 6 converge steps: every config of every alive row
    within 1e-4 rad (measured max: newton 3.6e-7, relaxed 4.8e-7), dead
    rows empty."""
    trajs, q0s, alive = arm_inputs
    ref = getattr(jtb, arm)(ur10[0], trajs, q0s, alive, max_change=0.04,
                            converge_steps=6)
    port = getattr(ttb, arm)(ur10[1], trajs, q0s, alive, max_change=0.04,
                             converge_steps=6)
    assert [len(c) for c in port] == [len(c) for c in ref] == [21, 21, 0]
    for a, b in zip(port, ref):
        if len(a):
            assert wrapped(a, b).max() <= 1e-4
    # the arms track: consecutive steps clamped, the goal approached
    steps = wrapped(port[0][1:], port[0][:-1]).max()
    assert 1e-3 < steps <= 0.04 + 1e-6
