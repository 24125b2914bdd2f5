"""``reconplan_tpu_torch.grr.experiment`` (trajectory generation, the
host-engine solvers, the metrics) and the teleop benchmark's cold starts
and analysis (``grr.teleop_batch``) against the JAX package on the CPU.

The robot is the rot_variable_yaw UR10 (7D poses) and the roadmap the
committed ``graph/ur10/rot_variable_yaw``, the teleop benchmark's. The
JAX package's batched IK runs in batches of 64 problems
(``torch_parity.jax_ik_lanes``), so XLA compiles it once.

Tolerances and why (each test states its measured max):
* generated trajectories: the same count, points within 1e-6 (f32
  quaternion maths on the same numpy draws);
* cold starts: ``alive`` equal, configurations within 1e-4 rad;
* ``analyze_arm`` / ``summarize``: success equal, DTW and length ratio
  within 1e-5 relative (f32 distance matrices, f64 dynamic program);
* ``dynamic_time_warping`` and the DTW program: 1e-9 (numpy f64 on both
  sides).
"""

import numpy as np
import pytest
import torch

from reconplan_tpu.grr import experiment as jexp
from reconplan_tpu.grr import teleop_batch as jtb
from reconplan_tpu_torch.grr import experiment as texp
from reconplan_tpu_torch.grr import teleop_batch as ttb
from torch_parity import jax_ik_lanes, roadmap_pair, ur10_pair, wrapped

torch.set_num_threads(2)

RNG = np.random.default_rng(0)
KINDS = ("line_random", "line_self", "circle_random", "circle_out")


@pytest.fixture(scope="module", autouse=True)
def lanes():
    with jax_ik_lanes():
        yield


@pytest.fixture(scope="module")
def robots():
    return ur10_pair("rot_variable_yaw")


@pytest.fixture(scope="module")
def rvy(robots):
    """(JAX, port) resolution of the committed rot_variable_yaw roadmap."""
    return roadmap_pair(robots, "rot_variable_yaw")


@pytest.fixture(scope="module")
def circles(robots):
    """Six circle_random trajectories of 11 points (1 s at 10 Hz) made by
    the port (``test_generate_trajectories_matches_jax`` holds them to
    the JAX package's)."""
    return texp.generate_trajectories(robots[1], "circle_random",
                                      n_trajectories=6, duration=1.0, hz=10,
                                      seed=7, batch=32)


# --- trajectory generation ------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_generate_trajectories_matches_jax(robots, kind):
    """Both packages draw the same numpy stream and validate the same
    endpoints: the same count and points within 1e-6 (measured max
    1.2e-7)."""
    kw = dict(n_trajectories=2, duration=1.0, hz=10, seed=KINDS.index(kind),
              max_tries=32, batch=32)
    ref = jexp.generate_trajectories(robots[0], kind, **kw)
    port = texp.generate_trajectories(robots[1], kind, **kw)
    assert len(port) == len(ref)
    assert len(port) >= (1 if kind != "line_self" else 0)
    for a, b in zip(port, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert a.shape[0] == (11 if kind.startswith("line") else 12)
        assert np.abs(a - b).max() <= 1e-6


def test_circle_path_matches_jax():
    """One circle, its rotations slerped start -> goal -> start: within
    1e-6 (measured max 6.0e-8)."""
    q = RNG.normal(size=(2, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    start = np.concatenate([[0.5, 0.2, 0.3], q[0]])
    goal = np.concatenate([[0.6, 0.1, 0.4], q[1]])
    ref = jexp._circle_path(start, goal, 20, np.random.default_rng(3))
    port = texp._circle_path(start, goal, 20, np.random.default_rng(3),
                             device="cpu")
    assert port.shape == ref.shape == (22, 7)
    assert np.abs(port - ref).max() <= 1e-6
    np.testing.assert_array_equal(port[-1], port[0])


class TestExperiment:
    """Twins of ``tests/test_recon_io.py::TestExperiment`` on the port."""

    def test_dtw_identical_is_zero(self):
        traj = RNG.normal(size=(30, 3))
        assert texp.dynamic_time_warping(traj, traj) == pytest.approx(
            0.0, abs=1e-9)

    def test_dtw_shifted(self):
        a = np.zeros((10, 3))
        b = np.zeros((10, 3))
        b[:, 0] = 0.1
        assert texp.dynamic_time_warping(a, b) == pytest.approx(1.0,
                                                                abs=1e-6)

    def test_trajectory_generation(self):
        from reconplan_tpu_torch.kin import UR10

        robot = UR10("ur10", [[-1, 1], [-1, 1], [-0.5, 1]], [0, 0, 1],
                     [-np.pi, 0, 0], device="cpu")
        robot._rng = np.random.default_rng(3)
        trajs = texp.generate_trajectories(robot, "line_random",
                                           n_trajectories=2, duration=1.0,
                                           hz=10)
        assert len(trajs) >= 1
        assert trajs[0].shape[0] == 11
        assert trajs[0].shape[1] == 7


# --- DTW and the host-engine metrics ----------------------------------------


def test_dtw_matches_jax(monkeypatch):
    """``dynamic_time_warping`` and ``dtw_reference`` within 1e-9
    (measured max 0 for both). ``dtw_reference`` is held on the JAX
    package's cost matrix: the two libraries' f32 matmul-form SE3
    distances round apart (``se3_cost_matrix``: within 1e-6, measured
    2.4e-7 relative in the DTW they give; ROADMAP Queue 3)."""
    a = RNG.normal(size=(23, 7))
    b = a[::2] + RNG.normal(0, 0.05, (12, 7))
    for x in (a, b):
        x[:, 3:] /= np.linalg.norm(x[:, 3:], axis=-1, keepdims=True)
    assert texp.dynamic_time_warping(a, b) == pytest.approx(
        jexp.dynamic_time_warping(a, b), abs=1e-9)
    jcost = jtb.se3_cost_matrix(a, b)
    tcost = ttb.se3_cost_matrix(a, b, device="cpu")
    assert tcost.dtype == np.float32 and np.abs(tcost - jcost).max() <= 1e-6
    want = jtb.dtw_reference(a, b)
    monkeypatch.setattr(ttb, "se3_cost_matrix", lambda x, y, device: jcost)
    assert ttb.dtw_reference(a, b, device="cpu") == pytest.approx(want,
                                                                  abs=1e-9)


def test_host_metrics_match_jax(robots, rvy):
    """``config_traj_length``, ``get_ws_traj``, ``check_c_traj`` and
    ``workspace_traj_length`` on one path, within 1e-6 (measured max: 0
    for the config length, 1.2e-7 m for the poses, 3.0e-8 m for the
    workspace length)."""
    c = RNG.normal(0, 0.02, (15, 6)).cumsum(axis=0) + rvy[1].configs[7]
    goal = robots[1].fk_point_batch(c[-1:].astype(np.float32))[0].numpy()
    out = []
    for mod, rob in ((jexp, robots[0]), (texp, robots[1])):
        w = mod.get_ws_traj(rob, c)
        out.append((mod.config_traj_length(rob, c), w,
                    mod.workspace_traj_length(w),
                    mod.check_c_traj(rob, c, goal),
                    mod.check_c_traj(rob, c, goal + 0.2)))
    (jl, jw, jwl, jok, jfar), (tl, tw, twl, tok, tfar) = out
    assert tl == pytest.approx(jl, rel=1e-6)
    assert np.abs(tw - jw).max() <= 1e-6 and tw.shape == (15, 7)
    assert twl == pytest.approx(jwl, rel=1e-6)
    assert (tok, tfar) == (jok, jfar) == (True, False)


def test_newton_teleop_solver_matches_jax(robots, circles):
    """The per-trajectory Newton engine on one circle (3 converge steps):
    every configuration within 1e-4 rad (measured max 0)."""
    traj = circles[0]
    q0 = robots[1].solve_ik(traj[0], robots[1].sample(
        rng=np.random.default_rng(1)), none_on_fail=False)
    ref = jexp.newton_teleop_solver(robots[0], traj, q0, converge_steps=3)
    port = texp.newton_teleop_solver(robots[1], traj, q0, converge_steps=3)
    assert port.shape == ref.shape
    assert wrapped(port, ref).max() <= 1e-4


# --- the benchmark's cold starts and analysis ------------------------------


def test_cold_starts_match_jax(rvy, circles):
    """Six circles' starts and ends through the resolution's cold-start
    semantics: ``alive`` equal, start configurations within 1e-4 rad
    (measured max 7.7e-5: an LM solve from a weighted-average seed, which
    starts farther off than a roadmap seed, ROADMAP Queue 3)."""
    trajs = np.stack(circles)
    jq, jalive = jtb.cold_starts(rvy[0], trajs)
    tq, talive = ttb.cold_starts(rvy[1], trajs)
    np.testing.assert_array_equal(talive, jalive)
    assert talive.sum() >= 4
    assert wrapped(tq, jq)[talive].max() <= 1e-4


@pytest.fixture(scope="module")
def tracked(robots, rvy, circles):
    """The port's Newton arm over the six circles (5 converge steps): the
    common ``c_trajs`` the analysis of both packages is fed."""
    trajs = np.stack(circles)
    q0s, alive = ttb.cold_starts(rvy[1], trajs)
    alive[1] = False
    return trajs, ttb.newton_teleop_batch(robots[1], trajs, q0s, alive,
                                          converge_steps=5)


@pytest.mark.parametrize("batched", [True, False])
def test_analyze_arm_and_summarize_match_jax(robots, tracked, batched):
    """``analyze_arm`` on equal-length rows (the batched path) and on rows
    of unequal length (row by row), then ``summarize``: success equal,
    DTW, lengths and ratio within 1e-5 relative (measured max 3.8e-6)."""
    trajs, c_trajs = tracked
    if not batched:  # every other row one converge tick short
        c_trajs = [c[: len(c) - i % 2] for i, c in enumerate(c_trajs)]
    ref = jtb.analyze_arm(robots[0], trajs, c_trajs)
    port = ttb.analyze_arm(robots[1], trajs, c_trajs)
    assert [r["success"] for r in port] == [r["success"] for r in ref]
    assert sum(r["success"] for r in port) >= 3
    for a, b in zip(port, ref):
        assert set(a) == set(b)
        for key in ("dtw", "c_length", "w_length", "ratio"):
            if key in b:
                assert a[key] == pytest.approx(b[key], rel=1e-5), key
    sj, st = jtb.summarize(ref), ttb.summarize(port)
    assert set(st) == set(sj)
    for key, value in sj.items():
        assert st[key] == pytest.approx(value, rel=1e-5), key
