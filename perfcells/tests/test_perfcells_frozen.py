"""The frozen traffic generators and the plain kinematics against the
port's originals and the golden data, on the CPU: the copies produce the
traffic the port's own code produced when the cells were set up."""

import json
import os
import re

import numpy as np
import pytest
import torch

from perfcells.reference import kinematics as kin
from perfcells.traffic import arcs, render, trajectories

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BANANA = os.path.join(ROOT, "data/objects/011_banana/poisson/nontextured.ply")
NUM = r"-?\d+\.?\d*(?:[eE][+-]?\d+)?"


def _golden(name):
    with open(os.path.join(ROOT, "data", "golden", name)) as f:
        return np.array([[float(x) for x in re.findall(NUM, ln.split(",", 1)[1])]
                         for ln in f])


def test_mesh_reading_matches_the_port():
    from reconplan_tpu_torch.io.meshio import load_mesh

    v, f = render.load_ply(BANANA)
    pv, pf = load_mesh(BANANA)
    np.testing.assert_array_equal(v, pv)
    np.testing.assert_array_equal(f, pf)


def test_rendered_frame_matches_the_port():
    from reconplan_tpu_torch.io.render import SplatCamera

    ours = render.SplatCamera(samples_per_mesh=200_000, device="cpu")
    port = SplatCamera(samples_per_mesh=200_000, device="cpu")
    ours.add_mesh_file(BANANA, translate=arcs.OBJECT_POINT)
    port.add_mesh_file(BANANA, translate=arcs.OBJECT_POINT)
    ours.add_checker_floor(center=arcs.OBJECT_POINT[:2], size=0.5, tiles=2)
    port.add_checker_floor(center=arcs.OBJECT_POINT[:2], size=0.5, tiles=2)
    eye = (0.6, 0.55, 0.3)
    d, c, T = ours.take_picture(eye, arcs.OBJECT_POINT)
    pd, pc, pT = port.take_picture(eye, arcs.OBJECT_POINT)
    assert float((d > 0).float().mean()) > 0.01
    torch.testing.assert_close(d, pd, rtol=0, atol=0)
    torch.testing.assert_close(c, pc, rtol=0, atol=0)
    np.testing.assert_array_equal(T, pT)


@pytest.mark.parametrize("n_arcs,per_arc", [(1, 500), (6, 12)])
def test_arc_schedule_matches_the_port(n_arcs, per_arc):
    from reconplan_tpu_torch.apps.scan import OBJECT_POINT, make_arc_schedule
    from reconplan_tpu_torch.grr.paths import scan_arc

    az = arcs.BASE_AZIMUTH + 0.37
    ours = arcs.make_arc_schedule(n_arcs, per_arc, az)
    # the port's one-arc schedule keeps the reference azimuth; the plan
    # cell turns it, so hold it against the port's arc at that azimuth
    port = (make_arc_schedule(n_arcs, per_arc, base_az=az, device="cpu")
            if n_arcs > 1 else
            [scan_arc(OBJECT_POINT, radius=0.3, height=0.15,
                      num_points=per_arc, azimuth=az, device="cpu")])
    for a, b in zip(ours, port, strict=True):
        np.testing.assert_array_equal(a[:, :3], b[:, :3])
        # quaternions up to sign, the port's in float32 arithmetic
        sign = np.sign((a[:, 3:] * b[:, 3:]).sum(1, keepdims=True))
        np.testing.assert_allclose(a[:, 3:], sign * b[:, 3:], atol=1e-6)


def test_circle_matches_the_port():
    from reconplan_tpu_torch.grr.experiment import _circle_path

    start = np.array([0.5, 0.2, 0.3, 0.0, 0.0, 0.0, 1.0])
    goal = np.array([0.6, 0.1, 0.35, 0.0, 0.0, np.sin(0.3), np.cos(0.3)])
    ours = trajectories.circle_path(start, goal, 200,
                                    np.random.default_rng(5))
    port = _circle_path(start, goal, 200, np.random.default_rng(5),
                        device="cpu")
    assert ours.shape == port.shape == (202, 7)
    np.testing.assert_allclose(ours, port, atol=2e-6)


def test_trajectories_from_the_seed():
    """The source's circle_random protocol: closed circles of unit
    quaternions, the same for one seed, whose endpoints the plain IK
    reaches."""
    chain = kin.Chain(os.path.join(ROOT, "data/robots/ur10.rob"), "ee_link",
                      [1, 2, 3, 4, 5, 6])
    with open(os.path.join(ROOT, "perfcells/configs/ur10_teleop_rvy.json")) as f:
        cfg = json.load(f)

    def make(seed):
        return trajectories.circle_random(chain, cfg["domain"],
                                          cfg["fixed_rpy"], 3, seed,
                                          batch=256)

    a, b, c = make(2**31 + 1), make(2**31 + 1), make(2**31 + 2)
    assert all(t.shape == (202, 7) for t in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    for t in a:
        np.testing.assert_array_equal(t[0], t[-1])
        np.testing.assert_allclose(np.linalg.norm(t[:, 3:], axis=1), 1,
                                   atol=1e-6)
        lo = np.array(cfg["domain"])[:, 0]
        hi = np.array(cfg["domain"])[:, 1]
        assert np.all((t[0, :3] >= lo) & (t[0, :3] <= hi))
        # the goal, half way round, lies within a fifth of the domain
        assert np.linalg.norm(t[100, :3] - t[0, :3]) <= 0.3 + 1e-5
    ends = np.stack([t[i] for t in a for i in (0, 100)]).astype(np.float64)
    assert trajectories.reachable(chain, ends, np.random.default_rng(0),
                                  rounds=30).all()


def test_workspace_sample_matches_the_port():
    """The frozen variable-yaw pose is the port's ``workspace_sample``
    rotation: the problem's fixed rotation with the yaw replaced."""
    from reconplan_tpu_torch.core import maths

    with open(os.path.join(ROOT, "perfcells/configs/ur10_teleop_rvy.json")) as f:
        rpy = json.load(f)["fixed_rpy"]
    for yaw in (-2.5, 0.0, 0.3, 3.0):
        ours = trajectories.yaw_pose(np.zeros(3), rpy, yaw)[3:]
        port = maths.euler_to_quat(
            torch.tensor([rpy[0], rpy[1], yaw], dtype=torch.float64),
            seq=maths.PROBLEM_EULER_SEQ).numpy()
        assert abs(abs(np.dot(ours, port)) - 1) < 1e-7


def test_plain_ik_reaches_the_ports_fk():
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin.robot import make_robot

    chain = kin.Chain(os.path.join(ROOT, "data/robots/ur10.rob"), "ee_link",
                      [1, 2, 3, 4, 5, 6])
    q = _golden("ctraj.txt")
    robot = make_robot(load_problem("ur10", "rot_free"), device="cpu")
    pts = robot.fk_point_batch(torch.tensor(q, dtype=torch.float32))
    pts = pts.numpy().astype(np.float64)[[5, 50, 200]]
    qs, ok = chain.ik(np.repeat(q[:1], 3, axis=0), pts)
    pos, rot = kin.pose_errors(chain, qs, pts)
    assert ok.all() and pos.max() < 1e-6 and rot.max() < 1e-6


def test_plain_fk_matches_golden_positions_and_the_port():
    """The golden ctraj.txt -> wtraj.txt positions are the reference
    robot's own FK; the port's FK agrees with ours on the full pose."""
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin.robot import make_robot

    chain = kin.Chain(os.path.join(ROOT, "data/robots/ur10.rob"), "ee_link",
                      [1, 2, 3, 4, 5, 6])
    q, w = _golden("ctraj.txt"), _golden("wtraj.txt")
    _, t = chain.fk(q)
    np.testing.assert_allclose(t, w[:, :3], atol=1e-7)
    robot = make_robot(load_problem("ur10", "rot_free"), device="cpu")
    pts = robot.fk_point_batch(torch.tensor(q, dtype=torch.float32)).numpy()
    pos, rot = kin.pose_errors(chain, q, pts)
    assert pos.max() < 1e-6 and rot.max() < 1e-5
    assert list(chain.cyclic) == [True] + [False] * 5
    assert chain.step(np.zeros((1, 6)), np.array([[2 * np.pi - 0.01, 0.02,
                                                    0, 0, 0, 0]]))[0] \
        == pytest.approx(0.02)
