"""The teleop half's drivers, apps and viewers in ``reconplan_tpu_torch``:
``io/drivers``, ``apps/teleop|record|eval_roadmap``,
``viz/teleop_server|plots|html_export``, on the CPU (``device="cpu"``).

Twins of ``tests/test_recon_io.py``'s ``TestDrivers``, ``TestViz``,
``TestHtmlExport``, ``TestTeleopCLI`` and ``TestTeleopHTTPServer``, and
held against the JAX package where it computes the same thing: the HTML
pages byte for byte, ``read_joint_positions`` exactly, the roadmap
metrics of ``apps.eval_roadmap`` as ``tests/test_torch_grr.py`` holds
them (counts equal, ratios within 1e-6 relative). And the port's modules
import on a machine without matplotlib, PIL or pygame.
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from reconplan_tpu_torch.io.config import load_problem
from reconplan_tpu_torch.kin import UR10
from reconplan_tpu_torch.kin.robot import make_robot

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANANA = os.path.join(REPO, "data/objects/011_banana/poisson/nontextured.ply")
GOLDEN = os.path.join(REPO, "data/golden/ctraj.txt")
RVY = os.path.join(REPO, "graph/ur10/rot_variable_yaw")
RNG = np.random.default_rng(0)


def _ur10():
    return UR10("ur10", [[-1, 1], [-1, 1], [-0.5, 1]], [0, 0, 1],
                [-np.pi, 0, 0], device="cpu")


class TestDrivers:
    def test_sim_rtde_surface(self):
        from reconplan_tpu_torch.io.drivers import SimRTDE

        r = SimRTDE(_ur10(), device="cpu")
        r.move_joint([0.1, -0.5, 1.0, 0.0, 0.5, 0.0])
        assert np.allclose(r.get_joint_values(),
                           [0.1, -0.5, 1.0, 0.0, 0.5, 0.0])
        pose = r.get_tool_pose()
        assert len(pose) == 6
        r.servo_joint([0.0] * 6)
        assert ("servo_joint", [0.0] * 6) in r.command_log

    def test_read_joint_positions_reference_semantics(self):
        from reconplan_tpu.io.drivers import read_joint_positions as jread
        from reconplan_tpu_torch.io.drivers import read_joint_positions

        tg = read_joint_positions(GOLDEN)
        assert tg.shape == (25, 6)  # every 20th of 500
        assert (np.abs(tg) <= np.pi + 1e-9).all()  # wrapped
        np.testing.assert_array_equal(tg, jread(GOLDEN))

    def test_data_collector_writes_reference_layout(self, tmp_path):
        from reconplan_tpu_torch.io.drivers import DataCollector, SimRTDE
        from reconplan_tpu_torch.io.frames import load_rgbd_folder
        from reconplan_tpu_torch.io.render import SplatCamera

        robot = _ur10()
        cam = SplatCamera(width=80, height=64, fx=50, fy=50, cx=40, cy=32,
                          samples_per_mesh=50_000, device="cpu")
        cam.add_mesh_file(BANANA, translate=(0.75, 0.75, 0.0))
        dc = DataCollector(SimRTDE(robot, device="cpu"), cam,
                           out_dir=str(tmp_path / "cap"))
        targets = [np.array([0.8, -1.0, 1.7, -2.27, -1.57, 1.57]),
                   np.array([1.0, -1.0, 1.7, -2.27, -1.57, 1.57])]
        n = dc.collect_data_from_targets(targets, robot=robot)
        assert n == 2
        fs = load_rgbd_folder(str(tmp_path / "cap"))
        assert len(fs) == 2
        assert fs.intrinsics is not None


def test_tool_pose_and_teleop_anchor_match_jax():
    """``SimRTDE.get_tool_pose`` (FK + rotation vector) and the anchor
    teleop's command stream equal the JAX package's within 1e-6
    (measured max 6.0e-8)."""
    from reconplan_tpu.io import drivers as jdrivers
    from reconplan_tpu.kin import UR10 as JUR10
    from reconplan_tpu_torch.io import drivers as tdrivers

    q = [0.3, -1.1, 1.6, -2.0, -1.4, 1.2]
    out = []
    for mod, robot in ((jdrivers, JUR10("ur10", [[-1, 1], [-1, 1],
                                                [-0.5, 1]], [0, 0, 1],
                                        [-np.pi, 0, 0])),
                       (tdrivers, _ur10())):
        kw = {} if mod is jdrivers else {"device": "cpu"}
        sim = mod.SimRTDE(robot, q0=q, **kw)
        tele = mod.Teleop(sim, step=0.01)
        tele.nudge(0, +1)
        tele.nudge(2, -1)
        out.append(np.concatenate([sim.get_tool_pose(), tele.tick()]))
    assert np.abs(out[0] - out[1]).max() <= 1e-6


def test_play_ctraj_streams_the_golden_path():
    from reconplan_tpu_torch.io.drivers import SimRTDE, play_ctraj

    sim = SimRTDE(_ur10(), device="cpu")
    assert play_ctraj(sim, GOLDEN) == 500
    assert sim.command_log[-1] == ("move_joint_trajectory", 500)


class TestViz:
    def test_plots_save_pngs(self, tmp_path):
        pytest.importorskip("matplotlib")
        from reconplan_tpu_torch.grr.workspace import RoadmapWorkspace
        from reconplan_tpu_torch.viz.plots import (
            plot_trajectory_tracking,
            plot_workspace_graph,
        )

        ws = RoadmapWorkspace(_ur10(), device="cpu")
        ws.sample_workspace([0.75, 0.75, 0.0], 15, 1, "random")
        p1 = plot_workspace_graph(ws, str(tmp_path / "ws.png"))
        assert os.path.getsize(p1) > 1000
        traj = RNG.normal(size=(20, 3))
        p2 = plot_trajectory_tracking(traj, traj + 0.01,
                                      str(tmp_path / "tr.png"))
        assert os.path.getsize(p2) > 1000

    def test_roadmap_disconnections_plot(self, tmp_path):
        pytest.importorskip("matplotlib")
        from reconplan_tpu_torch.grr import RedundancyResolution
        from reconplan_tpu_torch.viz.plots import plot_roadmap_disconnections

        res = RedundancyResolution(
            make_robot(load_problem("ur10", "rot_free"), device="cpu"),
            device="cpu")
        src = os.path.join(REPO, "graph/ur10/rot_free")
        res.load_workspace_graph(os.path.join(src, "workspace.npz"))
        res.load_solver_graph(os.path.join(src, "solver.npz"))
        p = plot_roadmap_disconnections(res, str(tmp_path / "road.png"))
        assert os.path.getsize(p) > 1000


@pytest.fixture(scope="module")
def planar_pair():
    """The committed planar_5 rot_fixed workspace and solver graphs in a
    JAX and a port RedundancyResolution."""
    from reconplan_tpu.grr import RedundancyResolution as JRes
    from reconplan_tpu.kin.robot import make_robot as jmake_robot
    from reconplan_tpu_torch.grr import RedundancyResolution

    opts = load_problem("planar_5", "rot_fixed")
    out = (JRes(jmake_robot(opts)),
           RedundancyResolution(make_robot(opts, device="cpu"),
                                device="cpu"))
    for res in out:
        res.load_workspace_graph("graph/planar_5/rot_fixed/workspace.npz")
        res.load_solver_graph("graph/planar_5/rot_fixed/solver.npz")
    return out


class TestHtmlExport:
    """Twins of ``TestHtmlExport``, each page byte-equal to the JAX
    package's for the same input."""

    def test_mesh_and_cloud_html(self, tmp_path):
        from reconplan_tpu.viz import html_export as jhtml
        from reconplan_tpu_torch.viz import (
            export_cloud_html,
            export_mesh_html,
        )

        rng = np.random.default_rng(0)
        tris = rng.random((50, 3, 3))
        p = str(tmp_path / "mesh.html")
        export_mesh_html(tris, p)
        html = open(p).read()
        assert "DATA" in html and '"tris"' in html and "orbit" in html
        jhtml.export_mesh_html(tris, str(tmp_path / "jmesh.html"))
        assert html == open(tmp_path / "jmesh.html").read()

        pts = rng.random((100, 3))
        cols = rng.random((100, 3))
        p2 = str(tmp_path / "cloud.html")
        export_cloud_html(pts, p2, colors=cols)
        html2 = open(p2).read()
        assert '"colors"' in html2 and "rgb(" in html2
        jhtml.export_cloud_html(pts, str(tmp_path / "jcloud.html"),
                                colors=cols)
        assert html2 == open(tmp_path / "jcloud.html").read()

    def test_roadmap_html(self, tmp_path, planar_pair):
        from reconplan_tpu.viz import html_export as jhtml
        from reconplan_tpu_torch.viz import export_roadmap_html

        p = str(tmp_path / "roadmap.html")
        export_roadmap_html(planar_pair[1], p, obj_pos=(0.1, 0.2, 0.0))
        html = open(p).read()
        assert "configured" in html and '"edges"' in html
        jhtml.export_roadmap_html(planar_pair[0],
                                  str(tmp_path / "jroadmap.html"),
                                  obj_pos=(0.1, 0.2, 0.0))
        assert html == open(tmp_path / "jroadmap.html").read()


class TestTeleopCLI:
    def test_scripted_rtde_teleop_moves_tool(self):
        from reconplan_tpu_torch.apps.teleop import run_teleop

        n = run_teleop(mode="rtde", script="wwwq", verbose=False,
                       device="cpu")
        assert n == 3  # three ticks before 'q'

    def test_scripted_grr_teleop_runs_on_shipped_roadmap(self):
        from reconplan_tpu_torch.apps.teleop import run_teleop

        n = run_teleop(mode="grr", script="wwq", verbose=False, device="cpu")
        assert n == 2

    def test_joystick_teleop_axis_mapping(self):
        from reconplan_tpu_torch.apps.teleop import joystick_offsets, run_teleop

        class FakeStick:
            def get_axis(self, i):
                return {0: 0.0, 1: -1.0, 4: 0.5}.get(i, 0.0)

        offs = dict(joystick_offsets(FakeStick()))
        assert offs[0] == 1.0 and offs[1] == 0.0 and offs[2] == -0.5

        n = run_teleop(mode="rtde", joystick=FakeStick(), max_ticks=4,
                       rate=0.0, verbose=False, device="cpu")
        assert n == 4


class TestTeleopHTTPServer:
    def test_pointer_teleop_tick_roundtrip(self):
        """The HTTP bridge serves the viewer page and a /tick moves the
        arm toward the dragged target (klampt_vis.py:369-426 semantics),
        the solves on the resolution's device."""
        from reconplan_tpu_torch.grr import RedundancyResolution
        from reconplan_tpu_torch.viz.teleop_server import serve_teleop

        robot = make_robot(load_problem("ur10", "rot_variable_yaw"),
                           device="cpu")
        grr = RedundancyResolution(robot, device="cpu")
        grr.load_workspace_graph(os.path.join(RVY, "workspace.npz"))
        grr.load_resolution_graph(os.path.join(RVY, "resolution.npz"))
        grr.load_solver_graph(os.path.join(RVY, "solver.npz"))
        srv = serve_teleop(grr, port=0, background=True, device="cpu")
        try:
            port = srv.server_address[1]
            q_before = srv.session.q.copy()
            ee = np.asarray(srv.session.state()["ee"], dtype=float)
            target = ee + np.asarray([0.0, 0.0, 0.05])
            page = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=60).read().decode()
            assert "reconplan teleop" in page and '"points"' in page
            moved = False
            for _ in range(8):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/tick",
                    data=json.dumps({"target": target.tolist()}).encode(),
                    method="POST")
                js = json.loads(urllib.request.urlopen(req,
                                                       timeout=120).read())
                assert "links" in js and len(js["links"]) >= 3
                if not np.allclose(srv.session.q, q_before):
                    moved = True
            assert moved, js["status"]
            ee_after = np.asarray(srv.session.state()["ee"], dtype=float)
            assert (np.linalg.norm(ee_after - target)
                    < np.linalg.norm(ee - target))
        finally:
            srv.shutdown()
            srv.server_close()


def test_eval_roadmap_cli_matches_the_committed_metrics():
    """``apps.eval_roadmap.main`` on graph/ur10/rot_variable_yaw returns
    the metrics ``tests/test_torch_grr.py`` holds for the JAX package."""
    from reconplan_tpu_torch.apps.eval_roadmap import main

    m = main(["ur10", "rot_variable_yaw", "--dir", RVY, "--device", "cpu"])
    assert (m["n_nodes"], m["n_edges"], m["n_configured"]) == (5788, 30842,
                                                               2481)
    assert m["disconnection_ratio"] == pytest.approx(21.350949886639043,
                                                     rel=1e-6)
    assert m["distance_ratio"] == pytest.approx(18.51347541809082, rel=1e-6)


def test_eval_roadmap_legacy_branch_matches_jax(tmp_path, monkeypatch):
    """Without solver.npz the CLI snaps the roadmap's configurations onto
    the workspace graph (``ops.nn.nearest_neighbor``) and re-checks every
    edge: the JAX CLI's metrics (counts equal, ratios 1e-6 relative;
    measured 0: the same re-checked edges)."""
    import shutil

    from reconplan_tpu.apps import eval_roadmap as jeval
    from reconplan_tpu_torch.apps.eval_roadmap import main
    from torch_parity import jax_ik_lanes

    src = os.path.join(REPO, "graph/ur10/rot_free")
    for name in ("workspace.npz", "resolution.npz"):
        shutil.copy(os.path.join(src, name), tmp_path / name)
    got = {}
    real = jeval.evaluate_roadmap
    monkeypatch.setattr(jeval, "evaluate_roadmap",
                        lambda res: got.setdefault("jax", real(res)))
    with jax_ik_lanes():
        jeval.main(["ur10", "rot_free", "--dir", str(tmp_path)])
    m = main(["ur10", "rot_free", "--dir", str(tmp_path), "--device", "cpu"])
    want = got["jax"]
    for key in ("n_nodes", "n_edges", "n_configured"):
        assert m[key] == want[key]
    for key in ("disconnection_ratio", "distance_ratio"):
        assert m[key] == pytest.approx(want[key], rel=1e-6)


def test_record_cli_captures_two_frames(tmp_path):
    """``apps.record`` drives the simulated arm through every 250th golden
    target and renders the banana from the wrist camera."""
    from reconplan_tpu_torch.apps.record import main
    from reconplan_tpu_torch.io.frames import load_rgbd_folder

    out = str(tmp_path / "rec")
    assert main([GOLDEN, "--out", out, "--every-nth", "250",
                 "--device", "cpu"]) == 2
    fs = load_rgbd_folder(out)
    assert len(fs) == 2 and fs.intrinsics is not None
    assert (np.asarray(fs.depth[0]) > 0).any()


def test_port_imports_without_matplotlib_pil_or_pygame():
    """Every module of the port imports with matplotlib, PIL and pygame
    blocked (the machine with the card has none of them), and importing
    the package pulls none of them in."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('matplotlib', 'PIL', 'pygame'):\n"
        "    sys.modules[name] = None\n"
        "import reconplan_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    reconplan_tpu_torch.__path__, 'reconplan_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'reconplan_tpu' not in sys.modules and 'jax' not in "
        "sys.modules\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 60
