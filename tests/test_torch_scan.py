"""``reconplan_tpu_torch.apps`` (the roadmap build, the scan's fuse route
end to end, and its Poisson close route with the auto gate) against the
JAX package on the CPU. The plan alone is held in
``tests/test_torch_scan_plan.py``, the CLI with its defaults in
``tests/test_torch_scan_cli.py``.

The same arguments go through the JAX entry point (jitted, on the CPU)
and its port with ``device="cpu"``; both pick the dense fusion engine
there. The JAX package's batched IK runs in batches of 64 problems
(``torch_parity.jax_ik_lanes``), which changes no problem's answer.

Tolerances and why:
* arc schedules and the waypoints written to ``wtraj_input.txt``: 1e-6.
* the scan as a whole: solved waypoints equal within one, the fused
  mesh's Chamfer distance to the banana within 5% of the JAX value.
* the close route on the same three pictures (8,000 observation
  points, a 64^3 Poisson grid): the same gate decision and fractions,
  the closed meshes' Chamfer distances to the banana within 1%. The
  JAX ``run_scan`` is not run for it: its 80,000 default observation
  points would make the normals' k-NN an 80,000^2 product.
"""

import os
import re

import numpy as np
import pytest
import torch

from reconplan_tpu.apps import scan as jscan
from reconplan_tpu.grr import resolution as jres
from reconplan_tpu.kin import robot as jrobot
from reconplan_tpu_torch.apps import redundancy as tredundancy
from reconplan_tpu_torch.apps import scan as tscan
from reconplan_tpu_torch.grr import paths
from reconplan_tpu_torch.io.config import load_problem
from reconplan_tpu_torch.recon import metrics as tmetrics
from torch_parity import jax_ik_lanes

torch.set_num_threads(2)

ROADMAP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "graph", "ur10", "rot_free")


@pytest.fixture(scope="module", autouse=True)
def lanes():
    with jax_ik_lanes():
        yield


def test_make_arc_schedule_matches_jax():
    for n_arcs, per_arc in ((1, 50), (6, 12)):
        want = jscan.make_arc_schedule(n_arcs, per_arc)
        got = tscan.make_arc_schedule(n_arcs, per_arc, device="cpu")
        assert len(got) == len(want) == n_arcs
        for g, w in zip(got, want):
            assert g.shape == (per_arc, 7)
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


def test_scan_arc_azimuth_rotates_the_arc_plane():
    """The twins of ``TestScanArcAzimuth``."""
    base = paths.scan_arc(tscan.OBJECT_POINT, num_points=16, device="cpu")
    rot = paths.scan_arc(tscan.OBJECT_POINT, num_points=16,
                         azimuth=3 * np.pi / 4 + np.pi / 2, device="cpu")
    np.testing.assert_allclose(base[:, 2], rot[:, 2], atol=1e-6)
    assert not np.allclose(base[:, 1], rot[:, 1])
    for p in rot[::5]:
        assert 0.05 < np.linalg.norm(np.asarray(tscan.OBJECT_POINT) - p[:3]) \
            < 0.6
    arc = paths.scan_arc(tscan.OBJECT_POINT, radius=0.3, height=0.15,
                         num_points=8, device="cpu")
    t = np.linspace(0, np.pi, 8)
    x = 0.75 - 0.15 * np.cos(np.pi / 4) + 0.3 * np.cos(t) * np.cos(
        3 * np.pi / 4)
    np.testing.assert_allclose(arc[:, 0], x, atol=1e-6)


def test_build_roadmap_writes_what_the_jax_package_loads(tmp_path):
    res, metrics = tredundancy.build_roadmap(
        "ur10", "rot_free", n_pos_points=16, seeds="init",
        out_dir=str(tmp_path), verbose=False, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["resolution.npz", "solver.npz",
                                            "workspace.npz"]
    assert metrics["n_nodes"] == 16 and metrics["n_configured"] > 0
    back = jres.RedundancyResolution(jrobot.make_robot(
        load_problem("ur10", "rot_free")))
    back.load_resolution_graph(str(tmp_path / "resolution.npz"))
    back.load_workspace_graph(str(tmp_path / "workspace.npz"))
    back.load_solver_graph(str(tmp_path / "solver.npz"))
    np.testing.assert_array_equal(back.configs, res.configs)
    np.testing.assert_array_equal(back.edges, res.edges)
    np.testing.assert_array_equal(back.workspace.edges, res.workspace.edges)
    np.testing.assert_array_equal(back.solver.has_config,
                                  res.solver.has_config)
    ee = res.robot.fk_point_batch(res.configs).numpy()
    assert np.linalg.norm(ee[:, :3] - res.points[:, :3], axis=-1).max() < 1e-3


def read_waypoints(path):
    with open(path) as f:
        return np.array([[float(x) for x in re.findall(
            r"-?\d+\.?\d*(?:[eE][+-]?\d+)?",
            re.sub(r"np\.float32\(([^)]*)\)", r"\1", line))] for line in f])


def test_run_scan_matches_jax(tmp_path):
    """The slice as a whole: roadmap, 24-waypoint plan, FK, 3 pictures,
    fusion at 64^3 (the dense engine on the CPU), marching cubes, Chamfer
    against the banana."""
    kw = dict(roadmap_dir=ROADMAP, n_waypoints=24, n_images=3, grid_dim=64,
              reconstruct="fuse", close_mesh=False, verbose=False)
    want = jscan.run_scan(out_dir=str(tmp_path / "jax"), **kw)
    got = tscan.run_scan(out_dir=str(tmp_path / "port"), device="cpu", **kw)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == ["ctraj.txt", "fused_mesh.ply", "trackarr.txt",
                     "wtraj.txt", "wtraj_input.txt"]
    assert files == sorted(os.listdir(tmp_path / "jax"))
    np.testing.assert_allclose(
        read_waypoints(tmp_path / "port" / "wtraj_input.txt"),
        read_waypoints(tmp_path / "jax" / "wtraj_input.txt"), rtol=0,
        atol=1e-6)
    solved = [sum(line.split(",", 1)[1].strip() != "None"
                  for line in open(tmp_path / side / "ctraj.txt")
                  if "," in line) for side in ("jax", "port")]
    assert abs(solved[1] - solved[0]) <= 1 and solved[1] >= 22
    assert got["plan"]["waypoints"] == 24
    assert got["plan"]["carried"] + got["plan"]["rescued"] == solved[1]
    assert got["best_mesh"] == want["best_mesh"] == "open"
    assert got["fuse_chamfer_mm"] == pytest.approx(want["fuse_chamfer_mm"],
                                                   rel=0.05)
    assert set(got["stage_timings"]) == set(want["stage_timings"]) == {
        "plan", "capture", "fuse"}


@pytest.mark.parametrize("kw,slice_", [
    (dict(reconstruct="stitch"), "Slice C"),
    (dict(reconstruct="both"), "Slice C"),
    (dict(close_mesh=True), "Slice D"),
    (dict(close_mesh="auto"), "Slice D"),
])
def test_routes_not_ported_raise(kw, slice_, tmp_path):
    """The stitch (Slice C) and close (Slice D) routes, which raised
    ``NotImplementedError`` before they were ported, now run and write
    their files and result keys (two waypoints, one picture, 32^3)."""
    args = dict(roadmap_dir=ROADMAP, n_waypoints=2, n_images=1, grid_dim=32,
                close_depth=32, reconstruct="fuse", close_mesh=False,
                out_dir=str(tmp_path), device="cpu", verbose=False)
    args.update(kw)
    got = tscan.run_scan(**args)
    files = set(os.listdir(tmp_path))
    if slice_ == "Slice C":
        assert "stitched_cloud.ply" in files
        assert np.isfinite(got["stitch_chamfer_mm"])
        assert ("fused_mesh.ply" in files) == (kw["reconstruct"] == "both")
        assert "stitch" in got["stage_timings"]
    else:
        assert {"fused_mesh.ply", "closed_mesh.ply"} <= files
        assert np.isfinite(got["closed_chamfer_mm"])
        assert "poisson_close" in got["stage_timings"]
        # only the auto gate picks a best mesh, as in the JAX package
        assert ("best_mesh" in got) == (kw["close_mesh"] == "auto")
        assert ("best_mesh.ply" in files) == ("close_gate" in got)


@pytest.fixture(scope="module")
def three_pictures():
    """Three pictures of the banana by the scan's D435 from eyes on the
    scan arc (24 waypoints), as numpy, and the port's fused 64^3 mesh."""
    from reconplan_tpu_torch.io.frames import FrameSet
    from reconplan_tpu_torch.io.render import SplatCamera
    from reconplan_tpu_torch.recon.fusion import FusionPipeline

    arc = tscan.make_arc_schedule(1, 24, device="cpu")[0]
    cam = SplatCamera(**tscan.D435, device="cpu")
    cam.add_mesh_file(tscan.BANANA_MESH, translate=tscan.OBJECT_POINT)
    shots = [cam.take_picture(arc[i, :3], tscan.OBJECT_POINT)
             for i in (0, 11, 23)]
    frames = FrameSet(
        depth=np.stack([d.numpy() for d, _, _ in shots]),
        color=np.stack([c.numpy() for _, c, _ in shots]),
        poses=np.stack([T for _, _, T in shots]).astype(np.float32),
        depth_scale=1000.0,
        intrinsics=tuple(tscan.D435[k] for k in ("fx", "fy", "cx", "cy")))
    pipe = FusionPipeline(
        dims=(64,) * 3, origin=(0.6, 0.6, -0.05), voxel_size=0.3 / 63,
        with_color=True, engine="dense", device="cpu")
    pipe.integrate(frames)
    mesh = pipe.extract_mesh().numpy()
    lo = np.asarray(pipe.origin, np.float32)
    return frames, mesh, (lo, lo + 63 * pipe.voxel_size)


def test_close_route_matches_jax(three_pictures):
    from reconplan_tpu.io.meshio import load_mesh

    frames, mesh, bounds = three_pictures
    assert len(mesh) > 100
    obs_j, cams_j = jscan.build_observation_cloud(frames, max_points=8000)
    obs_t, cams_t = tscan.build_observation_cloud(frames, max_points=8000,
                                                  device="cpu")
    np.testing.assert_allclose(obs_t, obs_j, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(cams_t, cams_j)
    closed_j = jscan.poisson_close_mesh(obs_j, cams_j, depth=64)
    closed_t = tscan.poisson_close_mesh(obs_t, cams_t, depth=64,
                                        device="cpu")
    assert abs(len(closed_t) - len(closed_j)) <= 0.01 * len(closed_j)
    gj = jscan.close_gate_signals(mesh, closed_j, obs_j, frames=frames,
                                  volume_bounds=bounds)
    gt = tscan.close_gate_signals(mesh, closed_t, obs_t, frames=frames,
                                  volume_bounds=bounds, device="cpu")
    assert gt["best"] == gj["best"]
    for k in ("hole_frac", "refuted_frac", "unobserved_frac"):
        assert gt[k] == pytest.approx(gj[k], abs=2e-3), k
    gt_v, gt_f = load_mesh(tscan.BANANA_MESH)
    gt_v = gt_v + np.asarray(tscan.OBJECT_POINT)
    ch = [tmetrics.chamfer_to_mesh(c.reshape(-1, 3), gt_v, gt_f,
                                   n_surface_samples=50_000, device="cpu")[0]
          for c in (closed_j, closed_t)]
    assert ch[1] == pytest.approx(ch[0], rel=0.01)


def test_redundancy_main_builds_into_its_out_folder(tmp_path):
    tredundancy.main(["ur10", "rot_free", "--nodes", "16", "--seeds", "json",
                      "--out", str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["resolution.npz", "solver.npz",
                                            "workspace.npz"]
