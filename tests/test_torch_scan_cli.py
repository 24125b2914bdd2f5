"""The port's scan command line with its own defaults (``--reconstruct
both --close-mode auto``) on the CPU, at a small size: 24 waypoints,
three pictures, a 64^3 fusion grid and a 64^3 Poisson grid. It runs
every route of ``run_scan`` once: fusion, the Poisson closure and its
auto gate, and the pose-seeded ICP stitch (640x480 pictures, 8,192
model slots). Port only: the routes are held against the JAX package in
``tests/test_torch_scan.py``, ``test_torch_poisson.py`` and
``test_torch_stitch.py``."""

import os

import numpy as np
import torch

from reconplan_tpu_torch.apps import scan as tscan

torch.set_num_threads(2)

ROADMAP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "graph", "ur10", "rot_free")


def test_scan_cli_runs_every_route_with_its_defaults(tmp_path):
    got = tscan.main(["--roadmap", ROADMAP, "--device", "cpu", "--out",
                      str(tmp_path), "--waypoints", "24", "--images", "3",
                      "--grid", "64", "--close-depth", "64"])
    assert got["device"] == "cpu"
    for key in ("fuse_chamfer_mm", "closed_chamfer_mm", "best_chamfer_mm",
                "stitch_chamfer_mm"):
        assert np.isfinite(got[key]) and 0 < got[key] < 20, key
    assert got["best_mesh"] == got["close_gate"]["best"]
    assert got["best_chamfer_mm"] == got[{"open": "fuse_chamfer_mm",
                                          "closed": "closed_chamfer_mm"}[
                                              got["best_mesh"]]]
    assert set(got["stage_timings"]) == {"plan", "capture", "fuse",
                                         "poisson_close", "close_gate",
                                         "stitch"}
    assert sorted(os.listdir(tmp_path)) == [
        "best_mesh.ply", "closed_mesh.ply", "ctraj.txt", "fused_mesh.ply",
        "stitched_cloud.ply", "trackarr.txt", "wtraj.txt", "wtraj_input.txt"]
