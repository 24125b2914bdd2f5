"""Benchmark: roadmap build + closed-loop scan-plan-fuse (BASELINE config 5).

UR10 GRR roadmap (arc workspace), 500-waypoint on-device arc solve, FK
camera poses, synthetic capture, brick fusion, Chamfer vs ground truth —
the full reference pipeline (redundancy.py + main.py) timed end to end.

Port of the repo's ``benchmarks/bench_grr.py``, with the same JSON keys
plus ``"device"``. The roadmap is built into a temporary directory that
is removed at the end (never into ``graph/``); the camera positions come
from one batched ``fk_all`` over the solved configurations; the fusion
launches the CUDA kernels K2 and K1 on the card. Each stage's seconds
end in a ``torch.cuda.synchronize()``.

    python -m reconplan_tpu_torch.benchmarks.bench_grr [--device cpu]
"""

import argparse
import json
import tempfile
import time

import numpy as np

from reconplan_tpu_torch.benchmarks import device_label, sync


def main(n_nodes=200, n_waypoints=500, n_images=16, grid_dim=256,
         device=None):
    """Print and return the row, with the roadmap (a
    ``RedundancyResolution`` on the device) and the fused mesh's (T, 3, 3)
    triangles, for a caller that goes on with them."""
    import torch

    from reconplan_tpu_torch.apps.redundancy import build_roadmap
    from reconplan_tpu_torch.apps.scan import BANANA_MESH, D435, OBJECT_POINT
    from reconplan_tpu_torch.grr.paths import scan_arc
    from reconplan_tpu_torch.io.meshio import load_mesh
    from reconplan_tpu_torch.io.render import SplatCamera
    from reconplan_tpu_torch.kin.chain import fk_all
    from reconplan_tpu_torch.ops import tsdf_brick as tb
    from reconplan_tpu_torch.ops.marching import marching_cubes
    from reconplan_tpu_torch.ops.tsdf import TSDFGrid
    from reconplan_tpu_torch.recon.metrics import chamfer_to_mesh
    from reconplan_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bench_grr_roadmap") as out_dir:
        grr, metrics = build_roadmap(
            "ur10", "rot_free", n_pos_points=n_nodes,
            sampling_method="random", out_dir=out_dir, verbose=False,
            device=dev,
        )
    sync(dev)
    t_roadmap = time.perf_counter() - t0

    arc = scan_arc(OBJECT_POINT, num_points=n_waypoints, device=dev)
    t0 = time.perf_counter()
    qs, ok = grr.solve_batch(arc)
    sync(dev)
    t_solve = time.perf_counter() - t0
    qs_ok = qs[ok]

    robot = grr.robot
    q_full = robot._full_config(torch.as_tensor(qs_ok, device=dev))
    _, t_links = fk_all(robot.model, q_full)
    cam_positions = t_links[:, robot.camera_link].cpu().numpy()

    cam = SplatCamera(**D435, device=dev)
    cam.add_mesh_file(BANANA_MESH, translate=OBJECT_POINT)
    pick = np.linspace(0, len(qs_ok) - 1, n_images).astype(int)
    t0 = time.perf_counter()
    frames = [cam.take_picture(cam_positions[i], OBJECT_POINT) for i in pick]
    sync(dev)
    t_capture = time.perf_counter() - t0
    depths = torch.stack([f[0] for f in frames])
    poses = np.stack([f[2] for f in frames]).astype(np.float32)

    grid = tb.make_brick_grid(
        (grid_dim,) * 3,
        (OBJECT_POINT[0] - 0.15, OBJECT_POINT[1] - 0.15, -0.05),
        0.3 / (grid_dim - 1), device=dev,
    )
    t0 = time.perf_counter()
    grid, na = tb.integrate_frames_bricked_device(
        grid, depths, poses, D435["fx"], D435["fy"], D435["cx"], D435["cy"],
        max_active=16384,
    )
    sync(dev)
    t_fuse = time.perf_counter() - t0

    sdf, weight = tb.to_dense(grid)
    f32 = dict(dtype=torch.float32, device=dev)
    dense = TSDFGrid(
        sdf, weight, torch.zeros((0, 0, 0, 3), **f32), grid.origin,
        torch.tensor(grid.voxel_size, **f32),
        torch.tensor(grid.trunc, **f32),
    )
    tris = marching_cubes(dense)
    gt_v, gt_f = load_mesh(BANANA_MESH)
    gt_v = gt_v + np.asarray(OBJECT_POINT)
    ch = None
    if len(tris):
        ch, _, _ = chamfer_to_mesh(tris.reshape(-1, 3), gt_v, gt_f)

    row = {
        "config": "closed-loop scan-plan-fuse",
        "roadmap_nodes": n_nodes,
        "roadmap_seconds": round(t_roadmap, 1),
        "disconnection_ratio_pct": round(metrics["disconnection_ratio"], 2),
        "waypoints_solved": int(np.asarray(ok).sum()),
        "waypoints_total": n_waypoints,
        "solve_seconds": round(t_solve, 2),
        "capture_seconds": round(t_capture, 2),
        "fuse_seconds": round(t_fuse, 2),
        "triangles": int(len(tris)),
        "chamfer_mm": round(ch * 1000, 3) if ch else None,
        "total_seconds": round(time.perf_counter() - t_all, 1),
        "device": label,
    }
    print(json.dumps(row), flush=True)
    return row, grr, tris


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    main(device=ap.parse_args().device)
