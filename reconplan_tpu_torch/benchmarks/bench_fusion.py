"""Benchmark: banana orbit fusion at 256^3/512^3 + Chamfer (configs 1, 3, 4).

Renders an orbit of synthetic D435 frames around the YCB banana, fuses with
the brick engine, extracts a mesh, and reports throughput + Chamfer error
vs the YCB ground truth.

Port of the repo's ``benchmarks/bench_fusion.py``: the same scene, the
same REPS = 5 batches after one warm batch, the same JSON keys, plus
``"device"``. The fusion is ``integrate_frames_bricked_device``, which
launches the CUDA kernels K2 (active mask) and K1 (brick integrate) on
the card. A batch is timed on the host clock between two
``torch.cuda.synchronize()`` calls, so there is no readback baseline to
subtract.

    python -m reconplan_tpu_torch.benchmarks.bench_fusion [--device cpu]
"""

import argparse
import json
import os
import time

import numpy as np

from reconplan_tpu_torch.benchmarks import REPO, device_label, sync

OBJ = [0.0, 0.0, 0.0]
BANANA = os.path.join(REPO, "data/objects/011_banana/tsdf/nontextured.ply")
# timed batches a grid, after one warm batch
REPS = 5


def main(n_frames=32, dims=(256, 512), device=None):
    """Fuse the orbit at each of ``dims``; print and return one row a
    grid."""
    import torch

    from reconplan_tpu_torch.io.meshio import load_mesh
    from reconplan_tpu_torch.io.render import SplatCamera
    from reconplan_tpu_torch.ops import tsdf_brick as tb
    from reconplan_tpu_torch.ops.marching import marching_cubes
    from reconplan_tpu_torch.ops.tsdf import TSDFGrid
    from reconplan_tpu_torch.recon.metrics import chamfer_to_mesh
    from reconplan_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    cam = SplatCamera(device=dev).add_mesh_file(BANANA, translate=OBJ)
    depths, poses = [], []
    for k in range(n_frames):
        ang = 2 * np.pi * k / n_frames
        eye = [OBJ[0] + 0.35 * np.cos(ang), OBJ[1] + 0.35 * np.sin(ang),
               OBJ[2] + 0.25]
        d, _, T = cam.take_picture(eye, OBJ)
        depths.append(d)
        poses.append(T)
    depths = torch.stack(depths)
    poses = np.stack(poses).astype(np.float32)
    fx, fy, cx, cy = cam.intrinsics

    gt_v, gt_f = load_mesh(BANANA)
    gt_v = gt_v + np.asarray(OBJ)

    rows = []
    for N in dims:
        grid = tb.make_brick_grid(
            (N, N, N), (OBJ[0] - 0.2, OBJ[1] - 0.2, OBJ[2] - 0.15),
            0.4 / (N - 1), device=dev,
        )
        grid, na = tb.integrate_frames_bricked_device(
            grid, depths, poses, fx, fy, cx, cy, max_active=8192
        )
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(REPS):
            grid, na = tb.integrate_frames_bricked_device(
                grid, depths, poses, fx, fy, cx, cy, max_active=8192
            )
        sync(dev)
        dt = max((time.perf_counter() - t0) / REPS, 1e-9)
        fps = n_frames / dt

        sdf, weight = tb.to_dense(grid)
        f32 = dict(dtype=torch.float32, device=dev)
        dense = TSDFGrid(
            sdf, weight, torch.zeros((0, 0, 0, 3), **f32), grid.origin,
            torch.tensor(grid.voxel_size, **f32),
            torch.tensor(grid.trunc, **f32),
        )
        tris = marching_cubes(dense)
        ch = None
        if len(tris):
            ch, _, _ = chamfer_to_mesh(tris.reshape(-1, 3), gt_v, gt_f)
        row = {
            "config": "banana orbit fusion",
            "grid": N,
            "frames": n_frames,
            "active_bricks": int(na),
            "fps": round(fps, 1),
            "triangles": int(len(tris)),
            "chamfer_mm": round(ch * 1000, 3) if ch else None,
            "device": label,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    main(device=ap.parse_args().device)
