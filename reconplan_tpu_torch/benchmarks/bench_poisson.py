"""Benchmark: Poisson reconstruction of the banana (BASELINE config 2).

Samples the YCB banana surface (standing in for a stitched cloud), runs the
spectral Poisson solve, and reports Chamfer vs the reference ``poisson/``
mesh + solve time.

Port of the repo's ``benchmarks/bench_poisson.py``: one warm and one
timed solve, the same JSON keys, plus ``"device"``. The timed solve ends
in a ``torch.cuda.synchronize()``.

    python -m reconplan_tpu_torch.benchmarks.bench_poisson [--device cpu]
"""

import argparse
import json
import os
import time

import numpy as np

from reconplan_tpu_torch.benchmarks import REPO, device_label, sync

BANANA = os.path.join(REPO, "data/objects/011_banana/poisson/nontextured.ply")


def main(n_points=60_000, depth=128, device=None):
    """Print and return the row."""
    from reconplan_tpu_torch.io.meshio import load_mesh, sample_mesh_surface
    from reconplan_tpu_torch.recon.metrics import chamfer_to_mesh
    from reconplan_tpu_torch.recon.poisson import poisson_reconstruct
    from reconplan_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    v, f = load_mesh(BANANA)
    pts, nrm = sample_mesh_surface(v, f, n_points, seed=0)
    pts = pts.astype(np.float32)
    nrm = nrm.astype(np.float32)

    # warm
    tris = poisson_reconstruct(pts, nrm, depth=depth, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    tris = poisson_reconstruct(pts, nrm, depth=depth, device=dev)
    sync(dev)
    dt = time.perf_counter() - t0

    ch, p_mesh2gt, p_gt2mesh = chamfer_to_mesh(tris.reshape(-1, 3), v, f)
    row = {
        "config": "banana poisson reconstruction",
        "depth": depth,
        "input_points": n_points,
        "solve_seconds": round(dt, 2),
        "triangles": int(len(tris)),
        "chamfer_mm": round(ch * 1000, 3),
        "mesh_to_gt_mm": round(p_mesh2gt * 1000, 3),
        "gt_to_mesh_mm": round(p_gt2mesh * 1000, 3),
        "device": label,
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    main(device=ap.parse_args().device)
