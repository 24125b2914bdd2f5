"""Localize the closed-loop scan's gt->mesh Chamfer tail.

The closed-loop scan (apps/scan.py; reference protocol ``main.py:68-136``)
reports a symmetric Chamfer whose gt->mesh direction dominates whenever
viewpoint COVERAGE misses part of the object (round 3: 1.687 mm gt->mesh
vs 0.390 mesh->gt at 6 arcs / 72 images). This tool answers "missing
WHERE": it samples the ground-truth surface densely, measures the exact
point-to-triangle distance to the reconstructed mesh, and bins the error
by height band and azimuth sector around the object center — so an arc
schedule can be pointed at the actual gap instead of tuned blind.

Port of the repo's ``benchmarks/eval_scan_coverage.py``, with its flags
less ``--platform`` (``--device`` takes its place: by default the CUDA
card) and its lines, after one that names the device.

Usage:
  python -m reconplan_tpu_torch.benchmarks.eval_scan_coverage \\
      --mesh scan_output/fused_mesh.ply [--device cpu]
"""
import argparse

import numpy as np

from reconplan_tpu_torch.benchmarks import device_label


def main(argv=None):
    """Print the table; return the per-sample distances (mm) and the
    bins' means (mm): {"height": [...], "azimuth": {sector: mean}}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", default="scan_output/fused_mesh.ply",
                    help="reconstructed mesh (triangle soup PLY from scan)")
    ap.add_argument("--samples", type=int, default=60_000)
    ap.add_argument("--bins-z", type=int, default=4)
    ap.add_argument("--bins-az", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    args = ap.parse_args(argv)

    from reconplan_tpu_torch.apps.scan import BANANA_MESH, OBJECT_POINT
    from reconplan_tpu_torch.io.meshio import load_mesh, sample_mesh_surface
    from reconplan_tpu_torch.recon.metrics import points_to_mesh_distance
    from reconplan_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    print(f"device: {device_label(dev)}")
    rec_v, rec_f = load_mesh(args.mesh)
    rec_tris = rec_v[rec_f] if rec_f is not None and len(rec_f) else \
        rec_v.reshape(-1, 3, 3)
    gt_v, gt_f = load_mesh(BANANA_MESH)
    gt_v = gt_v + np.asarray(OBJECT_POINT)
    surf, _ = sample_mesh_surface(gt_v, gt_f, args.samples, seed=0)
    surf = surf.astype(np.float32)

    d = points_to_mesh_distance(surf, rec_tris.astype(np.float32),
                                device=dev).cpu().numpy() * 1000.0  # mm

    rel = surf - np.asarray(OBJECT_POINT, np.float32)
    z = surf[:, 2]
    az = np.degrees(np.arctan2(rel[:, 1], rel[:, 0])) % 360.0

    print(f"mesh: {args.mesh} ({len(rec_tris)} triangles)")
    print(f"gt->mesh over {len(surf)} GT samples: "
          f"mean {d.mean():.3f} mm  median {np.median(d):.3f}  "
          f"q95 {np.quantile(d, 0.95):.3f}  q99 {np.quantile(d, 0.99):.3f}  "
          f">1mm {np.mean(d > 1.0):.1%}  >2mm {np.mean(d > 2.0):.1%}")

    def band(b):
        hi = (z <= z_edges[b + 1] if b == args.bins_z - 1
              else z < z_edges[b + 1])
        return (z >= z_edges[b]) & hi

    table = {"height": [], "azimuth": {}}
    z_edges = np.quantile(z, np.linspace(0, 1, args.bins_z + 1))
    print("\nby height band (GT z, equal-count bands):")
    for b in range(args.bins_z):
        m = band(b)
        print(f"  z [{z_edges[b]*1000:7.1f}, {z_edges[b+1]*1000:7.1f}] mm: "
              f"mean {d[m].mean():.3f}  q95 {np.quantile(d[m], 0.95):.3f}  "
              f">1mm {np.mean(d[m] > 1.0):5.1%}  (n={m.sum()})")
        table["height"].append(float(d[m].mean()))

    print("\nby azimuth sector (around object center):")
    width = 360.0 / args.bins_az
    for b in range(args.bins_az):
        m = (az >= b * width) & (az < (b + 1) * width)
        if m.sum() == 0:
            continue
        print(f"  az [{b*width:5.1f}, {(b+1)*width:5.1f}) deg: "
              f"mean {d[m].mean():.3f}  q95 {np.quantile(d[m], 0.95):.3f}  "
              f">1mm {np.mean(d[m] > 1.0):5.1%}  (n={m.sum()})")
        table["azimuth"][b] = float(d[m].mean())

    # worst cells of the z x az grid — the concrete viewpoint gap list
    print("\nworst (height band x azimuth sector) cells by mean error:")
    cells = []
    for bz in range(args.bins_z):
        mz = band(bz)
        for ba in range(args.bins_az):
            m = mz & (az >= ba * width) & (az < (ba + 1) * width)
            if m.sum() >= 20:
                cells.append((float(d[m].mean()), bz, ba, int(m.sum())))
    cells.sort(reverse=True)
    for mean_d, bz, ba, n in cells[:8]:
        print(f"  z [{z_edges[bz]*1000:6.1f},{z_edges[bz+1]*1000:6.1f}] mm x "
              f"az [{ba*width:5.1f},{(ba+1)*width:5.1f}) deg: "
              f"mean {mean_d:.3f} mm (n={n})")
    return d, table


if __name__ == "__main__":
    main()
