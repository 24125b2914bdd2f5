"""Stitching CLI — port of ``reconplan_tpu.apps.stitch`` (the reference's
``python stitcher.py``).

Loads a recorded RGBD capture directory (sim PNG-depth layout or RealSense
.npy-depth layout), stitches it frame to model with the reference's
defaults on ``--device`` (default: the card), and writes the stitched
cloud as PLY.

Usage: python -m reconplan_tpu_torch.apps.stitch [capture_dir] [--out cloud.ply]
"""

from __future__ import annotations

import argparse

from reconplan_tpu_torch.io.meshio import save_ply
from reconplan_tpu_torch.recon.stitcher import PinholeIntrinsic, RGBDStitcher

# stitcher.py:264-267 intrinsics
D435 = dict(fx=615.6707153320312, fy=615.962158203125,
            cx=326.0557861328125, cy=240.55592346191406)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("capture_dir", nargs="?", default="./camera")
    ap.add_argument("--rgb", default="rgb")
    ap.add_argument("--depth", default="depth")
    ap.add_argument("--out", default="stitched_cloud.ply")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    args = ap.parse_args(argv)

    stitcher = RGBDStitcher(
        PinholeIntrinsic(args.width, args.height, **D435), device=args.device
    )
    colors, depths = stitcher.load_dataset_two_folders(
        args.capture_dir, args.rgb, args.depth
    )
    print(f"Loaded {len(colors)} frames from {args.capture_dir}")
    cloud = stitcher.stitch_sequence(colors, depths)
    pts, cols, _ = cloud.compact()
    print(f"Stitched cloud: {len(pts)} points")
    save_ply(args.out, vertices=pts, colors=cols if len(cols) else None)
    print(f"Wrote {args.out}")


if __name__ == "__main__":
    main()
