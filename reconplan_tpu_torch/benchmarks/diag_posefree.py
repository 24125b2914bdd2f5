"""Diagnose the pose-free stitch on the multi-arc scan protocol:
per-frame estimated-vs-true camera pose error (rotation deg, translation
mm), using the stitcher's ``last_transforms`` diagnostics.

Port of the repo's ``benchmarks/diag_posefree.py``, with its flags less
``--platform`` (``--device`` takes its place: by default the CUDA card)
and its lines, after one that names the device. The capture is
``bench_stitch``'s. RANSAC draws from a torch generator, a stream other
than the JAX package's, so the errors compare by outcome only.

Usage: python -m reconplan_tpu_torch.benchmarks.diag_posefree
           [--frames 32] [--device cpu]
"""
import argparse

import numpy as np

from reconplan_tpu_torch.benchmarks import device_label
from reconplan_tpu_torch.benchmarks.bench_stitch import capture


def _angle_deg(R):
    return np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def main(argv=None):
    """Print one line a registered frame; return them as dicts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--arcs", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=1 << 16)
    ap.add_argument("--frame-capacity", type=int, default=1 << 14)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    args = ap.parse_args(argv)

    from reconplan_tpu_torch.apps.scan import D435
    from reconplan_tpu_torch.recon.stitcher import (
        PinholeIntrinsic, RGBDStitcher)
    from reconplan_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    print(f"device: {device_label(dev)}")
    colors, depths, poses, per_arc = capture(args.frames, args.arcs, True,
                                             dev)

    st = RGBDStitcher(PinholeIntrinsic(640, 480, **D435), device=dev)
    st.voxel_size = 0.004
    st.distance_threshold = 0.02
    st.model_capacity = args.capacity
    st.frame_capacity = args.frame_capacity
    st.stitch_sequence(colors, depths, poses=None)

    # truth, expressed in camera-0 coordinates like the estimates
    T0inv = np.linalg.inv(poses[0])
    gt_rel = np.einsum("ij,fjk->fik", T0inv, poses[1:])
    est = st.last_transforms
    rows = []
    for i, (Tg, Te, fit, sc) in enumerate(
        zip(gt_rel, est, st.last_fits, st.last_scores)
    ):
        d = Te @ np.linalg.inv(Tg)
        rot = _angle_deg(d[:3, :3])
        tr = np.linalg.norm(d[:3, 3]) * 1000
        # step size from previous true pose (how far the camera moved)
        prev = gt_rel[i - 1] if i > 0 else np.eye(4, dtype=np.float32)
        step_rot = _angle_deg((Tg @ np.linalg.inv(prev))[:3, :3])
        jump = (i + 1) % per_arc == 0
        mark = " <-- ARC JUMP" if jump else ""
        print(
            f"frame {i+1:2d}: fit {float(fit):.3f} "
            f"s1 {float(sc[0]):.3f} sb {float(sc[1]):.3f}  "
            f"err rot {rot:7.2f} deg "
            f"trans {tr:8.2f} mm   (true step {step_rot:6.2f} deg){mark}",
            flush=True,
        )
        rows.append({"frame": i + 1, "fit": float(fit), "s1": float(sc[0]),
                     "sb": float(sc[1]), "rot_deg": float(rot),
                     "trans_mm": float(tr), "step_deg": float(step_rot),
                     "arc_jump": jump})
    return rows


if __name__ == "__main__":
    main()
