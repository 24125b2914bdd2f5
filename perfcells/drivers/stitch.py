"""Stitch cells: a scan's RGBD pictures stitched into a point model by
``recon/stitcher.RGBDStitcher.stitch_sequence``, each registration seeded
by the picture's camera pose, with the configuration's settings set on
the stitcher as ``apps/scan.run_scan`` sets them.

Set-up renders the cell's scans through the frozen renderer, each the
arc schedule's pictures with its base azimuth turned by a draw from the
seed, and stitches one whole sequence, which warms every shape and the
cuBLAS and cuSOLVER handles. The window stitches the scans in turn, each
sequence from an empty model and ended by a host read of the compacted
model. How many steps an ICP takes before its rmse settles depends on
the view, so a run takes several views: one view's rate moves by a
fifth from seed to seed. ``fuse_fps`` is every picture of every whole
sequence over the window's whole time: a picture is fused when it is
stitched into the model. The judge holds the last sequence (its
per-frame transforms, the steps of each ICP stage and its overflow)
against the plain reference (``reference/stitch.py``) run after the
window on the same pictures. It also reads the model's stray share
against the reference's model and its Chamfer to the object's mesh,
which the cell file does not limit.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfcells.common import ROOT, no_span
from perfcells.reference import stitch as ref
from perfcells.traffic import arcs, render


def render_scans(cell, config, seed, device):
    """The cell's ``scans`` scans the seed gives, each (colors [(H, W, 3)
    uint8], depths [(H, W) mm], poses (F, 4, 4) f32 camera-to-world) on
    ``device``, and the camera's intrinsics. The base azimuths are
    ``arcs.BASE_AZIMUTH`` turned by uniform draws from ``azimuth_turn``,
    the first that of ``arcs.seeded_azimuth``."""
    turns = np.random.default_rng(seed).uniform(*cell["azimuth_turn"],
                                                cell["scans"])
    obj = config["object_point"]
    cam = render.SplatCamera(**config["camera"], device=device)
    cam.add_mesh_file(os.path.join(ROOT, config["object_mesh"]),
                      translate=obj)
    scans = []
    for turn in turns:
        eyes = np.concatenate(arcs.make_arc_schedule(
            cell["arcs"], cell["per_arc"], arcs.BASE_AZIMUTH + turn))[:, :3]
        pics = [cam.take_picture(eye, obj) for eye in eyes]
        scans.append(([c for _, c, _ in pics], [d for d, _, _ in pics],
                      np.stack([T for _, _, T in pics]).astype(np.float32)))
    return scans, cam.intrinsics


def make_stitcher(config, intrinsics, device):
    """The program's stitcher with the configuration's settings."""
    from reconplan_tpu_torch.recon.stitcher import (
        PinholeIntrinsic,
        RGBDStitcher,
    )

    cam = config["camera"]
    st = RGBDStitcher(PinholeIntrinsic(cam["width"], cam["height"],
                                       *intrinsics), device=device)
    if not hasattr(st, "last_overflow"):
        raise RuntimeError("the program's RGBDStitcher does not report the "
                           "voxels it drops (last_overflow); the judge "
                           "needs them")
    st.voxel_size = config["voxel_size"]
    st.distance_threshold = config["distance_threshold"]
    st.model_capacity = config["model_capacity"]
    st.frame_capacity = config["frame_capacity"]
    st.optimization_modulus = config["outlier_every"]
    st.outlier_std_ratio = config["outlier_std_ratio"]
    st.pose_trust_trans = config["pose_trust_m"]
    st.pose_trust_rot = config["pose_trust_rad"]
    return st


def setup(cell, config, seed, device):
    scans, intr = render_scans(cell, config, seed, device)
    st = make_stitcher(config, intr, device)
    s = SimpleNamespace(cell=cell, config=config, device=device,
                        stitcher=st, scans=scans, intr=intr, last=None)
    sequence(s, scans[0])  # warms every shape and the library handles
    return s


def sequence(s, scan, spans=no_span):
    """One stitch of every picture of ``scan`` from an empty model, ended
    by a host read of the compacted model. Returns (points, colors) as
    numpy."""
    colors, depths, poses = scan
    with spans("stitch_cell.sequence"):
        cloud = s.stitcher.stitch_sequence(colors, depths, poses=poses)
    with spans("stitch_cell.read"):
        pts, cols, _ = cloud.compact()
    return pts, cols


def window(s, seconds, spans):
    ends, frames = [], 0
    t0 = time.perf_counter()
    while True:
        scan = s.scans[len(ends) % len(s.scans)]
        pts, cols = sequence(s, scan, spans)
        ends.append(time.perf_counter())
        frames += len(scan[1])
        if ends[-1] - t0 >= seconds:
            break
    elapsed = ends[-1] - t0
    st = s.stitcher
    s.last = (scan, ref.Stitched(
        transforms=st.last_transforms.astype(np.float64), points=pts,
        colors=cols, overflow=int(st.last_overflow),
        steps=st.last_iterations.astype(np.int64)))
    seqs = len(ends)
    per_seq = np.diff([t0] + ends) * 1e3
    return {"metrics": {"fuse_fps": frames / elapsed},
            "attempted": frames, "failed": 0,
            "counts": {"sequences": seqs, "frames": frames,
                       "seconds": elapsed,
                       "sequence_ms_quartiles": np.percentile(
                           per_seq, [25, 50, 75]).tolist()}}


def release(s):
    """Keep the last sequence's pictures and results."""
    s.stitcher = None
    s.scans = None


def judge(s, out, control=False):
    """(checks, work). The reference stitches the same pictures after the
    window; in the control the reference in bfloat16 stands in for the
    program. The checks' limits come from the cell file."""
    cfg = s.config
    (colors, depths, poses), program = s.last
    reference = ref.stitch(colors, depths, poses, s.intr, cfg)
    if control:
        program = ref.stitch(colors, depths, poses, s.intr, cfg,
                             dtype=torch.bfloat16)
    mesh = ref.mesh_points(os.path.join(ROOT, cfg["object_mesh"]),
                           s.cell["chamfer_samples"], cfg["object_point"])
    readings = ref.readings(program, reference, mesh, cfg["voxel_size"],
                            s.device)
    limits = s.cell["limits"]
    checks = [{"name": k, "value": readings[k], "limit": limits[k]}
              for k in limits]
    return checks, {"readings": readings,
                    "program_points": int(len(program.points))}
