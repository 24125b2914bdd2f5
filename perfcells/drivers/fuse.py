"""Fusion cells: a recorded scan's depth frames fused into a fresh brick
grid by ``ops/tsdf_brick.integrate_frames_bricked_device`` (K2, the mask
pipeline and K1; the call under ``FusionPipeline(engine="brick")``), scan
after scan, with the configuration's ``max_active``.

``FusionPipeline.integrate`` itself is not the entry: it passes no
``max_active``, and its fixed 8,192 bricks a chunk drop bricks of this
scan (PERF.md, Open questions).

Set-up renders the scan's frames through the frozen renderer (the arc
schedule's base azimuth drawn from the seed) and fuses them once, which
builds the kernels. The window repeats whole scans: a new grid, the
frames integrated, the card synchronised. ``fuse_fps`` is every frame
fused over the window's whole time. The judge holds the last scan's grid
against the plain reference (``reference/tsdf.py``), which also counts the
scan's work for the roofline.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfcells import peaks
from perfcells.common import ROOT, no_span, sync
from perfcells.reference import tsdf as ref
from perfcells.traffic import arcs, render
from reconplan_tpu_torch.ops import tsdf_brick as tb


def geometry(config):
    """The grid the configuration fixes."""
    n = config["grid_dim"]
    voxel = config["grid_side_m"] / (n - 1)
    origin = tuple(float(o + d) for o, d in zip(
        config["object_point"], config["grid_origin_offset"]))
    return {"dims": (n, n, n), "origin": origin, "voxel": voxel,
            "trunc": config["trunc_voxels"] * voxel,
            "depth_scale": config["depth_scale"],
            "depth_max": config["depth_max"],
            "max_weight": config["max_weight"],
            "max_active": config["max_active"]}


def render_scan(cell, config, seed, device):
    """(depths (F, H, W) mm on ``device``, poses (F, 4, 4) f32 c2w,
    intrinsics) of the scan the seed gives."""
    az = arcs.seeded_azimuth(seed, cell["azimuth_turn"])
    eyes = np.concatenate(arcs.make_arc_schedule(
        cell["arcs"], cell["per_arc"], az))[:, :3]
    obj = config["object_point"]
    cam = render.SplatCamera(**config["camera"], device=device)
    cam.add_mesh_file(os.path.join(ROOT, config["object_mesh"]),
                      translate=obj)
    depths, poses = [], []
    for eye in eyes:
        d, _, T = cam.take_picture(eye, obj)
        depths.append(d)
        poses.append(T)
    return torch.stack(depths), np.stack(poses).astype(np.float32), \
        cam.intrinsics


def setup(cell, config, seed, device):
    depths, poses, intr = render_scan(cell, config, seed, device)
    g = geometry(config)
    s = SimpleNamespace(
        cell=cell, device=device, geometry=g, intr=intr, depths=depths,
        poses=poses, planes=None,
    )
    s.planes = scan(s)  # builds the kernels, warms every shape
    return s


def scan(s, spans=None):
    """One scan: a fresh grid, every frame integrated, the card
    synchronised. Returns the grid."""
    g = s.geometry
    span = spans or no_span
    with span("fuse.new_grid"):
        grid = tb.make_brick_grid(g["dims"], g["origin"], g["voxel"],
                                  g["trunc"], device=s.device)
        sync(s.device)
    with span("fuse.integrate"):
        grid, _ = tb.integrate_frames_bricked_device(
            grid, s.depths, s.poses, *s.intr, depth_scale=g["depth_scale"],
            depth_max=g["depth_max"], max_weight=g["max_weight"],
            max_active=g["max_active"])
        sync(s.device)
    return grid


def window(s, seconds, spans):
    s.planes = None
    n_frames = s.depths.shape[0]
    ends = []
    t0 = time.perf_counter()
    while True:
        grid = scan(s, spans)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    elapsed = ends[-1] - t0
    s.planes = grid
    scans = len(ends)
    per_scan = np.diff([t0] + ends) * 1e3
    return {"metrics": {"fuse_fps": scans * n_frames / elapsed},
            "attempted": scans * n_frames, "failed": 0,
            "counts": {"scans": scans, "frames": scans * n_frames,
                       "seconds": elapsed,
                       "scan_ms_quartiles": np.percentile(
                           per_scan, [25, 50, 75]).tolist()}}


def release(s):
    """Keep only the last grid's sdf and weight planes."""
    s.planes = (s.planes.sdf, s.planes.weight, s.planes.dims)


def program_slab(planes):
    """``(z0, Z) -> (weight, sdf)`` dense slabs of the program's brick
    planes: row ``(bz * bh + by) * bw + bx``, sublane local z, lane local
    ``y * 16 + x`` (the layout ``ops/tsdf_brick.BrickGrid`` documents)."""
    sdf_b, weight_b, (D, H, W) = planes
    bz, by, bx = ref.BRICK
    bh, bw = H // by, W // bx

    def slab(z0, Z):
        rows = slice(z0 // bz * bh * bw, (z0 + Z) // bz * bh * bw)

        def dense(a):
            a = a[rows].reshape(Z // bz, bh, bw, bz, by, bx)
            return a.permute(0, 3, 1, 4, 2, 5).reshape(Z, H, W)

        return dense(weight_b), dense(sdf_b)

    return slab


def judge(s, out, control=False):
    """(checks, work). The checks' limits come from the cell file."""
    g = s.geometry
    if control:
        j = ref.fuse_and_judge(s.depths, s.poses, s.intr, g, None,
                               dtype=torch.bfloat16,
                               control_slab=ref.control_grid)
    else:
        j = ref.fuse_and_judge(s.depths, s.poses, s.intr, g,
                               program_slab(s.planes))
    bad_w, bad_s = j.shares()
    readings = {"bad_weight_share": bad_w, "bad_sdf_share": bad_s}
    limits = s.cell["limits"]
    checks = [{"name": k, "value": readings[k], "limit": limits[k]}
              for k in limits]
    F, H, W = s.depths.shape
    nbytes = j.bricks * 2 * 4096 * 2 + F * H * W * 4 + F * 64
    nops = j.brick_frames * 1024 * peaks.TSDF_VOXEL_FRAME_OPS
    b, by = peaks.bound_s(nbytes, nops)
    work = {"bound_s": b, "bound_by": by, "bricks": j.bricks,
            "brick_frames": j.brick_frames, "touched": j.touched,
            "compared": j.compared, "readings": readings}
    return checks, work
