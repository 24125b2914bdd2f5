"""Flagship scan-plan-capture-reconstruct app — port of
``reconplan_tpu.apps.scan`` (reference ``main.py``).

Pipeline (reference ``main.py:18-254``):
  1. load (or build) the UR10 GRR roadmap;
  2. construct the 500-pose tilted look-at arc around the object
     (``main.py:68-136``) -> wtraj_input.txt;
  3. solve it sequentially with GRR threading curr_config
     (``grr_plan``, ``main.py:257-307``) -> ctraj.txt, trackarr.txt;
  4. FK the joint trajectory -> wtraj.txt (``main.py:153-165``);
  5. "execute": sample n_images camera poses evenly along the trajectory
     and render RGBD from the wrist D435 frame with the splat camera;
  6. reconstruct: TSDF fusion with the FK camera poses + marching cubes
     (fused_mesh.ply), its Poisson closure from the observation cloud and
     the GT-free gate that keeps the better of the two (closed_mesh.ply,
     best_mesh.ply), and/or ICP stitching seeded by the FK poses
     (stitched_cloud.ply); each scored by its Chamfer distance to the
     YCB ground truth.

Everything runs on one device (default: the card); the brick engine's
kernels fuse on the card, the dense engine on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from reconplan_tpu_torch.grr.paths import scan_arc
from reconplan_tpu_torch.io.frames import FrameSet
from reconplan_tpu_torch.io.meshio import load_mesh, save_ply
from reconplan_tpu_torch.io.render import SplatCamera
from reconplan_tpu_torch.kin.chain import fk_all
from reconplan_tpu_torch.recon.fusion import FusionPipeline
from reconplan_tpu_torch.recon.metrics import chamfer_to_mesh
from reconplan_tpu_torch.recon.stitcher import PinholeIntrinsic, RGBDStitcher
from reconplan_tpu_torch.utils.device import resolve_device

OBJECT_POINT = [0.75, 0.75, 0.0]  # main.py:45
BANANA_MESH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "objects", "011_banana", "poisson", "nontextured.ply",
)
# D435 intrinsics hardcoded at main.py:241-244
D435 = dict(fx=615.6707153320312, fy=615.962158203125,
            cx=326.0557861328125, cy=240.55592346191406)
# random restarts a waypoint of grr_plan's IK fallback (reach-boundary
# poses are seed-sensitive; one batched IK covers them all)
FALLBACK_RESTARTS = 16


def grr_plan(grr, workspace_path, track_array=None, batched=True,
             ik_fallback=True, stats=None):
    """GRR solve threading curr_config (``main.py:257-307``).

    ``batched=True`` runs the whole path through
    ``RedundancyResolution.solve_batch``; ``batched=False`` replays the
    reference's Python loop with TrackArray diagnostics.

    ``ik_fallback`` retries waypoints the roadmap solve could not reach
    with plain seeded IK (the reference solve() falls back to regular IK
    when the roadmap has nothing to offer): one IK batch of
    ``FALLBACK_RESTARTS`` random seeds a failed waypoint, the failed
    waypoints padded to a power of two (at least 8) as the JAX package
    pads them, so that both draw the same seeds.

    ``stats``, when given, is a dict whose counts ``waypoints``,
    ``carried`` (solved by the roadmap) and ``rescued`` (by the fallback)
    go up by this path's.
    """
    if track_array is None:
        track_array = []
    if batched:
        qs, ok, track = grr.solve_batch(
            np.asarray(workspace_path), return_track=True
        )
        ok = ok.tolist()
        config_path = [q if o else None for q, o in zip(qs, ok)]
        n_carried = sum(ok)
        # same tracking-mode diagnostic solve() appends (min joint distance
        # to the roadmap seed, resolution.py:322) so trackarr.txt stays
        # comparable to the reference's golden file.
        track_array.extend(float(t) for t in track)
        if ik_fallback and not all(ok):
            robot = grr.robot
            bad = [i for i, o in enumerate(ok) if not o]
            B = max(8, 1 << int(np.ceil(np.log2(len(bad)))))
            R = FALLBACK_RESTARTS
            pts = np.asarray(workspace_path)[
                np.pad(bad, (0, B - len(bad)), mode="edge")
            ]
            # local Generator: deterministic fallback seeds without
            # mutating the robot's shared RNG stream
            seeds = robot.sample(B * R, rng=np.random.default_rng(0))
            qf, okf = robot.solve_ik_batch(
                np.repeat(pts[:, :3], R, axis=0), seeds
            )
            qf = qf.cpu().numpy().reshape(B, R, -1)
            okf = okf.cpu().numpy().reshape(B, R)
            n_rescued = 0
            for j, i in enumerate(bad):
                hit = np.flatnonzero(okf[j])
                if len(hit):
                    config_path[i] = qf[j, hit[0]]
                    n_rescued += 1
            if n_rescued:
                print(f"ik fallback rescued {n_rescued}/{len(bad)} waypoints")
    else:
        config_path = []
        curr = None
        for waypoint in workspace_path:
            q = grr.solve(
                list(waypoint), curr_config=curr, none_on_fail=True,
                TrackArray=track_array,
            )
            config_path.append(q)
            if q is not None:
                curr = q
    n_bad = sum(1 for q in config_path if q is None)
    if stats is not None:
        n_solved = len(config_path) - n_bad
        if not batched:
            n_carried = n_solved
        for key, n in (("waypoints", len(config_path)),
                       ("carried", n_carried),
                       ("rescued", n_solved - n_carried)):
            stats[key] = stats.get(key, 0) + n
    if n_bad:
        print(f"\n{n_bad} invalid configurations found\n")
    return config_path


def make_arc_schedule(n_arcs, per_arc, base_az=3 * np.pi / 4, device=None):
    """The scan's viewpoint schedule (``main.py:68-136`` arc, widened).

    1 arc = the reference demo's single overhead arc. >1 arcs = the
    coverage schedule: alternating MID (r=0.25, h=0.10) and LOW grazing
    (r=0.22, h=0.035) arcs spread over 360 deg azimuth. The look-at
    quaternions are computed on ``device`` (default: the card).
    """
    if n_arcs <= 1:
        return [scan_arc(OBJECT_POINT, radius=0.3, height=0.15,
                         num_points=per_arc, device=device)]
    return [
        scan_arc(
            OBJECT_POINT,
            radius=0.25 if a % 2 == 0 else 0.22,
            height=0.10 if a % 2 == 0 else 0.035,
            num_points=per_arc,
            azimuth=base_az + a * 2 * np.pi / n_arcs,
            max_horiz=1.03,  # stay inside the UR10 look-at reach
            device=device,
        )
        for a in range(n_arcs)
    ]


def _numpy(a, dtype=None):
    """A numpy copy of an array or of a tensor on any device."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, dtype=dtype)


def build_observation_cloud(frames, max_points=80_000, seed=0, device=None):
    """Backproject every captured frame into one world-frame observation
    cloud (points + their camera centers), numpy. 80k samples keep the
    O(N^2) normal-estimation kNN tractable while staying in the ~0.4 mm
    Poisson class. The backprojection runs on the frames' device (numpy
    frames: ``device``, by default the card); the subsample is numpy's,
    seeded, so both packages pick the same points."""
    from reconplan_tpu_torch.ops.pointcloud import backproject_depth

    obs_pts, obs_cam = [], []
    for i in range(len(frames.depth)):
        cl = backproject_depth(
            frames.depth[i], D435["fx"], D435["fy"], D435["cx"], D435["cy"],
            depth_scale=frames.depth_scale or 1000.0, device=device,
        )
        p = _numpy(cl.points)[_numpy(cl.valid)]
        T = _numpy(frames.poses[i])
        obs_pts.append((p @ T[:3, :3].T + T[:3, 3]).astype(np.float32))
        obs_cam.append(np.broadcast_to(T[:3, 3].astype(np.float32), p.shape))
    obs = np.concatenate(obs_pts)
    cams = np.concatenate(obs_cam)
    if len(obs) > max_points:
        pick = np.random.default_rng(seed).choice(
            len(obs), max_points, replace=False)
        obs, cams = obs[pick], cams[pick]
    return obs, cams


def poisson_close_mesh(obs, cams, depth=192, device=None):
    """Screened-Poisson watertight closure from the observation cloud, on
    ``device`` (default: the card).

    Input = raw backprojected observations with camera-oriented
    covariance normals, not the MC mesh vertices: MC staircase normals at
    voxel scale are noisy enough to swell the solve. Returns (T, 3, 3)
    triangles as numpy.
    """
    from reconplan_tpu_torch.ops.pointcloud import estimate_normals, make_cloud
    from reconplan_tpu_torch.recon.poisson import poisson_reconstruct

    device = resolve_device(device)
    ncl = estimate_normals(make_cloud(obs, device=device), k=16)
    nrm = _numpy(ncl.normals).copy()
    # orient toward each point's OWN camera (estimate_normals orients
    # toward the origin, which is the robot base here)
    flip = np.sum(nrm * (cams - obs), axis=-1) < 0
    nrm[flip] = -nrm[flip]
    return _numpy(poisson_reconstruct(obs, nrm.astype(np.float32),
                                      depth=depth, device=device))


def free_space_refuted(samples, frames, margin=0.004, miss_is_free=True):
    """True where some camera verifiably saw THROUGH a world point (numpy).

    A point is refuted when it projects into a frame and its camera-space
    depth is shorter than the observed depth at that pixel by > ``margin``
    (the ray passed through it to reach a surface behind). With
    ``miss_is_free`` (valid for the sim splat camera, whose only scene
    content is the object — no floor/background), a no-return pixel also
    refutes: the ray hit nothing at all. Real sensors should pass
    ``miss_is_free=False`` (no-return pixels are unreliable there).
    """
    fx, fy, cx, cy = frames.intrinsics
    scale = frames.depth_scale or 1000.0
    samples = np.asarray(samples, np.float32)
    refuted = np.zeros(len(samples), bool)
    for i in range(len(frames.depth)):
        T = _numpy(frames.poses[i])
        pc = (samples - T[:3, 3]) @ T[:3, :3]  # world -> camera
        z = pc[:, 2]
        front = z > 1e-3
        zs = np.where(front, z, 1.0)
        u = np.round(fx * pc[:, 0] / zs + cx).astype(np.int64)
        v = np.round(fy * pc[:, 1] / zs + cy).astype(np.int64)
        depth = _numpy(frames.depth[i], np.float32)
        H, W = depth.shape
        ok = front & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        d = np.zeros(len(samples), np.float32)
        d[ok] = depth[v[ok], u[ok]] / scale
        seen_through = ok & (d > 0) & (z < d - margin)
        if miss_is_free:
            seen_through |= ok & (d <= 0)
        refuted |= seen_through
    return refuted


def close_gate_signals(open_tris, closed_tris, obs,
                       n_samples=15_000, hole_tau=0.006, seed=0,
                       frames=None, volume_bounds=None, margin=0.004,
                       miss_is_free=True, device=None):
    """GT-free evidence for choosing the open TSDF mesh vs its
    Poisson-closed variant (the ``close_mesh="auto"`` gate).

    The gate scores both meshes against the observation cloud, then
    splits the closed mesh's closure area (surface >hole_tau from any
    observation) by the capture's own free-space evidence:

      * fit_open / fit_closed — mean exact point-to-triangle distance
        observations -> mesh: how well each mesh tracks real data.
      * REFUTED closure — samples some camera verifiably saw through
        (``free_space_refuted``) or that fall outside the scan volume:
        hallucinated surface, charged to the CLOSED mesh at its distance
        from the observations (a lower bound on its error).
      * UNOBSERVED closure — the rest (e.g. the underside no above-floor
        camera can see): plausibly-true surface the open mesh is
        missing, charged to the OPEN mesh at the samples' distance to it.

    Without evidence (``frames``/``volume_bounds`` both None) every
    closure sample counts as unobserved. The samples are numpy draws
    from ``seed`` (the JAX package's draws); the distances run on
    ``device`` (default: the card). Returns a dict of floats and the
    decision ``best``.
    """
    from reconplan_tpu_torch.ops.nn import nearest_neighbor
    from reconplan_tpu_torch.recon.metrics import points_to_mesh_distance

    device = resolve_device(device)
    obs = _numpy(obs, np.float32)
    open_tris = _numpy(open_tris, np.float32)
    tri = _numpy(closed_tris, np.float32)

    def mesh_distance(points, tris):
        return points_to_mesh_distance(points, tris, device=device)

    rng = np.random.default_rng(seed)
    sub = obs[rng.choice(len(obs), min(n_samples, len(obs)),
                         replace=False)]
    fit_open = float(mesh_distance(sub, open_tris).mean())
    fit_closed = float(mesh_distance(sub, tri).mean())

    # area-weighted samples of the closed surface
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    p_tri = area / max(area.sum(), 1e-12)
    pick = rng.choice(len(tri), n_samples, p=p_tri)
    u, v = rng.uniform(size=(2, n_samples)).astype(np.float32)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    t = tri[pick]
    csamp = (t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0])
             + v[:, None] * (t[:, 2] - t[:, 0]))
    d_obs = _numpy(nearest_neighbor(
        torch.as_tensor(csamp, device=device),
        torch.as_tensor(obs, device=device))[0])
    in_hole = d_obs > hole_tau
    hole_frac = float(in_hole.mean())

    refuted = np.zeros(n_samples, bool)
    if frames is not None:
        refuted = free_space_refuted(
            csamp, frames, margin=margin, miss_is_free=miss_is_free)
    if volume_bounds is not None:
        lo, hi = (np.asarray(b, np.float32) for b in volume_bounds)
        refuted |= np.any((csamp < lo - margin) | (csamp > hi + margin),
                          axis=-1)
    refuted &= in_hole  # fit_* already prices the observed area
    unobs = in_hole & ~refuted

    refuted_frac = float(refuted.mean())
    unobs_frac = float(unobs.mean())
    hole_mean_open = (float(mesh_distance(csamp[unobs], open_tris).mean())
                      if unobs.any() else 0.0)
    refuted_mean = float(d_obs[refuted].mean()) if refuted.any() else 0.0
    proxy_open = fit_open + unobs_frac * hole_mean_open
    proxy_closed = fit_closed + refuted_frac * refuted_mean
    return {
        "fit_open_mm": fit_open * 1000,
        "fit_closed_mm": fit_closed * 1000,
        "hole_frac": hole_frac,
        "refuted_frac": refuted_frac,
        "unobserved_frac": unobs_frac,
        "hole_mean_open_mm": hole_mean_open * 1000,
        "refuted_mean_mm": refuted_mean * 1000,
        "proxy_open_mm": proxy_open * 1000,
        "proxy_closed_mm": proxy_closed * 1000,
        "best": "closed" if proxy_closed < proxy_open else "open",
    }


def run_scan(
    roadmap_dir=None,
    n_waypoints=500,
    n_images=12,
    out_dir="scan_output",
    reconstruct="fuse",  # "fuse" | "stitch" | "both"
    grid_dim=256,
    n_roadmap_nodes=500,
    n_arcs=1,
    rotation_type=None,
    engine=None,  # "brick" | "dense" | None = brick on the card, dense on CPU
    close_mesh="auto",  # "auto" | True | False — Poisson closing pass
    close_depth=192,  # Poisson grid resolution for the closing pass
    verbose=True,
    device=None,
):
    """Closed-loop scan-plan-capture-reconstruct (``main.py`` parity) on
    ``device`` (default: the card).

    ``n_arcs`` > 1 plans additional scan arcs at rotated azimuths;
    waypoints and captures split evenly across arcs. Returns the result
    dict of the JAX package's ``run_scan``: ``fuse_chamfer_mm`` (+
    ``_ab_`` / ``_ba_``) for the fuse route; ``closed_chamfer_mm`` (+
    ``_ab_`` / ``_ba_``) for the close route, with ``close_gate`` (the
    signals of :func:`close_gate_signals`) when ``close_mesh="auto"``
    scored an open mesh against its closure; ``best_mesh`` and
    ``best_chamfer_mm``; ``stitch_chamfer_mm`` for the stitch route; and
    ``stage_timings``. Also ``device``, the device it ran on, and
    ``plan``, the counts of :func:`grr_plan`'s ``stats`` over all arcs.
    """
    if reconstruct not in ("fuse", "stitch", "both"):
        raise ValueError(f"unknown reconstruct={reconstruct!r}")
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    from reconplan_tpu_torch.grr import RedundancyResolution
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin.robot import make_robot
    from reconplan_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()

    if rotation_type is None:
        # infer the GRR problem from the roadmap path so shipped variants
        # (rot_free scan arc, rot_fixed, rot_variable_yaw) all work
        rotation_type = "rot_free"
        for rt in ("rot_variable_yaw", "rot_fixed"):
            if roadmap_dir and rt in str(roadmap_dir):
                rotation_type = rt
    opts = load_problem("ur10", rotation_type)
    robot = make_robot(opts, device=device)
    grr = RedundancyResolution(robot, device)
    if roadmap_dir and os.path.exists(os.path.join(roadmap_dir, "resolution.npz")):
        grr.load_resolution_graph(os.path.join(roadmap_dir, "resolution.npz"))
        grr.load_workspace_graph(os.path.join(roadmap_dir, "workspace.npz"))
    else:
        if verbose:
            print("No roadmap found - building one")
        from reconplan_tpu_torch.apps.redundancy import build_roadmap

        grr, _ = build_roadmap(
            "ur10", "rot_free", n_pos_points=n_roadmap_nodes,
            sampling_method="random", out_dir=roadmap_dir, verbose=verbose,
            device=device,
        )

    # ---- arc construction (main.py:68-136) ----
    per_arc = max(n_waypoints // max(n_arcs, 1), 2)
    arcs = make_arc_schedule(n_arcs, per_arc, device=device)
    arc = np.concatenate(arcs, axis=0)
    with open(os.path.join(out_dir, "wtraj_input.txt"), "w") as f:
        for p in arc:
            f.write(",".join(map(str, [list(p[:3]), list(p[3:7])])) + "\n")

    # ---- GRR plan (main.py:142-151) ----
    track = []
    t0 = time.time()
    config_path = []
    plan_stats = {}
    with timer.stage("plan", fence=device):
        for a in arcs:
            config_path.extend(grr_plan(grr, a, track, stats=plan_stats))
    if verbose:
        ok = sum(1 for q in config_path if q is not None)
        print(f"grr_plan: {ok}/{len(arc)} waypoints solved in {time.time()-t0:.1f}s")
    maneuver_time = 10.0  # main.py:145
    times = np.linspace(0, maneuver_time, len(config_path))
    with open(os.path.join(out_dir, "ctraj.txt"), "w") as f:
        for t, q in zip(times, config_path):
            f.write(f"{t},{np.array2string(np.asarray(q), separator=' ') if q is not None else None}\n")
    with open(os.path.join(out_dir, "trackarr.txt"), "w") as f:
        for entry in track:
            f.write(f"{entry}\n")

    # ---- FK workspace trajectory (main.py:153-165) ----
    valid = [q for q in config_path if q is not None]
    if not valid:
        raise RuntimeError("no valid configurations solved")
    qs = robot._tensor(np.asarray(valid, dtype=np.float32))
    ee = robot.fk_point_batch(qs).cpu().numpy()
    with open(os.path.join(out_dir, "wtraj.txt"), "w") as f:
        for t, p in zip(times, ee):
            f.write(f"{t},[array({list(p[:3])}), array({list(p[3:7])})]\n")

    # ---- capture (main.py:213-234; bullet_camera.py) ----
    cam = SplatCamera(**D435, device=device)
    cam.add_mesh_file(BANANA_MESH, translate=OBJECT_POINT)
    # camera positions: one batched FK of the d435 color frame along the
    # trajectory
    _, t_links = fk_all(robot.model, robot._full_config(qs))
    cam_positions = t_links[:, robot.camera_link].cpu().numpy()
    pick = np.linspace(0, len(qs) - 1, n_images).astype(int)
    depths, colors, poses = [], [], []
    with timer.stage("capture", fence=device):
        for i in pick:
            d, c, T = cam.take_picture(cam_positions[i], OBJECT_POINT)
            depths.append(d)
            colors.append(c)
            poses.append(T)
    frames = FrameSet(
        depth=torch.stack(depths),
        color=torch.stack(colors),
        poses=np.stack(poses).astype(np.float32),
        depth_scale=1000.0,
        intrinsics=(D435["fx"], D435["fy"], D435["cx"], D435["cy"]),
    )
    if verbose:
        cover = (frames.depth > 0).float().mean(dim=(1, 2))
        print(f"captured {n_images} frames, mean coverage "
              f"{cover.mean().item():.3%}")

    # ---- reconstruction ----
    results = {"device": str(device), "plan": plan_stats}
    gt_v, gt_f = load_mesh(BANANA_MESH)
    gt_v = gt_v + np.asarray(OBJECT_POINT)

    if reconstruct in ("fuse", "both"):
        t0 = time.time()
        if engine is None:
            # the brick engine's kernels need the card; the dense engine
            # is the CPU path
            engine = "brick" if device.type == "cuda" else "dense"
        pipe = FusionPipeline(
            dims=(grid_dim,) * 3,
            origin=(OBJECT_POINT[0] - 0.15, OBJECT_POINT[1] - 0.15, -0.05),
            voxel_size=0.3 / (grid_dim - 1),
            with_color=True,
            engine=engine,
            device=device,
        )
        with timer.stage("fuse", fence=device):
            pipe.integrate(frames)
            mesh, mesh_colors = pipe.extract_mesh(with_colors=True)
        if verbose:
            print(f"TSDF fusion + MC: {time.time()-t0:.1f}s, {len(mesh)} "
                  "triangles")
        save_ply(
            os.path.join(out_dir, "fused_mesh.ply"),
            triangles=mesh,
            colors=mesh_colors.reshape(-1, 3) if len(mesh) else None,
        )
        if len(mesh):
            ch, ab, ba = chamfer_to_mesh(mesh.reshape(-1, 3), gt_v, gt_f)
            results["fuse_chamfer_mm"] = ch * 1000
            results["fuse_chamfer_ab_mm"] = ab * 1000
            results["fuse_chamfer_ba_mm"] = ba * 1000
            if verbose:
                print(
                    f"fused mesh Chamfer vs GT: {ch*1000:.3f} mm "
                    f"(mesh->gt {ab*1000:.3f}, gt->mesh {ba*1000:.3f})"
                )
    if close_mesh:
        # Poisson-closed watertight mesh: the TSDF marching-cubes mesh
        # only emits surface where voxels were observed, so the object's
        # underside — unobservable from any above-floor camera — is an
        # open hole that gt->mesh Chamfer pays several mm for. The
        # Poisson closure extrapolates a smooth surface there; at dense
        # capture it instead fights real observations, so the default
        # close_mesh="auto" scores both meshes against the observation
        # cloud (close_gate_signals — GT-free) and keeps the winner;
        # True forces the closure.
        t0 = time.time()
        obs, cams = build_observation_cloud(frames, device=device)
        with timer.stage("poisson_close", fence=device):
            closed = poisson_close_mesh(obs, cams, depth=close_depth,
                                        device=device)
        save_ply(os.path.join(out_dir, "closed_mesh.ply"), triangles=closed)
        ch, ab, ba = chamfer_to_mesh(closed.reshape(-1, 3), gt_v, gt_f,
                                     device=device)
        results["closed_chamfer_mm"] = ch * 1000
        results["closed_chamfer_ab_mm"] = ab * 1000
        results["closed_chamfer_ba_mm"] = ba * 1000
        if verbose:
            print(
                f"Poisson-closed mesh ({time.time()-t0:.1f}s, "
                f"{len(closed)} triangles, {len(obs)} obs points) "
                f"Chamfer vs GT: {ch*1000:.3f} mm "
                f"(mesh->gt {ab*1000:.3f}, gt->mesh {ba*1000:.3f})"
            )
        open_mesh = results.get("fuse_chamfer_mm") is not None and len(mesh)
        if close_mesh == "auto" and open_mesh:
            with timer.stage("close_gate", fence=device):
                vol_lo = np.asarray(pipe.origin, np.float32)
                vol_hi = vol_lo + (np.asarray(pipe.dims) - 1) * pipe.voxel_size
                gate = close_gate_signals(
                    mesh, closed, obs, frames=frames,
                    volume_bounds=(vol_lo, vol_hi), device=device,
                )
            results["close_gate"] = gate
            best_tris = closed if gate["best"] == "closed" else mesh
            best_key = ("closed_chamfer_mm" if gate["best"] == "closed"
                        else "fuse_chamfer_mm")
            results["best_mesh"] = gate["best"]
            results["best_chamfer_mm"] = results[best_key]
            save_ply(os.path.join(out_dir, "best_mesh.ply"),
                     triangles=best_tris)
            if verbose:
                print(
                    f"auto close gate: kept {gate['best']} mesh "
                    f"(proxy open {gate['proxy_open_mm']:.3f} mm vs "
                    f"closed {gate['proxy_closed_mm']:.3f} mm; "
                    f"hole {gate['hole_frac']:.3%} = "
                    f"refuted {gate['refuted_frac']:.3%} + "
                    f"unobserved {gate['unobserved_frac']:.3%})"
                )
        elif close_mesh == "auto":
            results["best_mesh"] = "closed"
            results["best_chamfer_mm"] = results["closed_chamfer_mm"]
    elif results.get("fuse_chamfer_mm") is not None:
        results["best_mesh"] = "open"
        results["best_chamfer_mm"] = results["fuse_chamfer_mm"]

    if reconstruct in ("stitch", "both"):
        t0 = time.time()
        stitcher = RGBDStitcher(PinholeIntrinsic(640, 480, **D435),
                                device=device)
        # the reference's 2 cm default voxel targets room-scale scenes;
        # a 20 cm tabletop object needs scene-scale resolution (the model
        # cloud otherwise collapses to ~80 voxel centroids, ~4 mm Chamfer)
        stitcher.voxel_size = 0.004
        stitcher.distance_threshold = 0.02
        # capacity sized to the object (~2-4k occupied 4 mm voxels): every
        # kNN / ICP-correspondence stage is O(cap^2), so the 32k default
        # would spend 95% of its work on empty slots
        stitcher.model_capacity = 8192
        with timer.stage("stitch", fence=device):
            cloud = stitcher.stitch_sequence(
                list(frames.color), list(frames.depth), poses=frames.poses
            )
        pts, cols, _ = cloud.compact()
        if verbose:
            print(f"ICP stitch: {time.time()-t0:.1f}s, {len(pts)} points")
        save_ply(os.path.join(out_dir, "stitched_cloud.ply"), vertices=pts,
                 colors=cols if len(cols) else None)
        if len(pts):
            ch, ab, ba = chamfer_to_mesh(pts, gt_v, gt_f, device=device)
            results["stitch_chamfer_mm"] = ch * 1000
            if verbose:
                print(f"stitched cloud Chamfer vs GT: {ch*1000:.3f} mm")

    results["stage_timings"] = timer.as_dict()
    if verbose:
        print(timer.report())
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--roadmap", default="graph/ur10/rot_free")
    ap.add_argument("--waypoints", type=int, default=500)
    ap.add_argument("--images", type=int, default=12)
    ap.add_argument("--out", default="scan_output")
    ap.add_argument("--reconstruct", default="both",
                    choices=["fuse", "stitch", "both"])
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--arcs", type=int, default=1,
                    help="scan arcs at rotated azimuths (1 = reference demo)")
    ap.add_argument("--rotation-type", default=None,
                    help="GRR problem variant (default: infer from roadmap)")
    ap.add_argument("--engine", default=None, choices=["brick", "dense"],
                    help="TSDF engine (default: brick on the card, dense on "
                    "the CPU)")
    ap.add_argument("--close-mode", default="auto",
                    choices=["auto", "always", "never"],
                    help="Poisson closing pass: auto (default) scores the "
                    "open TSDF mesh vs its closure against the observation "
                    "cloud and keeps the winner; always/never force it")
    ap.add_argument("--no-close", action="store_true",
                    help="alias for --close-mode never")
    ap.add_argument("--close-depth", type=int, default=192,
                    help="Poisson grid resolution of the closing pass")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace to DIR")
    args = ap.parse_args(argv)
    from reconplan_tpu_torch.utils.profiling import maybe_trace

    with maybe_trace(args.profile):
        return run_scan(
            roadmap_dir=args.roadmap,
            n_waypoints=args.waypoints,
            n_images=args.images,
            out_dir=args.out,
            reconstruct=args.reconstruct,
            grid_dim=args.grid,
            n_arcs=args.arcs,
            rotation_type=args.rotation_type,
            engine=args.engine,
            close_mesh=(False if (args.no_close or args.close_mode == "never")
                        else True if args.close_mode == "always" else "auto"),
            close_depth=args.close_depth,
            device=args.device,
        )


if __name__ == "__main__":
    main()
