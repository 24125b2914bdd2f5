"""Multi-frame RGBD stitching — port of ``reconplan_tpu.recon.stitcher``.

Public surface of the reference's ``stitcher.py:9-258``
(``RGBDStitcher`` with ``create_point_cloud_from_rgbd``,
``preprocess_point_cloud``, ``register_point_clouds``, ``stitch_sequence``,
``visualize_registration``, ``load_default``, ``load_dataset_two_folders``,
``load_dataset_realsense``) with the JAX package's defaults (voxel 0.02 m,
distance threshold 0.05 m, multi-scale point-to-plane + colored-ICP
registration, every-2-frames outlier removal 20/2.0), its fixed-capacity
model buffer and its pose-free rescue.

The JAX package runs the frame loop as a ``lax.scan`` and each decision
as a ``lax.cond``. Here the frames go through a host loop, and each
decision (rescue a frame, integrate it, scrub outliers) is a host branch
on one scalar read from the device, so only the arm taken runs. The
model's compaction (``jnp.nonzero(size=cap, fill_value=0)``) is a
fixed-capacity gather with no host read, and the overflow stays a device
counter read once at the end of the sequence. The reads here go through
``utils/profiling.to_host``, so ``host.reads`` counts them.

Spans and counters (``utils/profiling``): ``stitch.sequence`` holds a
``stitch.prepare`` and a ``stitch.append`` for the first frame, then one
``stitch.frame`` for each later frame (counter ``stitch.frames``), which
holds ``stitch.prepare`` (back-projection, downsample, slot gather),
``stitch.register`` (its ``stitch.normals`` around the normals and color
gradients, and the solves' ``icp.*`` spans), ``stitch.gate``,
``stitch.append`` and, every ``optimization_modulus`` frames,
``stitch.outliers``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from reconplan_tpu_torch.io.frames import load_rgbd_folder
from reconplan_tpu_torch.ops.features import _ransac_core, fpfh
from reconplan_tpu_torch.ops.icp import (
    _matmul4,
    _transform,
    color_gradients,
    colored_icp,
    icp_point_to_plane,
)
from reconplan_tpu_torch.ops.nn import nearest_neighbor
from reconplan_tpu_torch.ops.pointcloud import (
    PointCloud,
    backproject_depth,
    estimate_normals,
    make_cloud,
    remove_statistical_outliers,
    voxel_downsample,
)
from reconplan_tpu_torch.utils.device import resolve_device
from reconplan_tpu_torch.utils.profiling import count, span, spanned, to_host

# the seed of the pose-free rescue's draws; frame i draws from a
# generator seeded with (RESCUE_SEED << 32) + i
RESCUE_SEED = 17


class PinholeIntrinsic:
    """Minimal stand-in for o3d.camera.PinholeCameraIntrinsic."""

    def __init__(self, width, height, fx, fy, cx, cy):
        self.width, self.height = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy


def _gather_slots(valid, cap):
    """``jnp.nonzero(valid, size=cap, fill_value=0)`` with no host read:
    the indices of the first ``cap`` valid slots in order, then index 0
    in every slot left. Also returns the valid count (0-d)."""
    n = valid.shape[0]
    rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    dest = torch.where(valid & (rank < cap), rank, cap)
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=valid.device)
    idx.scatter_(0, dest, torch.arange(n, device=valid.device))
    return idx[:cap], valid.sum()


def _take(cloud, idx, count, cap):
    """The cloud's slots ``idx`` as a cloud of ``cap`` slots, the first
    ``count`` valid."""
    return PointCloud(
        cloud.points[idx],
        torch.arange(cap, device=idx.device) < count,
        cloud.colors[idx] if cloud.has_colors else cloud.colors,
        cloud.normals[idx] if cloud.has_normals else cloud.normals,
    )


def _inverse_rigid(T):
    """Inverse of a rigid (4, 4): [R^T, -R^T t]."""
    Rt = T[:3, :3].T
    inv = torch.eye(4, dtype=T.dtype, device=T.device)
    inv[:3, :3] = Rt
    inv[:3, 3] = -(Rt * T[:3, 3]).sum(dim=-1)
    return inv


class RGBDStitcher:
    def __init__(self, intrinsic: PinholeIntrinsic, device=None):
        self.intrinsic = intrinsic
        self.device = resolve_device(device)
        self.voxel_size = 0.02  # stitcher.py:17
        self.distance_threshold = 0.05  # stitcher.py:18
        self.optimization_modulus = 2  # stitcher.py:19
        self.model_capacity = 1 << 15  # fixed device buffer for the model
        # (0.02 m voxels over a tabletop scene occupy ~5-20k slots)
        # trust region for pose-seeded registration (see stitch_sequence)
        self.pose_trust_trans = 0.01  # meters
        self.pose_trust_rot = 0.05  # radians
        # pose-free: tight-threshold score below this triggers the
        # FPFH+RANSAC global re-initialization (a well-locked frame puts
        # most of its points within 1.5 voxels of the model)
        self.global_rescue_score = 0.6
        # pose-free: frames whose best registration (chained OR rescued)
        # scores below this are NOT integrated and do NOT advance the
        # odometry chain — one unlocked frame written into the model
        # poisons every later registration against it
        self.integrate_score_floor = 0.55
        # independent RANSAC draws per rescue: a single unlucky draw can
        # land a spurious plane-on-plane optimum; the best post-refine
        # tight score across tries picks the real lock
        self.global_rescue_tries = 3
        # voxels the last stitch_sequence dropped past the model or frame
        # buffer (0: nothing was dropped); None before the first
        self.last_overflow = None

    # ------------------------------------------------------------------
    def create_point_cloud_from_rgbd(self, color_img, depth_img) -> PointCloud:
        """RGBD -> camera-frame cloud (``stitcher.py:21-48`` semantics:
        depth_scale 1000, trunc 3 m), on the stitcher's device."""
        dev = self.device
        return backproject_depth(
            torch.as_tensor(depth_img, device=dev),
            self.intrinsic.fx,
            self.intrinsic.fy,
            self.intrinsic.cx,
            self.intrinsic.cy,
            color=(torch.as_tensor(color_img, device=dev)
                   if color_img is not None else None),
            depth_scale=1000.0,
            depth_trunc=3.0,
        )

    def preprocess_point_cloud(self, pcd: PointCloud) -> PointCloud:
        """Downsample + estimate normals (``stitcher.py:50-71``; the FPFH
        the reference computed there was never consumed — see
        ops.features for the standalone FPFH op)."""
        down = voxel_downsample(pcd, self.voxel_size)
        return estimate_normals(down, k=30)

    def _register_j(self, source: PointCloud, target: PointCloud, T):
        """Multi-scale registration on the device.

        Coarse point-to-plane at 2x voxel / 2x distance pulls in from a
        rough initialization, then colored-ICP (when colors exist) locks
        the tangential directions, then fine point-to-plane converges the
        geometry. Returns (T (4, 4), fitness) tensors.
        """
        return self._register_stages(source, target, T)[:2]

    def _register_stages(self, source: PointCloud, target: PointCloud, T):
        """:meth:`_register_j`, with the live steps of its three stages
        (coarse, colored, fine; colored 0 without colors): (T, fitness,
        steps (3,) int32) tensors."""
        with span("stitch.normals"):
            src_c = estimate_normals(
                voxel_downsample(source, 2.0 * self.voxel_size), k=30)
            tgt_c = estimate_normals(
                voxel_downsample(target, 2.0 * self.voxel_size), k=30)
        coarse = icp_point_to_plane(
            src_c, tgt_c, 2.0 * self.distance_threshold, init=T,
            max_iteration=25,
        )
        T = coarse.transformation
        steps = [coarse.iterations, torch.zeros_like(coarse.iterations)]
        colored = source.has_colors and target.has_colors
        with span("stitch.normals"):
            src = self.preprocess_point_cloud(source)
            tgt = self.preprocess_point_cloud(target)
            grads = color_gradients(tgt) if colored else None
        if colored:
            res = colored_icp(
                src, tgt, grads, self.distance_threshold, init=T,
                max_iteration=35,
            )
            T, steps[1] = res.transformation, res.iterations
        res = icp_point_to_plane(
            src, tgt, self.distance_threshold, init=T, max_iteration=30)
        steps.append(res.iterations)
        return (res.transformation, res.fitness,
                torch.stack([n.to(torch.int32) for n in steps]))

    def _tight_score_j(self, cloud: PointCloud, model: PointCloud, T):
        """Fraction of cloud points within 1.5 voxels of the model after
        T — a registration-quality score that, unlike ICP fitness at the
        loose ``distance_threshold``, collapses for wrong-but-overlapping
        poses (smooth objects let ICP lock confidently onto the wrong
        side)."""
        moved = _transform(T, cloud.points)
        d, idx = nearest_neighbor(moved, model.points, valid=model.valid)
        close = (d < 1.5 * self.voxel_size) & cloud.valid
        if cloud.has_colors and model.has_colors:
            # geometry alone cannot reject a symmetric wrong pose (a
            # plane aligns with its own 180-degree flip); color must
            # agree too
            cdist = torch.linalg.norm(cloud.colors - model.colors[idx],
                                      dim=-1)
            close = close & (cdist < 0.25)
        return close.sum() / torch.clamp(cloud.valid.sum(), min=1)

    def _global_init_j(self, source: PointCloud, target: PointCloud,
                       generator=None):
        """FPFH + RANSAC global initialization (no prior pose), drawing
        its hypotheses from ``generator`` (default: one seeded with 0).

        The reference computed FPFH but never used it; its pose-free
        route chains colored-ICP from identity, which only works for
        video-dense captures. This supplies the missing global stage so a
        pose-free stitch survives large viewpoint jumps.
        """
        src = estimate_normals(
            voxel_downsample(source, 2.0 * self.voxel_size), k=30)
        tgt = estimate_normals(
            voxel_downsample(target, 2.0 * self.voxel_size), k=30)
        fs = fpfh(src, k=32)
        ft = fpfh(tgt, k=32)
        _, fwd = nearest_neighbor(fs, ft, valid=tgt.valid)
        _, bwd = nearest_neighbor(ft, fs, valid=src.valid)
        mutual = torch.arange(src.points.shape[0],
                              device=fwd.device) == bwd[fwd]
        corr_valid = src.valid & mutual & tgt.valid[fwd]
        both_col = src.has_colors and tgt.has_colors
        if generator is None:
            generator = torch.Generator(device=fwd.device).manual_seed(0)
        T, _score = _ransac_core(
            src.points, tgt.points, fwd, corr_valid, generator,
            inlier_threshold=3.0 * self.voxel_size,
            n_hypotheses=1024,
            src_cols=src.colors if both_col else None,
            dst_cols=tgt.colors if both_col else None,
        )
        return T

    def register_point_clouds(self, source: PointCloud, target: PointCloud,
                              initial_transform=None):
        """Multi-scale point-to-plane (+colored-ICP) registration
        (``stitcher.py:73-112`` surface). Returns (T (4,4) np, fitness)."""
        dev = source.points.device
        T = (torch.eye(4, device=dev) if initial_transform is None
             else torch.as_tensor(initial_transform, dtype=torch.float32,
                                  device=dev))
        T, fit = self._register_j(source, target, T)
        return to_host(T).numpy(), float(to_host(fit))

    # ------------------------------------------------------------------
    def _model_append(self, model: PointCloud, cloud: PointCloud, T,
                      overflow=None):
        """Transform ``cloud`` by T and merge into the model buffer.

        The model keeps a fixed capacity: both clouds concatenate and a
        voxel downsample immediately compacts back under capacity.
        Returns (model', overflow') where overflow' tracks, on the device,
        how far voxel occupancy exceeded capacity: the compaction drops
        voxels past the cap, so the overflow is surfaced once per
        sequence instead.
        """
        dev = model.points.device
        if overflow is None:
            overflow = torch.zeros((), dtype=torch.int64, device=dev)
        T = torch.as_tensor(T, dtype=torch.float32, device=dev)
        pts = _transform(T, cloud.points)
        new_pts = torch.cat([model.points, pts])
        new_valid = torch.cat([model.valid, cloud.valid])
        new_col = None
        if model.has_colors and cloud.has_colors:
            new_col = torch.cat([model.colors, cloud.colors])
        merged = make_cloud(new_pts, colors=new_col, valid=new_valid)
        # compact under capacity: voxel-average (the reference downsamples
        # every optimization_modulus frames anyway, stitcher.py:151), then
        # gather the valid slots to the front (they are scattered at voxel
        # segment starts after the sort-based downsample)
        merged = voxel_downsample(merged, self.voxel_size)
        cap = self.model_capacity
        idx, count = _gather_slots(merged.valid, cap)
        overflow = torch.maximum(overflow, count - cap)
        return _take(merged, idx, count, cap), overflow

    def _frame_generator(self, i):
        """The rescue's generator of frame ``i``."""
        return torch.Generator(device=self.device).manual_seed(
            (RESCUE_SEED << 32) + i)

    def _rescue(self, current, model, T0, fit0, s0, i):
        """Pose-free re-initialization of frame ``i``: the best of
        ``global_rescue_tries`` RANSAC + registration solves by tight
        score, taken over the chained (T0, fit0, s0) only when it beats
        it by 15% (near-symmetric objects make feature matching
        ambiguous, and the chained seed carries a motion prior)."""
        gen = self._frame_generator(i)
        Tb, fitb = T0, fit0
        sb = torch.zeros((), device=self.device)
        for _ in range(self.global_rescue_tries):
            Tg = self._global_init_j(current, model, generator=gen)
            Tr, fitr = self._register_j(current, model, Tg)
            sr = self._tight_score_j(current, model, Tr)
            take = sr > sb
            Tb = torch.where(take, Tr, Tb)
            fitb = torch.where(take, fitr, fitb)
            sb = torch.maximum(sr, sb)
        better = sb > s0 * 1.15
        return (torch.where(better, Tb, T0), torch.where(better, fitb, fit0),
                torch.where(better, sb, s0))

    @spanned("stitch.sequence")
    def stitch_sequence(self, color_images, depth_images, poses=None) -> PointCloud:
        """Incremental frame-to-model stitching (``stitcher.py:114-166``):
        register frame i to the merged model, transform + append + voxel
        compaction, and every ``optimization_modulus`` frames statistical
        outlier removal.

        ``poses`` (optional (F, 4, 4) cam->world) seeds each registration —
        pass robot-FK camera poses for the scan-plan-capture loop. Without
        poses, each frame is seeded by constant velocity, rescued by
        FPFH + RANSAC when its tight score collapses, and dropped when
        neither locks.

        Sets ``last_fits`` (F-1,), ``last_transforms`` (F-1, 4, 4),
        ``last_scores`` (F-1, 2: chained and accepted tight score) and
        ``last_iterations`` (F-1, 3: the live steps of the coarse,
        colored and fine stage of each frame's registration from its
        seed) as numpy, and ``last_overflow``, the most voxels a buffer
        could not hold (0 when none was dropped).
        """
        if len(color_images) != len(depth_images):
            raise ValueError("Number of color and depth images must match")
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)

        with span("stitch.prepare"):
            first = self.create_point_cloud_from_rgbd(color_images[0],
                                                      depth_images[0])
        # seed the fixed-capacity model buffer by merging the first frame
        # into an empty buffer through the same voxel-compaction path
        cap = self.model_capacity
        has_col = first.has_colors
        empty = torch.zeros((0, 3), **f32)
        combined = PointCloud(
            torch.zeros((cap, 3), **f32),
            torch.zeros(cap, dtype=torch.bool, device=dev),
            torch.zeros((cap, 3), **f32) if has_col else empty,
            empty,
        )
        use_pose = poses is not None
        pose_seq = (torch.as_tensor(np.asarray(poses, np.float32), device=dev)
                    if use_pose else None)
        eye = torch.eye(4, **f32)
        T0 = pose_seq[0] if use_pose else eye
        with span("stitch.append"):
            combined, overflow = self._model_append(combined, first, T0)

        # the frame buffer is sized independently of the model: one
        # frustum sees far fewer voxels than the whole scene
        fcap = int(getattr(self, "frame_capacity", 0)) or cap
        # outlier_std_ratio default 2.0 matches the reference
        # (stitcher.py:158-159). The statistic is global: in a
        # mixed-density scene (dense tabletop + one object) the dominant
        # surface sets a tight threshold that scrubs the object's rim/tip
        # points as "outliers" — loosen it (or set optimization_modulus
        # high) for tabletop scans.
        std_ratio = float(getattr(self, "outlier_std_ratio", 2.0))
        one = torch.ones((), **f32)
        T_prev = T_prev2 = eye
        fits, Ts, scores, iterations = [], [], [], []
        for i in range(1, len(color_images)):
            count("stitch.frames")
            with span("stitch.frame"):
                if use_pose:
                    init = pose_seq[i]
                else:
                    # pose-free capture: constant-velocity seed — predict
                    # this frame's transform by extrapolating the last
                    # step's camera motion, T_prev @ (T_prev2^-1 T_prev)
                    init = _matmul4(T_prev, _matmul4(
                        _inverse_rigid(T_prev2), T_prev))
                with span("stitch.prepare"):
                    current_full = self.create_point_cloud_from_rgbd(
                        color_images[i] if has_col else None,
                        depth_images[i])
                    # compact the frame to a fixed buffer before
                    # registration: every downstream stage runs on
                    # fixed-size clouds
                    down = voxel_downsample(current_full, self.voxel_size)
                    cidx, ccount = _gather_slots(down.valid, fcap)
                    overflow = torch.maximum(overflow, ccount - fcap)
                    current = _take(down, cidx, ccount, fcap)
                with span("stitch.register"):
                    T, fit, steps = self._register_stages(
                        current, combined, init)
                integrate = True
                s1 = s_best = one
                with span("stitch.gate"):
                    if not use_pose:
                        # odometry chaining breaks when the camera jumps
                        # beyond ICP's capture basin, and on smooth objects
                        # the broken solve can still report high
                        # loose-threshold fitness — so gate on the
                        # tight-threshold score instead, and re-solve from
                        # a global initialization when it collapses
                        s1 = s_best = self._tight_score_j(current, combined,
                                                          T)
                        if bool(to_host(s1 < self.global_rescue_score)):
                            T, fit, s_best = self._rescue(current, combined,
                                                          T, fit, s1, i)
                        # neither the chained nor the rescued registration
                        # locked: drop the frame (an unlocked frame poisons
                        # the model) and hold the odometry chain at its
                        # last locked state so the next frame
                        # re-extrapolates from a sane pose
                        integrate = bool(to_host(
                            s_best >= self.integrate_score_floor))
                        if not integrate:
                            T, fit = T_prev, torch.zeros((), **f32)
                    else:
                        # trust-region gating against the known pose:
                        # smooth, low-texture objects let ICP slide along
                        # flat cost directions; corrections beyond the
                        # camera-pose error budget are rejected in favor of
                        # the prior
                        d = _matmul4(T, torch.linalg.inv(init))
                        rot_err = torch.arccos(torch.clamp(
                            (torch.diagonal(d[:3, :3]).sum() - 1) / 2, -1, 1))
                        bad = ((torch.linalg.norm(d[:3, 3])
                                > self.pose_trust_trans)
                               | (rot_err > self.pose_trust_rot))
                        T = torch.where(bad, init, T)
                if integrate:
                    with span("stitch.append"):
                        combined, overflow = self._model_append(
                            combined, current, T, overflow)
                if i % self.optimization_modulus == 0:
                    with span("stitch.outliers"):
                        if int(to_host(combined.valid.sum())) > 1000:
                            combined = remove_statistical_outliers(
                                combined, 20, std_ratio)
            # on a dropped frame the odometry chain does not advance
            if integrate:
                T_prev2 = T_prev
            T_prev = T
            fits.append(fit)
            Ts.append(T)
            scores.append(torch.stack([s1, s_best]))
            iterations.append(steps)
        if fits:
            self.last_fits = to_host(torch.stack(fits)).numpy()
            self.last_transforms = to_host(torch.stack(Ts)).numpy()
            self.last_scores = to_host(torch.stack(scores)).numpy()
            self.last_iterations = to_host(torch.stack(iterations)).numpy()

        overflow = int(to_host(overflow))
        self.last_overflow = overflow
        if overflow > 0:
            warnings.warn(
                f"stitcher model buffer overflowed by {overflow} voxels "
                f"(capacity {self.model_capacity}); geometry was dropped — "
                "raise model_capacity or voxel_size",
                RuntimeWarning,
                stacklevel=2,
            )
        return combined

    # ------------------------------------------------------------------
    def visualize_registration(self, source, target, transformed=None,
                               path="registration.html"):
        """Headless twin of the reference's registration viewer
        (``stitcher.py:168-200``): overlay source/target/(transformed)
        clouds in one scene, painting uncolored clouds red/green/blue
        exactly as the reference does, and write an interactive HTML
        orbit view instead of opening an Open3D GL window.

        Returns the written path.
        """
        from reconplan_tpu_torch.viz.html_export import export_cloud_html

        paint = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
        pts_all, col_all = [], []
        clouds = [source, target] + ([transformed] if transformed is not None
                                     else [])
        for cloud, default_rgb in zip(clouds, paint):
            pts, cols, _ = cloud.compact()
            if len(cols) != len(pts):
                cols = np.tile(np.asarray(default_rgb, np.float32),
                               (len(pts), 1))
            pts_all.append(pts)
            col_all.append(cols)
        return export_cloud_html(
            np.concatenate(pts_all) if pts_all else np.zeros((0, 3)),
            path,
            colors=np.concatenate(col_all) if col_all else None,
        )

    # ------------------------------------------------------------------
    # dataset loaders (stitcher.py:202-258)
    # ------------------------------------------------------------------
    def load_default(self):
        return self.load_dataset_two_folders("./camera", "rgb", "depth")

    def load_dataset_two_folders(self, folder_path, rgb_foldername,
                                 depth_foldername):
        fs = load_rgbd_folder(
            folder_path,
            rgb_foldername,
            depth_foldername,
            truncate_to_multiple=self.optimization_modulus,
        )
        return list(fs.color), list(fs.depth)

    def load_dataset_realsense(self, rgb_folder, depth_folder):
        parent = os.path.dirname(rgb_folder.rstrip("/"))
        fs = load_rgbd_folder(
            parent,
            os.path.basename(rgb_folder.rstrip("/")),
            os.path.basename(depth_folder.rstrip("/")),
            truncate_to_multiple=self.optimization_modulus,
        )
        return list(fs.color), list(fs.depth)
