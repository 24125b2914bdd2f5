"""Plain reference of the pose-seeded ICP stitch, in float32 ``torch``.

The incremental frame-to-model stitch of geconf/3d-reconstruction-planning
``stitcher.py:114-166``, written again from Open3D's published description
of each step, with the camera poses seeding every registration (the route
of the scan's CLI):

1. back-projection of each depth picture (depth scale 1000, truncation
   3 m), colors of 8-bit pictures over 255;
2. voxel averaging of positions and colors;
3. normals from the 30 nearest neighbours' covariance, the eigenvector of
   its smallest eigenvalue;
4. three registrations of the frame to the model, each a Gauss-Newton
   solve on the se(3) twist that stops when the inlier rmse moves by no
   more than ``relative_rmse`` of itself: coarse point-to-plane at twice
   the voxel and twice the distance, colored ICP (Park, Zhou and Koltun,
   ICCV 2017: lambda 0.968, intensity gradients fitted in each target
   point's tangent plane over its 10 nearest neighbours), and fine
   point-to-plane;
5. a trust region around the seeding pose: a correction beyond it is
   dropped for the pose;
6. the merge: the moved frame and the model voxel-averaged together, the
   first ``model_capacity`` voxels kept;
7. every ``outlier_every`` frames, once the model holds more than
   ``outlier_min_points`` points, Open3D's statistical outlier removal.

Nearest neighbours are brute force by direct subtraction, in blocks of
rows: no matmul identity, so nothing here shares the program's
arithmetic. Clouds hold their valid points only. ``dtype`` other than
float32 rounds every cloud to it and computes every distance in it: the
control that a limit must refuse.

Departures from Open3D, each the convention the port documents:
- voxel cells have their boundaries at integer multiples of the voxel
  (Open3D starts them at the cloud's lower bound less half a voxel);
- the model and the frame keep their first voxels in the order of their
  cells, x then y then z, and the voxels past the capacity are counted
  as overflow (Open3D keeps every voxel);
- normals take the 30 nearest neighbours with no search radius, and point
  toward the origin of the cloud's own frame: the camera for a frame, the
  world's origin for the model (Open3D orients toward the camera only for
  clouds made from an RGBD picture);
- the update applies the exponential of the rotation part of the twist
  (Rodrigues) and the translation part as it is (Open3D composes three
  rotations about the axes), and the normal equations carry a damping of
  1e-6 on the diagonal;
- the stop rule reads the relative change of the rmse alone (Open3D also
  reads the fitness's), with the rmse taken before each update;
- the gradient fit carries the tangent-plane condition n . d = 0 as one
  more equation and 1e-6 on the diagonal (Open3D the same equation, with
  no damping).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfcells.traffic import render

# the most entries of one block of differences (each 3 floats)
BLOCK_ENTRIES = 1 << 23
# a cell index offset that keeps each axis positive in 21 bits
_CELL_OFFSET = 1 << 20


@dataclass
class Stitched:
    """What a stitch produced: the transforms of frames 1.. (F-1, 4, 4),
    the model's points and colors (M, 3), the most voxels a buffer could
    not hold, and the steps each registration's stages took (F-1, stages
    of the schedule)."""

    transforms: np.ndarray
    points: np.ndarray
    colors: np.ndarray
    overflow: int
    steps: np.ndarray


class _Plain:
    """The stitch's steps at one precision."""

    def __init__(self, dtype):
        self.dtype = dtype

    def rounded(self, x):
        """``x`` held at the reference's precision, in float32."""
        if self.dtype == torch.float32:
            return x
        return x.to(self.dtype).to(torch.float32)

    def nearest(self, queries, points, k):
        """(distances (Q, k) ascending, indices (Q, k)) of the ``k``
        nearest of ``points`` to each query, by direct subtraction."""
        k = min(k, points.shape[0])
        rows = max(1, BLOCK_ENTRIES // max(points.shape[0], 1))
        p = points.to(self.dtype)
        ds, ids = [], []
        for block in queries.split(rows):
            diff = block.to(self.dtype)[:, None, :] - p[None, :, :]
            d2 = (diff * diff).sum(dim=-1).to(torch.float32)
            d2, i = torch.topk(d2, k, dim=1, largest=False)
            ds.append(d2.sqrt())
            ids.append(i)
        return torch.cat(ds), torch.cat(ids)

    def voxel_average(self, points, colors, voxel):
        """Mean position and color of each occupied voxel, in the order of
        the cells (x, then y, then z)."""
        cell = torch.floor(points.double() / voxel).long() + _CELL_OFFSET
        key = (cell[:, 0] << 42) | (cell[:, 1] << 21) | cell[:, 2]
        _, inverse, counts = torch.unique(key, sorted=True,
                                          return_inverse=True,
                                          return_counts=True)
        n = counts.shape[0]
        counts = counts.double()[:, None]

        def mean(x):
            s = torch.zeros((n, 3), dtype=torch.float64, device=x.device)
            return self.rounded((s.index_add_(0, inverse, x.double())
                                 / counts).float())

        return mean(points), mean(colors)

    def normals(self, points, k):
        """Unit normals from the ``k``-NN covariance, toward the origin."""
        _, idx = self.nearest(points, points, k)
        nb = points[idx]
        centred = nb - nb.mean(dim=1, keepdim=True)
        cov = (centred[..., :, None] * centred[..., None, :]).mean(dim=1)
        _, vecs = torch.linalg.eigh(cov)
        n = vecs[:, :, 0]
        away = (n * points).sum(dim=-1) > 0
        return torch.where(away[:, None], -n, n)

    def gradients(self, points, normals, intensity, k):
        """Park et al.'s intensity gradient of each point, in its tangent
        plane, fitted over its ``k`` nearest other points."""
        _, idx = self.nearest(points, points, k + 1)
        idx = idx[:, 1:]
        dq = points[idx] - points[:, None, :]
        proj = dq - (dq * normals[:, None, :]).sum(-1, keepdim=True) \
            * normals[:, None, :]
        A = torch.cat([proj, normals[:, None, :]], dim=1)
        b = torch.cat([intensity[idx] - intensity[:, None],
                       torch.zeros_like(intensity[:, None])], dim=1)
        eye = torch.eye(3, device=points.device)
        AtA = (A[..., :, None] * A[..., None, :]).sum(dim=1) + 1e-6 * eye
        Atb = (A * b[..., None]).sum(dim=1)
        return torch.linalg.solve(AtA, Atb)


def _mm(A, B):
    """(..., n, m) @ (..., m, p) as multiplies and sums."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def _moved(T, points):
    return (points[:, None, :] * T[None, :3, :3]).sum(dim=-1) + T[:3, 3]


def _inverse(T):
    inv = torch.eye(4, dtype=T.dtype, device=T.device)
    inv[:3, :3] = T[:3, :3].T
    inv[:3, 3] = -(T[:3, :3].T * T[:3, 3]).sum(dim=-1)
    return inv


def _exp(xi):
    """The 4x4 update of a twist (omega, v): Rodrigues' rotation of omega,
    translation v."""
    w, v = xi[:3], xi[3:]
    th = torch.linalg.norm(w)
    some = th > 1e-12
    safe = torch.where(some, th, torch.ones_like(th))
    a = torch.where(some, torch.sin(safe) / safe, torch.ones_like(th))
    # (1 - cos th) / th^2 as 2 sin^2(th / 2) / th^2, which keeps its digits
    half = torch.where(some, torch.sin(safe / 2) / (safe / 2),
                       torch.ones_like(th))
    b = 0.5 * half * half
    zero = torch.zeros_like(th)
    K = torch.stack([torch.stack([zero, -w[2], w[1]]),
                     torch.stack([w[2], zero, -w[0]]),
                     torch.stack([-w[1], w[0], zero])])
    T = torch.eye(4, device=xi.device)
    T[:3, :3] = torch.eye(3, device=xi.device) + a * K + b * _mm(K, K)
    T[:3, 3] = v
    return T


def _gauss_newton(A, r, w):
    """The twist that minimises sum w (A xi + r)^2, damped by 1e-6."""
    wA = A * w[:, None]
    JtJ = (wA[:, :, None] * A[:, None, :]).sum(dim=0)
    Jtr = (wA * r[:, None]).sum(dim=0)
    JtJ = JtJ + 1e-6 * torch.eye(6, device=A.device)
    return torch.linalg.solve(JtJ, -Jtr)


def _solve(step, T, iterations, relative_rmse):
    """Gauss-Newton steps while fewer than ``iterations`` were taken and
    the rmse (at the pose before each step) moved by more than
    ``relative_rmse`` of itself at the last one. Returns (T, steps)."""
    prev, rmse = 0.0, 1e30
    steps = 0
    while steps < iterations:
        if not abs(prev - rmse) > relative_rmse * max(rmse, 1e-12):
            break
        T, r = step(T)
        prev, rmse = rmse, float(r)
        steps += 1
    return T, steps


def _point_to_plane(plain, src, tgt, tgt_n, max_dist):
    def step(T):
        moved = _moved(T, src)
        d, idx = plain.nearest(moved, tgt, 1)
        w = (d[:, 0] < max_dist).float()
        q, n = tgt[idx[:, 0]], tgt_n[idx[:, 0]]
        r = ((moved - q) * n).sum(dim=-1)
        A = torch.cat([torch.linalg.cross(moved, n, dim=-1), n], dim=-1)
        xi = _gauss_newton(A, r, w)
        rmse = torch.sqrt((w * r * r).sum() / torch.clamp(w.sum(), min=1.0))
        return _mm(_exp(xi), T), rmse

    return step


def _colored(plain, src, src_i, tgt, tgt_n, tgt_i, grad, max_dist, lam):
    sg, sc = float(np.sqrt(lam)), float(np.sqrt(1.0 - lam))

    def step(T):
        moved = _moved(T, src)
        d, idx = plain.nearest(moved, tgt, 1)
        w = (d[:, 0] < max_dist).float()
        i = idx[:, 0]
        q, n, g = tgt[i], tgt_n[i], grad[i]
        r_g = ((moved - q) * n).sum(dim=-1)
        A_g = torch.cat([torch.linalg.cross(moved, n, dim=-1), n], dim=-1)
        # the photometric residual at the point's projection on the
        # target's tangent plane, and its derivative (the gradient's
        # tangent part, with the sign of the residual)
        proj = moved - ((moved - q) * n).sum(-1, keepdim=True) * n
        r_c = src_i - (tgt_i[i] + (g * (proj - q)).sum(dim=-1))
        M = g - (g * n).sum(-1, keepdim=True) * n
        A_c = torch.cat([torch.linalg.cross(moved, -M, dim=-1), -M], dim=-1)
        A = torch.cat([A_g * sg, A_c * sc])
        r = torch.cat([r_g * sg, r_c * sc])
        xi = _gauss_newton(A, r, torch.cat([w, w]))
        rmse = torch.sqrt(((w * r_g * r_g).sum() * lam
                           + (w * r_c * r_c).sum() * (1 - lam))
                          / torch.clamp(w.sum(), min=1.0))
        return _mm(_exp(xi), T), rmse

    return step


def _register(plain, frame, model, T, cfg):
    """The schedule's stages, frame onto model, from ``T``: (T, the steps
    of each stage)."""
    clouds = {}  # voxel factor -> source, its colors, target, ...
    steps = []
    for stage in cfg["stages"]:
        f = stage["voxel_factor"]
        if f not in clouds:
            v = cfg["voxel_size"] * f
            tgt, tgt_c = plain.voxel_average(*model, v)
            clouds[f] = (*plain.voxel_average(*frame, v), tgt, tgt_c,
                         plain.normals(tgt, cfg["normal_neighbors"]))
        src, src_c, tgt, tgt_c, tgt_n = clouds[f]
        max_dist = cfg["distance_threshold"] * stage["distance_factor"]
        if stage["kind"] == "point_to_plane":
            step = _point_to_plane(plain, src, tgt, tgt_n, max_dist)
        else:
            tgt_i = tgt_c.mean(dim=-1)
            grad = plain.gradients(tgt, tgt_n, tgt_i,
                                   cfg["gradient_neighbors"])
            step = _colored(plain, src, src_c.mean(dim=-1), tgt, tgt_n,
                            tgt_i, grad, max_dist, cfg["lambda_geometric"])
        T, n = _solve(step, T, stage["iterations"], cfg["relative_rmse"])
        steps.append(n)
    return T, steps


def _trusted(T, init, cfg):
    """``T``, or ``init`` where the correction leaves the trust region."""
    d = _mm(T, _inverse(init))
    cos = torch.clamp((torch.diagonal(d[:3, :3]).sum() - 1) / 2, -1, 1)
    far = (float(torch.linalg.norm(d[:3, 3])) > cfg["pose_trust_m"]
           or float(torch.arccos(cos)) > cfg["pose_trust_rad"])
    return init if far else T


def _backproject(plain, depth, color, intrinsics, cfg):
    fx, fy, cx, cy = intrinsics
    z = depth.to(torch.float32) / cfg["depth_scale"]
    H, W = z.shape
    u = torch.arange(W, dtype=torch.float32, device=z.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=z.device)[:, None]
    pts = torch.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], dim=-1)
    keep = ((z > 0) & (z < cfg["depth_trunc"])).reshape(-1)
    cols = color.to(torch.float32).reshape(-1, 3) / 255.0
    return plain.rounded(pts.reshape(-1, 3)[keep]), plain.rounded(cols[keep])


def _kept(cloud, cap):
    """The first ``cap`` voxels, and how many were past it."""
    n = cloud[0].shape[0]
    return (cloud[0][:cap], cloud[1][:cap]), max(n - cap, 0)


def _without_outliers(plain, model, cfg):
    d, _ = plain.nearest(model[0], model[0], cfg["outlier_neighbors"] + 1)
    mean_d = d[:, 1:].mean(dim=-1)
    mu = mean_d.mean()
    sd = torch.sqrt(((mean_d - mu) ** 2).mean())
    keep = mean_d <= mu + cfg["outlier_std_ratio"] * sd
    return model[0][keep], model[1][keep]


def stitch(colors, depths, poses, intrinsics, cfg, dtype=torch.float32):
    """The stitch of the pictures ``colors`` (F, H, W, 3) 8-bit and
    ``depths`` (F, H, W) in ``cfg["depth_scale"]`` units, each frame
    seeded by its camera-to-world pose ``poses`` (F, 4, 4), on the
    device of ``depths``; ``cfg`` holds the configuration's settings.
    Returns a :class:`Stitched`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plain = _Plain(dtype)
    dev = depths[0].device
    voxel = cfg["voxel_size"]
    seeds = torch.as_tensor(np.asarray(poses, np.float32), device=dev)

    def frame(i):
        return _backproject(plain, depths[i], colors[i], intrinsics, cfg)

    def merged(model, cloud, T):
        pts = torch.cat([model[0], plain.rounded(_moved(T, cloud[0]))])
        both = plain.voxel_average(pts, torch.cat([model[1], cloud[1]]),
                                   voxel)
        return _kept(both, cfg["model_capacity"])

    empty = torch.zeros((0, 3), device=dev)
    model, overflow = merged((empty, empty), frame(0), seeds[0])
    transforms, steps = [], []
    for i in range(1, len(depths)):
        current, over = _kept(plain.voxel_average(*frame(i), voxel),
                              cfg["frame_capacity"])
        overflow = max(overflow, over)
        T, n = _register(plain, current, model, seeds[i], cfg)
        T = _trusted(T, seeds[i], cfg)
        model, over = merged(model, current, T)
        overflow = max(overflow, over)
        if (i % cfg["outlier_every"] == 0
                and model[0].shape[0] > cfg["outlier_min_points"]):
            model = _without_outliers(plain, model, cfg)
        transforms.append(T)
        steps.append(n)
    return Stitched(
        transforms=(torch.stack(transforms).cpu().numpy().astype(np.float64)
                    if transforms else np.zeros((0, 4, 4))),
        points=model[0].cpu().numpy(), colors=model[1].cpu().numpy(),
        overflow=int(overflow),
        steps=np.asarray(steps, np.int64).reshape(-1, len(cfg["stages"])))


def mesh_points(path, n, translate, seed=0):
    """(n, 3) f32 area-weighted samples of the mesh at ``path``, moved by
    ``translate``."""
    v, f = render.load_ply(path)
    pts, _ = render.sample_mesh_surface(v, f, n, seed=seed)
    return (pts + np.asarray(translate, np.float64)).astype(np.float32)


def _directed(a, b, device):
    """Distance of each point of ``a`` to its nearest in ``b``."""
    plain = _Plain(torch.float32)
    d, _ = plain.nearest(torch.as_tensor(a, device=device),
                         torch.as_tensor(b, device=device), 1)
    return d[:, 0].double().cpu().numpy()


def _pose_gaps(program, reference):
    """The largest translation (mm) and rotation (mrad) gap between the
    two stitches' per-frame transforms."""
    Tp, Tr = program.transforms, reference.transforms
    gap_m = np.linalg.norm(Tp[:, :3, 3] - Tr[:, :3, 3], axis=-1)
    # the angle of R_p^T R_r from both its sine and its cosine, which
    # keeps its digits near 0
    rel = np.einsum("fji,fjk->fik", Tp[:, :3, :3], Tr[:, :3, :3])
    sin = 0.5 * np.linalg.norm(np.stack([rel[:, 2, 1] - rel[:, 1, 2],
                                         rel[:, 0, 2] - rel[:, 2, 0],
                                         rel[:, 1, 0] - rel[:, 0, 1]], -1),
                               axis=-1)
    angle = np.arctan2(sin, (np.trace(rel, axis1=1, axis2=2) - 1) / 2)
    return (float(gap_m.max(initial=0.0)) * 1e3,
            float(angle.max(initial=0.0)) * 1e3)


def _skipped_solves(program, reference):
    """The program's solves (a frame's stage) that took fewer live steps
    than the reference's or 2, whichever is fewer: a sound solve's first
    two steps are always live, since the stop rule first compares the
    rmse with a sentinel. Every solve counts where the program reports
    another schedule."""
    P, R = np.asarray(program.steps), np.asarray(reference.steps)
    if P.shape != R.shape:
        return float(R.size)
    return float((P < np.minimum(R, 2)).sum())


def readings(program, reference, mesh, voxel, device):
    """The numbers the judge reads, program against reference: the
    largest pose gaps (mm, mrad), the ICP solves the program cut short
    (:func:`_skipped_solves`), the share of either model's points farther
    than one voxel from all of the other's (the larger), the program
    model's symmetric Chamfer to the mesh samples (mm) and the program's
    overflow (voxels)."""
    gap_mm, gap_mrad = _pose_gaps(program, reference)
    stray = 1.0
    if len(program.points) and len(reference.points):
        stray = max(
            float((_directed(program.points, reference.points, device)
                   > voxel).mean()),
            float((_directed(reference.points, program.points, device)
                   > voxel).mean()))
    chamfer = float("inf")
    if len(program.points):
        chamfer = 0.5 * (_directed(program.points, mesh, device).mean()
                         + _directed(mesh, program.points, device).mean())
    return {
        "pose_gap_mm": gap_mm,
        "pose_gap_mrad": gap_mrad,
        "skipped_solves": _skipped_solves(program, reference),
        "model_stray_share": stray,
        "gt_chamfer_mm": float(chamfer) * 1e3,
        "overflow_voxels": float(program.overflow),
    }
