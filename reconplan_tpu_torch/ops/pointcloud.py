"""Point-cloud primitives: backprojection, voxel filtering, normals, outliers.

Port of ``reconplan_tpu.ops.pointcloud`` (which replaces the Open3D calls
of the reference's ``stitcher.py``): ``PointCloud``, ``make_cloud``,
``backproject_depth``, ``voxel_downsample``, ``estimate_normals`` and
``remove_statistical_outliers``.

Clouds are fixed-capacity, as in the JAX package: (N, 3) tensors with an
(N,) validity mask; filters return same-size clouds with updated masks
instead of compacting (``compact()`` is the host-side convenience). No
function here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reconplan_tpu_torch.ops.nn import knn
from reconplan_tpu_torch.utils.device import resolve_device, scalar_tensor


class PointCloud(NamedTuple):
    """Fixed-capacity point cloud: (N, 3) positions + mask (+ optional
    colors/normals, zero-sized when absent)."""

    points: torch.Tensor  # (N, 3)
    valid: torch.Tensor  # (N,) bool
    colors: torch.Tensor  # (N, 3) in [0, 1], or (0, 3)
    normals: torch.Tensor  # (N, 3), or (0, 3)

    @property
    def has_colors(self):
        return self.colors.shape[0] == self.points.shape[0]

    @property
    def has_normals(self):
        return self.normals.shape[0] == self.points.shape[0]

    def count(self):
        return int(self.valid.sum())

    def compact(self):
        """Host-side: drop invalid points; (points, colors, normals) as
        numpy, the last two (0, 3) when absent."""
        m = self.valid.cpu().numpy()
        pts = self.points.cpu().numpy()[m]
        empty = np.zeros((0, 3), np.float32)
        cols = self.colors.cpu().numpy()[m] if self.has_colors else empty
        nrms = self.normals.cpu().numpy()[m] if self.has_normals else empty
        return pts, cols, nrms


def _f32(x, device):
    if not isinstance(x, torch.Tensor):
        x = np.array(x, np.float32)  # a writable copy
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def make_cloud(points, colors=None, normals=None, valid=None,
               device=None) -> PointCloud:
    """A cloud from tensors or arrays. A tensor ``points`` keeps its
    device; numpy input goes to ``device`` (default: the card)."""
    device = (points.device if isinstance(points, torch.Tensor)
              else resolve_device(device))
    points = _f32(points, device)
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=device)
    empty = torch.zeros((0, 3), dtype=torch.float32, device=device)
    return PointCloud(
        points,
        torch.as_tensor(valid, dtype=torch.bool, device=device),
        _f32(colors, device) if colors is not None else empty,
        _f32(normals, device) if normals is not None else empty,
    )


def _reciprocal(c):
    """The f32 reciprocal of a constant divisor: XLA turns a division by a
    compile-time constant into a multiply by it, so multiplying by it
    gives the JAX package's floats."""
    return float(np.float32(1.0) / np.float32(c))


def backproject_depth(
    depth,  # (H, W) raw depth
    fx, fy, cx, cy,  # pinhole intrinsics (scalars)
    color=None,  # optional (H, W, 3) in [0, 255] or [0, 1]
    depth_scale: float = 1000.0,
    depth_trunc: float = 3.0,
    device=None,
):
    """Depth (+RGB) image -> camera-frame point cloud.

    Open3D ``RGBDImage.create_from_color_and_depth`` +
    ``PointCloud.create_from_rgbd_image`` semantics: metric depth = raw /
    depth_scale, truncated at ``depth_trunc`` meters; pixel (u, v)
    backprojects through the pinhole. A tensor ``depth`` keeps its device;
    numpy input goes to ``device`` (default: the card).

    Returns a PointCloud with N = H*W (invalid pixels masked, not dropped).
    """
    device = (depth.device if isinstance(depth, torch.Tensor)
              else resolve_device(device))
    depth = torch.as_tensor(depth, device=device)
    H, W = depth.shape
    raw = depth.to(torch.float32)
    inv_scale = _reciprocal(depth_scale)
    z = raw * inv_scale
    valid = (z > 0.0) & (z < depth_trunc)
    u = torch.arange(W, dtype=torch.float32, device=device)
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    # x = (u - cx) * z / fx in the order XLA compiles it: the depth scale
    # joins the pixel offset, (u - cx) * (1 / depth_scale), before the
    # depth; the intrinsics are traced arguments there, so the divides
    # are true divides, which a 0-d tensor divisor keeps on the card too
    x = raw * ((u - cx) * inv_scale) / scalar_tensor(fx, device)
    y = raw * ((v - cy) * inv_scale) / scalar_tensor(fy, device)
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    valid = valid.reshape(-1)
    if color is not None:
        c = torch.as_tensor(color, device=device).to(torch.float32)
        c = c.reshape(-1, 3)
        c = torch.where(c.max() > 1.5, c * _reciprocal(255.0), c)
        return make_cloud(pts, colors=c, valid=valid)
    return make_cloud(pts, valid=valid)


def _segment_sum(x_sorted, lengths):
    """Sums of consecutive runs of ``x_sorted`` (N, C) of the given
    ``lengths`` (N,), zero where a run is empty: one pass in a fixed
    order, no atomics."""
    return torch.segment_reduce(x_sorted, "sum", lengths=lengths, axis=0)


def _voxel_ids(cloud: PointCloud, voxel_size: float, grid_extent=None):
    """(N,) int32 packed voxel id of each point (2^10 cells per axis, 10
    bits each); invalid points get 2^31 - 1, which sorts last."""
    points = cloud.points
    inv = 1.0 / voxel_size
    cells = 1 << 10  # 3 * 10 bits packs into int32
    if grid_extent is not None:
        if int(2 * grid_extent * inv) > cells:
            raise ValueError(
                f"grid_extent {grid_extent} too large for voxel {voxel_size}: "
                f"needs more than {cells} cells/axis"
            )
        center = torch.zeros(3, dtype=torch.float32, device=points.device)
    else:
        w = cloud.valid.to(torch.float32)
        center = (points * w[:, None]).sum(dim=0) / torch.clamp(w.sum(),
                                                                 min=1.0)
        # snap to the voxel lattice so cell boundaries stay origin-aligned
        # (Open3D semantics: boundaries at integer multiples of voxel_size)
        center = torch.round(center * inv) * voxel_size
    half_span = (cells // 2) * voxel_size
    q = torch.clamp(
        torch.floor((points - center + half_span) * inv).to(torch.int32),
        0, cells - 1,
    )
    ids = (q[:, 0] << 20) | (q[:, 1] << 10) | q[:, 2]
    return torch.where(cloud.valid, ids, 2**31 - 1)


def voxel_downsample(cloud: PointCloud, voxel_size: float, grid_extent=None):
    """Average points within each voxel (Open3D ``voxel_down_sample``).

    Exact, fixed-shape algorithm:
      1. quantize to voxel ids packed into int32 (2^10 cells per axis).
         The packable window spans +-512 voxels around the valid points'
         centroid (snapped to the voxel lattice) unless ``grid_extent``
         pins a fixed +-extent around the origin; points outside the
         window clamp into edge cells (merged conservatively),
      2. stable sort by id; runs of equal ids are the voxels,
      3. segment-mean positions/colors/normals into N output slots, one
         run after the other (``torch.segment_reduce``), in the sorted
         order: the same order of additions as the JAX segment sum.

    Output capacity equals input capacity; slot i is valid iff it is the
    representative (mean) of a distinct occupied voxel.
    """
    points = cloud.points
    n, dev = points.shape[0], points.device
    ids = _voxel_ids(cloud, voxel_size, grid_extent)

    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    starts[1:] = ids_sorted[1:] != ids_sorted[:-1]
    seg = torch.cumsum(starts.to(torch.int64), dim=0) - 1  # run index
    lengths = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, seg, torch.ones(n, dtype=torch.int64, device=dev))

    w = cloud.valid[order].to(torch.float32)[:, None]
    counts = _segment_sum(w, lengths)[:, 0]
    denom = torch.clamp(counts, min=1.0)[:, None]

    def seg_mean(x):
        return _segment_sum(x[order] * w, lengths) / denom

    means = seg_mean(points)
    colors = (seg_mean(cloud.colors) if cloud.has_colors
              else torch.zeros((0, 3), dtype=torch.float32, device=dev))
    normals = cloud.normals
    if cloud.has_normals:
        nm = seg_mean(cloud.normals)
        normals = nm / torch.clamp(torch.linalg.norm(nm, dim=-1,
                                                     keepdim=True), min=1e-9)
    return PointCloud(means, counts > 0.0, colors, normals)


# the most matrices one ``torch.linalg.eigh`` call takes: on an H100
# (CUDA 12.8) cuSOLVER's batched eigensolver takes 16,384 3x3 matrices
# and refuses 32,768 and more (CUSOLVER_STATUS_INVALID_VALUE), and the
# close stage asks for 80,000
EIGH_BATCH = 16384


def batched_eigh(mats):
    """``torch.linalg.eigh`` of (B, n, n) symmetric matrices, in batches of
    at most ``EIGH_BATCH``: (eigenvalues (B, n) ascending, eigenvectors
    (B, n, n) in columns)."""
    if mats.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(mats)
    vals, vecs = zip(*(torch.linalg.eigh(m) for m in mats.split(EIGH_BATCH)))
    return torch.cat(vals), torch.cat(vecs)


def _outer_mean(x, k):
    """(N, k, 3) -> (N, 3, 3) of sum_k x_i x_j / k, as multiplies and sums
    (no matmul, so no TF32)."""
    return (x[..., :, None] * x[..., None, :]).sum(dim=-3) * _reciprocal(k)


def estimate_normals(cloud: PointCloud, k: int = 30):
    """Per-point normals from the k-NN covariance (Open3D
    ``estimate_normals`` with KDTreeSearchParamHybrid; radius gating is
    dropped — dense top-k dominates at these sizes).

    Normals are the smallest-eigenvalue eigenvector of the local
    covariance (:func:`batched_eigh`), oriented toward the origin
    (camera) like Open3D's default for clouds born from RGBD frames. The
    orientation also removes the sign ``eigh`` leaves open, so only a
    point with n . p ~ 0 can come out flipped against the JAX package.
    """
    _, idx = knn(cloud.points, cloud.points, k, valid=cloud.valid)
    nbrs = cloud.points[idx]  # (N, k, 3)
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = _outer_mean(centered, k)
    _, vecs = batched_eigh(cov)
    normals = vecs[:, :, 0]
    # orient toward viewpoint at origin
    flip = (normals * cloud.points).sum(dim=-1) > 0
    normals = torch.where(flip[:, None], -normals, normals)
    return PointCloud(cloud.points, cloud.valid, cloud.colors, normals)


def remove_statistical_outliers(
    cloud: PointCloud, nb_neighbors: int = 20, std_ratio: float = 2.0
):
    """Open3D ``remove_statistical_outlier``: points whose mean k-NN
    distance exceeds (mean + std_ratio * std) of the per-point means are
    masked out."""
    d, _ = knn(cloud.points, cloud.points, nb_neighbors + 1,
               valid=cloud.valid)
    mean_d = d[:, 1:].mean(dim=-1)  # skip self
    mean_d = torch.where(cloud.valid, mean_d, 0.0)
    n_valid = torch.clamp(cloud.valid.sum(), min=1)
    mu = mean_d.sum() / n_valid
    var = torch.where(cloud.valid, (mean_d - mu) ** 2, 0.0).sum() / n_valid
    thresh = mu + std_ratio * torch.sqrt(var)
    keep = cloud.valid & (mean_d <= thresh)
    return PointCloud(cloud.points, keep, cloud.colors, cloud.normals)
