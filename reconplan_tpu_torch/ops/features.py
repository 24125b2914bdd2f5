"""FPFH features and RANSAC global registration.

Port of ``reconplan_tpu.ops.features``: ``fpfh``, ``_ransac_core`` and
``ransac_global_registration``. FPFH (Rusu et al., ICRA 2009): per point,
histogram the Darboux-frame angles (alpha, phi, theta) over its k-NN (11
bins each -> 33-D SPFH), then re-weight by neighbour SPFHs:
FPFH(p) = SPFH(p) + mean_i SPFH(i) / d_i.

RANSAC is split in two. :func:`_score_hypotheses` takes the
(n_hypotheses, 3) correspondence picks and returns every hypothesis'
transform, its inlier count and the best; :func:`_ransac_core` draws the
picks with a ``torch.Generator`` (``torch.multinomial`` over the valid
correspondences, with replacement) and wraps it. The JAX package draws
with ``jax.random.categorical``, a stream no torch generator reproduces,
so the two packages agree on a pose-free stitch by outcome; given the
same picks they agree by value.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reconplan_tpu_torch.ops.icp import _cross, _transform, register_kabsch
from reconplan_tpu_torch.ops.nn import knn, nearest_neighbor
from reconplan_tpu_torch.ops.pointcloud import PointCloud, _reciprocal

def _hist11(x, lo, hi):
    """(N, k) values in [lo, hi] -> (N, 11) bin counts; the division by
    the constant range is a multiply by its f32 reciprocal, as XLA
    compiles it."""
    bins = torch.clamp(((x - lo) * _reciprocal(hi - lo) * 11).to(torch.int32),
                       0, 10)
    return torch.nn.functional.one_hot(bins.long(), 11).sum(dim=1).to(
        torch.float32)


def fpfh(cloud: PointCloud, k: int = 32):
    """(N, 33) FPFH features (cloud must carry normals)."""
    pts = cloud.points
    nrm = cloud.normals
    d, idx = knn(pts, pts, k + 1, valid=cloud.valid)
    d, idx = d[:, 1:], idx[:, 1:]  # drop self

    p = pts[:, None, :]  # (N, 1, 3)
    q = pts[idx]  # (N, k, 3)
    n_p = nrm[:, None, :]
    n_q = nrm[idx]

    diff = q - p
    dist = torch.clamp(torch.linalg.norm(diff, dim=-1), min=1e-9)
    du = diff / dist[..., None]

    # Darboux frame at p: u = n_p, v = du x u, w = u x v
    u = n_p.expand(n_q.shape)
    v = _cross(du, u)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-9)
    w = _cross(u, v)

    alpha = (v * n_q).sum(dim=-1)  # [-1, 1]
    phi = (u * du).sum(dim=-1)  # [-1, 1]
    theta = torch.atan2((w * n_q).sum(dim=-1), (u * n_q).sum(dim=-1))

    spfh = torch.cat([
        _hist11(alpha, -1.0, 1.0),
        _hist11(phi, -1.0, 1.0),
        _hist11(theta, -math.pi, math.pi),
    ], dim=-1)  # (N, 33)
    spfh = spfh / torch.clamp(spfh.sum(dim=-1, keepdim=True), min=1e-9)

    # neighborhood re-weighting
    w_nbr = 1.0 / torch.clamp(dist, min=1e-6)  # (N, k)
    nbr_spfh = spfh[idx]  # (N, k, 33)
    agg = (nbr_spfh * w_nbr[..., None]).sum(dim=1) / torch.clamp(
        w_nbr.sum(dim=1, keepdim=True), min=1e-9)
    feat = spfh + agg
    return feat / torch.clamp(torch.linalg.norm(feat, dim=-1, keepdim=True),
                              min=1e-9)


def _color_gate(src_cols, dst_cols, corr_idx, corr_valid, color_threshold):
    """Keep only correspondences whose colors agree: on repetitive or
    featureless geometry (a tabletop plane) FPFH matches are arbitrary,
    but color agreement keeps only tile-to-same-tile pairs."""
    if src_cols is None or dst_cols is None:
        return corr_valid
    cdist = torch.linalg.norm(src_cols - dst_cols[corr_idx], dim=-1)
    return corr_valid & (cdist < color_threshold)


def _score_hypotheses(src_pts, dst_pts, corr_idx, corr_valid, picks,
                      inlier_threshold):
    """Every hypothesis of ``picks`` (H, 3) correspondence indices: its
    transform (H, 4, 4) by Kabsch on the three picked pairs (valid ones
    weighted 1 + 1e-3, others 1e-3), its inlier count (H,) over the valid
    correspondences, and the index of the best (the first of equal
    counts, as ``jnp.argmax``)."""
    Ts = register_kabsch(src_pts[picks], dst_pts[corr_idx[picks]],
                         corr_valid[picks].to(torch.float32) + 1e-3)
    err = torch.linalg.norm(_transform(Ts, src_pts) - dst_pts[corr_idx],
                            dim=-1)
    scores = ((err < inlier_threshold) & corr_valid).sum(dim=-1)
    return Ts, scores, torch.argmax(scores)


def _ransac_core(src_pts, dst_pts, corr_idx, corr_valid, generator,
                 inlier_threshold, n_hypotheses,
                 src_cols=None, dst_cols=None, color_threshold=0.25):
    """(best T (4, 4), its inlier count) of ``n_hypotheses`` hypotheses,
    each 3 correspondences drawn from ``generator`` among the valid ones
    (after the color gate), with replacement. With no valid
    correspondence at all: the identity and 0, on the device, no host
    read (the draw then goes over every slot and is discarded)."""
    corr_valid = _color_gate(src_cols, dst_cols, corr_idx, corr_valid,
                             color_threshold)
    any_valid = corr_valid.any()
    probs = torch.where(any_valid, corr_valid.to(torch.float32), 1.0)
    picks = torch.multinomial(probs, 3 * n_hypotheses, replacement=True,
                              generator=generator).reshape(n_hypotheses, 3)
    Ts, scores, best = _score_hypotheses(src_pts, dst_pts, corr_idx,
                                         corr_valid, picks, inlier_threshold)
    eye = torch.eye(4, dtype=Ts.dtype, device=Ts.device)
    return (torch.where(any_valid, Ts[best], eye),
            torch.where(any_valid, scores[best], 0))


def ransac_global_registration(
    source: PointCloud,
    target: PointCloud,
    source_features,
    target_features,
    inlier_threshold=0.05,
    n_hypotheses=512,
    mutual=True,
    seed=0,
):
    """Feature-matched RANSAC alignment source -> target.

    Returns (T (4, 4) numpy, inlier_count). Matches are nearest
    neighbours in feature space (optionally mutual); the hypotheses are
    drawn from a ``torch.Generator`` seeded with ``seed`` on the clouds'
    device.
    """
    dev = source.points.device
    _, fwd = nearest_neighbor(source_features, target_features,
                              valid=target.valid)
    corr_valid = source.valid
    if mutual:
        _, bwd = nearest_neighbor(target_features, source_features,
                                  valid=source.valid)
        mutual_ok = torch.arange(source.points.shape[0], device=dev) == bwd[
            fwd]
        corr_valid = corr_valid & mutual_ok
    gen = torch.Generator(device=dev).manual_seed(seed)
    T, score = _ransac_core(source.points, target.points, fwd, corr_valid,
                            gen, inlier_threshold, n_hypotheses)
    return np.asarray(T.cpu().numpy()), int(score)
