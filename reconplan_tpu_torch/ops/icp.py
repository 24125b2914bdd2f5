"""Iterative closest point registration.

Port of ``reconplan_tpu.ops.icp`` (which replaces Open3D's registration
pipeline of the reference stitcher): ``ICPResult``, ``register_kabsch``
(Horn's quaternion method), ``icp_point_to_point``,
``icp_point_to_plane``, ``color_gradients`` and ``colored_icp`` (Park,
Zhou, Koltun ICCV 2017).

Correspondences are dense nearest neighbours (no KD-tree) and every
iteration is fixed-shape (threshold masking, never compaction). Each JAX
solve is one ``lax.while_loop``; here it is a Python loop over a solve
(``ops/kernels/icp_step.IcpSolve``) that keeps a ``live`` flag on the
device: the transform, the rmse and the iteration count change only
while the JAX stop test holds, so the loop takes exactly the JAX number
of iterations, and the host asks the flag only every ``CHECK_EVERY``
iterations (each question is a synchronisation, counted as one
``host.reads``). Each step the host issues counts one ``icp.steps``,
frozen ones past convergence included, and each point-to-plane and
colored solve is one span (``icp.point_to_plane``, ``icp.colored``).
On the card a point-to-plane or colored step is the kernel pair K9
(``ops/kernels/icp_step``); on the CPU, and for point-to-point
everywhere, it is the plain step below. K9's neighbour search is exact
(by subtraction) where the plain step's matmul form can pick either of
two nearly equidistant targets, so on the card a solve can settle in
fewer steps under the same stop test.

The 6x6 normal equations and the batched 3x3 gradient fits go to
``torch.linalg.solve_ex``, which neither raises on a singular system nor
synchronises to check it; 3x3 and 4x4 products are multiplies and sums,
never ``torch.matmul`` (no TF32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.ops.kernels.icp_step import (
    COLORED,
    POINT_TO_PLANE,
    icp_result,
    icp_result_reference,
    icp_solve,
    icp_step,
    icp_step_reference,
    plain_solve,
)
from reconplan_tpu_torch.ops.nn import knn, nearest_neighbor
from reconplan_tpu_torch.ops.pointcloud import PointCloud, batched_eigh
from reconplan_tpu_torch.utils.profiling import count, spanned, to_host

# iterations between two looks at whether the solve is still live
CHECK_EVERY = 4


class ICPResult(NamedTuple):
    transformation: torch.Tensor  # (4, 4)
    fitness: torch.Tensor  # inliers / valid source points
    inlier_rmse: torch.Tensor
    iterations: torch.Tensor


def _transform(T, pts):
    """``pts @ R.T + t`` for (..., 4, 4) T and (..., N, 3) pts."""
    R, t = T[..., None, :3, :3], T[..., None, :3, 3]
    return (pts[..., None, :] * R).sum(dim=-1) + t


def _matmul4(A, B):
    """(..., 4, 4) @ (..., 4, 4) as multiplies and sums."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def _rigid(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4) rigid transform."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def register_kabsch(src, dst, weights):
    """Weighted rigid alignment src -> dst (Horn's quaternion method).

    Args: (..., N, 3), (..., N, 3), (..., N) weights (0 for
    non-correspondences); leading dimensions batch. Returns (..., 4, 4).

    The optimal rotation is the principal eigenvector of a symmetric 4x4
    built from the cross-covariance (Horn, JOSA 1987); q and -q give the
    same R, so the sign ``eigh`` picks does not matter. With no weight at
    all, S = 0 and K = 0: the rotation is whatever principal eigenvector
    the library returns for the zero matrix.
    """
    w = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    mu_s = (src * w[..., None]).sum(dim=-2)
    mu_d = (dst * w[..., None]).sum(dim=-2)
    s = src - mu_s[..., None, :]
    d = dst - mu_d[..., None, :]
    # cross-covariance S[i, j] = sum_n w s_i d_j
    S = ((s * w[..., None])[..., :, :, None] * d[..., :, None, :]).sum(dim=-3)
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    K = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], dim=-2)
    _, vecs = batched_eigh(K.reshape(-1, 4, 4))
    vecs = vecs.reshape(K.shape)
    q_wxyz = vecs[..., :, -1]  # principal eigenvector = optimal quaternion
    quat = torch.cat([q_wxyz[..., 1:], q_wxyz[..., :1]], dim=-1)  # -> xyzw
    R = maths.quat_to_matrix(maths.quat_normalize(quat))
    t = mu_d - (R * mu_s[..., None, :]).sum(dim=-1)
    return _rigid(R, t)


def _se3_exp(xi):
    """Twist (omega (3,), v (3,)) -> (4, 4) via quaternion exponential."""
    omega, v = xi[:3], xi[3:]
    R = maths.quat_to_matrix(maths.rotvec_to_quat(omega))
    # first-order translation (standard small-step GN update)
    return _rigid(R, v)


def _correspondences(T, src_pts, src_valid, dst_pts, dst_valid, max_dist):
    moved = _transform(T, src_pts)
    d, idx = nearest_neighbor(moved, dst_pts, valid=dst_valid)
    w = (src_valid & (d < max_dist)).to(torch.float32)
    return moved, idx, d, w


def _solve(step, solve, max_iteration):
    """The JAX ``lax.while_loop`` of every ICP here: ``step(solve)`` takes
    one step of ``solve``, which moves its T only while fewer than
    ``max_iteration`` steps were taken and the rmse still moves by more
    than its ``relative_rmse`` of itself (``live``); the host looks at
    ``live`` every ``CHECK_EVERY`` steps and stops at the first look
    that finds it off."""
    for it in range(max_iteration):
        if it and it % CHECK_EVERY == 0 and not bool(to_host(solve.live)):
            break
        count("icp.steps")
        step(solve)


def _init(init, device):
    if init is None:
        return torch.eye(4, dtype=torch.float32, device=device)
    return torch.as_tensor(init, dtype=torch.float32, device=device)


def _final(T, source, target, max_dist):
    """(fitness, inlier rmse) at the converged T: inliers over valid source
    points, and the point-to-point rmse of the inliers."""
    _, _, d, w = _correspondences(T, source.points, source.valid,
                                  target.points, target.valid, max_dist)
    n_src = torch.clamp(source.valid.to(torch.float32).sum(), min=1.0)
    n_in = torch.clamp(w.sum(), min=1.0)
    return w.sum() / n_src, torch.sqrt((w * d * d).sum() / n_in)


def icp_point_to_point(
    source: PointCloud,
    target: PointCloud,
    max_correspondence_distance: float,
    init: torch.Tensor | None = None,
    max_iteration: int = 30,
    relative_rmse: float = 1e-6,
):
    """Point-to-point ICP (Open3D semantics, the reference's
    ``stitcher.py:106-112``)."""
    T0 = _init(init, source.points.device)

    def step(T):
        _, idx, d, w = _correspondences(
            T, source.points, source.valid, target.points, target.valid,
            max_correspondence_distance)
        T_new = register_kabsch(source.points, target.points[idx], w)
        n_in = torch.clamp(w.sum(), min=1.0)
        return T_new, torch.sqrt((w * d * d).sum() / n_in)

    solve = plain_solve(T0, relative_rmse, step, lambda T: _final(
        T, source, target, max_correspondence_distance))
    _solve(icp_step_reference, solve, max_iteration)
    return ICPResult(*icp_result_reference(solve))


def _gauss_newton_step(A_rows, residuals, weights, damping=1e-6):
    """Solve the normal equations for a stack of scalar residual rows.

    A_rows: (N, 6) Jacobian rows; residuals (N,); weights (N,).
    Returns the twist update xi (6,).
    """
    wA = A_rows * weights[:, None]
    JtJ = (wA[:, :, None] * A_rows[:, None, :]).sum(dim=0)
    Jtr = (wA * residuals[:, None]).sum(dim=0)
    JtJ = JtJ + damping * torch.eye(6, device=JtJ.device)
    return torch.linalg.solve_ex(JtJ, -Jtr)[0]


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _point_to_plane_step(source, target, max_dist):
    """The plain step of :func:`icp_point_to_plane`: T -> (T', rmse at
    T)."""

    def step(T):
        moved, idx, _, w = _correspondences(
            T, source.points, source.valid, target.points, target.valid,
            max_dist)
        q = target.points[idx]
        n = target.normals[idx]
        r = (n * (moved - q)).sum(dim=-1)
        # d r / d xi rows: [ (p' x n), n ]
        A = torch.cat([_cross(moved, n), n], dim=-1)
        xi = _gauss_newton_step(A, r, w)
        T_new = _matmul4(_se3_exp(xi), T)
        n_in = torch.clamp(w.sum(), min=1.0)
        return T_new, torch.sqrt((w * r * r).sum() / n_in)

    return step


def _run(kind, step, source, target, max_dist, init, max_iteration,
         relative_rmse, **colored):
    """A point-to-plane or colored solve through ``ops/kernels/icp_step``:
    its plain ``step`` on the CPU, the kernel pair on the card."""
    T0 = _init(init, source.points.device)
    solve = icp_solve(kind, source, target, T0, max_dist, relative_rmse,
                      step, lambda T: _final(T, source, target, max_dist),
                      **colored)
    _solve(icp_step, solve, max_iteration)
    return ICPResult(*icp_result(solve))


@spanned("icp.point_to_plane")
def icp_point_to_plane(
    source: PointCloud,
    target: PointCloud,  # must carry normals
    max_correspondence_distance: float,
    init: torch.Tensor | None = None,
    max_iteration: int = 30,
    relative_rmse: float = 1e-6,
):
    """Point-to-plane ICP: minimizes sum w (n_q . (T p - q))^2 by
    Gauss-Newton on the se3 twist."""
    return _run(POINT_TO_PLANE, _point_to_plane_step(
        source, target, max_correspondence_distance), source, target,
        max_correspondence_distance, init, max_iteration, relative_rmse)


def _intensity(colors):
    return colors.mean(dim=-1)


def color_gradients(cloud: PointCloud, k_gradient: int = 10):
    """Per-point tangent-plane intensity gradients for colored ICP
    (Park et al. 2017, eq. 10-12): least-squares fit of d s.t.
    c(q_j) ~ c(q) + d . (proj(q_j) - q) over the k-NN, with d constrained
    to the tangent plane (d . n = 0 appended as an equation)."""
    _, idx = knn(cloud.points, cloud.points, k_gradient + 1,
                 valid=cloud.valid)
    idx = idx[:, 1:]
    q = cloud.points  # (N, 3)
    n = cloud.normals
    c = _intensity(cloud.colors)
    qj = cloud.points[idx]  # (N, k, 3)
    cj = c[idx]  # (N, k)
    # project neighbors onto each tangent plane
    dq = qj - q[:, None, :]
    dist_n = (dq * n[:, None, :]).sum(dim=-1, keepdim=True)
    proj = dq - dist_n * n[:, None, :]  # (N, k, 3)
    rhs = cj - c[:, None]  # (N, k)
    # append the constraint row n . d = 0
    A = torch.cat([proj, n[:, None, :]], dim=1)  # (N, k+1, 3)
    b = torch.cat([rhs, torch.zeros_like(c[:, None])], dim=1)
    AtA = (A[..., :, None] * A[..., None, :]).sum(dim=1) + 1e-6 * torch.eye(
        3, device=A.device)
    Atb = (A * b[..., None]).sum(dim=1)
    return torch.linalg.solve_ex(AtA, Atb[..., None])[0][..., 0]  # (N, 3)


def _colored_step(source, target, target_gradients, max_dist,
                  lambda_geometric):
    """The plain step of :func:`colored_icp`: T -> (T', rmse at T). Its
    constants are made at its first step, so a solve that never takes it
    (the card's) makes none."""

    @functools.cache
    def constants():
        lg = torch.tensor(lambda_geometric, dtype=torch.float32,
                          device=source.points.device)
        return (lg, torch.sqrt(lg), torch.sqrt(1.0 - lg),
                _intensity(source.colors), _intensity(target.colors))

    def step(T):
        lg, sqrt_lg, sqrt_lc, c_src, c_tgt = constants()
        moved, idx, _, w = _correspondences(
            T, source.points, source.valid, target.points, target.valid,
            max_dist)
        q = target.points[idx]
        n = target.normals[idx]
        grad = target_gradients[idx]
        cq = c_tgt[idx]

        # geometric residual rows
        r_g = (n * (moved - q)).sum(dim=-1)
        A_g = torch.cat([_cross(moved, n), n], dim=-1) * sqrt_lg

        # photometric residual: project p' to tangent plane at q
        dpq = moved - q
        proj = moved - (dpq * n).sum(dim=-1, keepdim=True) * n
        c_proj = cq + (grad * (proj - q)).sum(dim=-1)
        r_c = c_src - c_proj
        # d r_c / d p' = -grad_tangent (through proj; n-component dropped)
        M = grad - (grad * n).sum(dim=-1, keepdim=True) * n
        A_c = torch.cat([_cross(moved, -M), -M], dim=-1) * sqrt_lc

        A = torch.cat([A_g, A_c], dim=0)
        r = torch.cat([r_g * sqrt_lg, r_c * sqrt_lc], dim=0)
        xi = _gauss_newton_step(A, r, torch.cat([w, w], dim=0))
        T_new = _matmul4(_se3_exp(xi), T)
        n_in = torch.clamp(w.sum(), min=1.0)
        rmse = torch.sqrt(((w * r_g ** 2).sum() * lg
                           + (w * r_c ** 2).sum() * (1 - lg)) / n_in)
        return T_new, rmse

    return step


@spanned("icp.colored")
def colored_icp(
    source: PointCloud,
    target: PointCloud,  # must carry normals, colors, and gradients
    target_gradients: torch.Tensor,
    max_correspondence_distance: float,
    init: torch.Tensor | None = None,
    max_iteration: int = 50,
    lambda_geometric: float = 0.968,
    relative_rmse: float = 1e-6,
):
    """Colored point cloud registration (Park, Zhou, Koltun ICCV 2017) —
    the algorithm behind Open3D's ``registration_colored_icp`` of the
    reference's ``stitcher.py:94-103``. Joint objective:
        (1 - l) * (c_p - c_q - d_q . (proj(p') - q))^2 + l * (n_q.(p'-q))^2
    with Open3D's default lambda_geometric = 0.968.
    """
    return _run(COLORED, _colored_step(
        source, target, target_gradients, max_correspondence_distance,
        lambda_geometric), source, target, max_correspondence_distance,
        init, max_iteration, relative_rmse, gradients=target_gradients,
        lambda_geometric=lambda_geometric)
