"""SE3 / quaternion math as plain functions on torch tensors.

Port of ``reconplan_tpu.core.maths``, function for function: the se3
metric, quaternion angle, SLERP, euler / quat / matrix / rotvec
conversions, angle wrapping and the weighted circular mean.

Conventions
-----------
* Quaternions are ``[x, y, z, w]`` (scipy order) and unit-norm unless noted.
* Euler sequences follow scipy: uppercase = intrinsic (rotating axes),
  lowercase = extrinsic (fixed axes). Supported: zyx/ZYX/xyz/XYZ.
* All functions broadcast over leading batch dimensions and have no
  data-dependent Python control flow, so one call serves a single value
  and a batch.
* Tensors stay on the device they came on. A function given a list or a
  numpy array instead makes an f32 tensor on ``device`` (default: the
  card, ``"cpu"`` asks for the CPU).
* No 3x3 product goes through ``torch.matmul``: they are written as
  broadcast multiplies and sums, so TF32 can never enter whatever
  ``torch.backends.cuda.matmul.allow_tf32`` says.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reconplan_tpu_torch.utils.device import resolve_device


def _tensor(x, device=None):
    """``x`` as a floating tensor: a tensor stays where it is; anything
    else becomes f32 on ``device`` (as ``jnp.asarray`` makes f32)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.float()
    return torch.as_tensor(np.asarray(x, dtype=np.float32),
                           device=resolve_device(device))


# --------------------------------------------------------------------------
# Quaternion primitives
# --------------------------------------------------------------------------


def quat_identity(dtype=torch.float32, device=None):
    """The identity rotation ``[0, 0, 0, 1]``."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype,
                        device=resolve_device(device))


def quat_normalize(q, eps=1e-12):
    """Normalize to unit length (safe at zero)."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def quat_mul(q1, q2):
    """Hamilton product; composition ``q1 * q2`` applies q2 first, then q1,
    matching ``quat_to_matrix(q1) @ quat_to_matrix(q2)``."""
    x1, y1, z1, w1 = torch.movedim(q1, -1, 0)
    x2, y2, z2, w2 = torch.movedim(q2, -1, 0)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q):
    """Conjugate (inverse for unit quaternions)."""
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) ``v`` (..., 3) by quaternion(s) ``q`` (..., 4).

    Uses the 2-cross-product form (cheaper than building the matrix).
    """
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def quat_to_matrix(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = torch.movedim(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), xyzw.

    Branch-free Shepperd's method: build all four scaled candidates and
    pick the one with the largest pivot. Equal pivots go to the first, as
    ``jnp.argmax`` does, on the CPU and on the card alike: the pick is the
    smallest index that reaches the maximum, not ``torch.argmax``.
    """
    m = m.reshape(m.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.movedim(m, -1, 0)

    # Four candidate 4-vectors (unnormalized), each proportional to the quat.
    # Candidate k is most accurate when the corresponding pivot is largest.
    qw = torch.stack([m21 - m12, m02 - m20, m10 - m01, 1 + m00 + m11 + m22], -1)
    qx = torch.stack([1 + m00 - m11 - m22, m10 + m01, m02 + m20, m21 - m12], -1)
    qy = torch.stack([m10 + m01, 1 - m00 + m11 - m22, m21 + m12, m02 - m20], -1)
    qz = torch.stack([m02 + m20, m21 + m12, 1 - m00 - m11 + m22, m10 - m01], -1)

    tw = 1 + m00 + m11 + m22
    tx = 1 + m00 - m11 - m22
    ty = 1 - m00 + m11 - m22
    tz = 1 - m00 - m11 + m22
    pivots = torch.stack([tx, ty, tz, tw], dim=-1)
    index = torch.arange(4, device=m.device)
    at_max = pivots >= pivots.amax(dim=-1, keepdim=True)
    best = torch.where(at_max, index, 3).amin(dim=-1)

    cands = torch.stack([qx, qy, qz, qw], dim=-2)  # (..., 4 candidates, 4)
    pick = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, pick)[..., 0, :]
    # candidates qx..qz are ordered (x, y, z, w) already by construction above
    return quat_normalize(q)


_AXES = {"x": 0, "y": 1, "z": 2}

# Euler convention for PROBLEM-BOUNDARY data (problem-JSON
# ``fixed_rotation`` and the ``rot_domain`` axis indexing).
#
# The original GRR code is internally inconsistent here: its conversion
# helpers default to ``seq="zyx"`` while ``get_so3_grid``'s contract says
# "fixed_rotation: defined in euler angle form (x, y, z)" and the problem
# JSONs comment the same intent. Every roadmap artifact it ships realizes
# the (x, y, z) reading: ur10/kinova ``rot_fixed`` configs put tool-z
# straight DOWN (R = Rz(pi/2) @ Rx(-pi) = [[0,1,0],[1,0,0],[0,0,-1]]), and
# planar_5 ``rot_variable`` varies the rotation about the +z plane normal.
# Under the "zyx" reading the same JSONs would point the ur10 tool
# horizontally and spin planar_5 out of its plane (only 487/8104 nodes
# IK-reachable vs the artifact's 3932). We therefore interpret
# problem-boundary euler as extrinsic (x, y, z), matching the shipped
# artifacts and the documented intent.
PROBLEM_EULER_SEQ = "xyz"


def _axis_angle_quat(axis_index, angle):
    half = 0.5 * angle
    s = torch.sin(half)
    c = torch.cos(half)
    zeros = torch.zeros_like(angle)
    comps = [zeros, zeros, zeros]
    comps[axis_index] = s
    return torch.stack(comps + [c], dim=-1)


def euler_to_quat(euler, seq="zyx", degrees=False, device=None):
    """Euler angles (..., len(seq)) -> quaternion, scipy-compatible.

    Intrinsic (uppercase): R = R_s1(a1) @ R_s2(a2) @ R_s3(a3).
    Extrinsic (lowercase): R = R_s3(a3) @ R_s2(a2) @ R_s1(a1).
    """
    euler = _tensor(euler, device)
    if degrees:
        euler = torch.deg2rad(euler)
    intrinsic = seq.isupper()
    axes = [_AXES[c] for c in seq.lower()]
    quats = [_axis_angle_quat(ax, euler[..., i]) for i, ax in enumerate(axes)]
    q = quats[0]
    for qq in quats[1:]:
        q = quat_mul(q, qq) if intrinsic else quat_mul(qq, q)
    return q


def euler_to_matrix(euler, seq="zyx", degrees=False, device=None):
    """Euler angles -> rotation matrix."""
    return quat_to_matrix(euler_to_quat(euler, seq, degrees, device))


def quat_to_euler(q, seq="zyx", degrees=False):
    """Quaternion -> euler angles for seq in {zyx, ZYX, xyz, XYZ}.

    Gimbal-lock poles resolve the free angle to match atan2 of the clamped
    matrix entries (same as scipy up to the usual pole ambiguity).
    """
    m = quat_to_matrix(q)
    intrinsic = seq.isupper()
    # extrinsic abc == intrinsic CBA with reversed angle order
    key = seq.upper() if intrinsic else seq[::-1].upper()
    if key == "ZYX":
        # intrinsic Z-Y-X (yaw, pitch, roll)
        a1 = torch.atan2(m[..., 1, 0], m[..., 0, 0])
        a2 = torch.asin(torch.clamp(-m[..., 2, 0], -1.0, 1.0))
        a3 = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    elif key == "XYZ":
        a1 = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
        a2 = torch.asin(torch.clamp(m[..., 0, 2], -1.0, 1.0))
        a3 = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    else:  # pragma: no cover - guarded by supported seqs
        raise NotImplementedError(f"euler seq {seq!r} not supported")
    if not intrinsic:
        a1, a3 = a3, a1
    angles = torch.stack([a1, a2, a3], dim=-1)
    if degrees:
        angles = torch.rad2deg(angles)
    return angles


def rotvec_to_quat(rotvec, device=None):
    """Rotation vector (axis*angle) -> quaternion."""
    rotvec = _tensor(rotvec, device)
    angle = torch.linalg.norm(rotvec, dim=-1, keepdim=True)
    half = 0.5 * angle
    # sinc-style safe division: sin(a/2)/a -> 1/2 as a -> 0
    small = angle < 1e-8
    scale = torch.where(
        small, 0.5 + angle**2 / 48.0,
        torch.sin(half) / torch.clamp(angle, min=1e-30)
    )
    xyz = rotvec * scale
    w = torch.cos(half)
    return torch.cat([xyz, w], dim=-1)


def quat_to_rotvec(q):
    """Quaternion -> rotation vector."""
    q = quat_normalize(q)
    # force w >= 0 for the short rotation
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    sin_half = torch.linalg.norm(q[..., :3], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half[..., 0], q[..., 3])[..., None]
    small = sin_half < 1e-8
    scale = torch.where(
        small, 2.0 + angle**2 / 12.0, angle / torch.clamp(sin_half, min=1e-30)
    )
    return q[..., :3] * scale


def quaternion_angle(q1, q2):
    """Arc-length distance between two rotations."""
    d = torch.sum(q1 * q2, dim=-1).abs()
    return 2.0 * torch.acos(torch.clamp(d, max=1.0))


def quaternion_close(q1, q2, eps=1e-3):
    """Whether two quaternions encode nearly the same rotation."""
    return quaternion_angle(q1, q2) < eps


def slerp(q1, q2, u):
    """Spherical linear interpolation along the shortest arc.

    ``u`` broadcasts; u=0 -> q1, u=1 -> q2 (up to sign).
    """
    q1 = quat_normalize(q1)
    q2 = quat_normalize(q2)
    dot = torch.sum(q1 * q2, dim=-1, keepdim=True)
    q2 = torch.where(dot < 0, -q2, q2)
    dot = dot.abs()
    dot = torch.clamp(dot, -1.0, 1.0)
    theta = torch.acos(dot)
    sin_theta = torch.sin(theta)
    u = torch.as_tensor(u, dtype=q1.dtype, device=q1.device)
    if u.ndim == q1.ndim - 1:
        u = u[..., None]
    # fall back to lerp when the arc is tiny
    small = sin_theta < 1e-6
    safe = torch.where(small, 1.0, sin_theta)
    w1 = torch.where(small, 1.0 - u, torch.sin((1.0 - u) * theta) / safe)
    w2 = torch.where(small, u, torch.sin(u * theta) / safe)
    return quat_normalize(w1 * q1 + w2 * q2)


def interpolate_quat(q1, q2, u):
    """SLERP under the GRR helper's name."""
    return slerp(q1, q2, u)


# --------------------------------------------------------------------------
# SE3 metric (the NN metric of the whole GRR stack)
# --------------------------------------------------------------------------


def se3_distance(point1, point2, position_weight=1.0, rotation_weight=0.3,
                 device=None):
    """Distance between workspace points, R^3 or SE3.

    ``1.0 * ||p1 - p2|| + 0.3 * (1 - |q1 . q2|)``. Points with trailing dim
    <= 3 are treated as position-only. Broadcasts over batch dims.
    """
    point1 = _tensor(point1, device)
    point2 = _tensor(point2, device)
    d_pos = torch.linalg.norm(point1[..., :3] - point2[..., :3], dim=-1)
    # either side position-only (mixed 3D targets vs posed points):
    # compare positions
    if point1.shape[-1] <= 3 or point2.shape[-1] <= 3:
        return d_pos
    d_rot = 1.0 - torch.sum(point1[..., 3:7] * point2[..., 3:7], dim=-1).abs()
    return position_weight * d_pos + rotation_weight * d_rot


se3_metric = se3_distance  # alias


# --------------------------------------------------------------------------
# Angles
# --------------------------------------------------------------------------


def wrap_to_pi(angle):
    """Wrap to [-pi, pi). ``torch.remainder`` takes the divisor's sign, as
    ``jnp.mod`` does; ``torch.fmod`` would not."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def interpolate_angle(a1, a2, u):
    """Shortest-path angle interpolation."""
    delta = wrap_to_pi(a2 - a1)
    return wrap_to_pi(a1 + u * delta)


def circular_mean(angles, weights, axis=0):
    """Weighted circular mean, the cyclic-joint branch of
    ``Robot.average``."""
    x = torch.sum(weights * torch.cos(angles), dim=axis)
    y = torch.sum(weights * torch.sin(angles), dim=axis)
    return torch.atan2(y, x)


# --------------------------------------------------------------------------
# Sampling
# --------------------------------------------------------------------------


def sample_quat(generator=None, shape=(), device=None):
    """Uniform random unit quaternion(s), via the standard 4D-Gaussian
    normalization (Marsaglia). ``generator`` is a ``torch.Generator`` on
    ``device`` (or None for the global one): the same distribution as the
    JAX function's, not the same draws."""
    g = torch.randn(tuple(shape) + (4,), generator=generator,
                    dtype=torch.float32, device=resolve_device(device))
    return quat_normalize(g)


# --------------------------------------------------------------------------
# Rigid transforms
# --------------------------------------------------------------------------


def pose_to_matrix(pos, quat):
    """(pos (...,3), quat (...,4)) -> homogeneous transform (..., 4, 4)."""
    rot = quat_to_matrix(quat)
    top = torch.cat([rot, pos[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                          device=top.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def matrix_to_pose(T):
    """Homogeneous transform (..., 4, 4) -> (pos, quat)."""
    return T[..., :3, 3], matrix_to_quat(T[..., :3, :3])


def rotate_points(R, points):
    """``points @ R^T`` for (..., 3, 3) rotations and (..., N, 3) points,
    as a broadcast multiply and a sum over the 3 terms: full f32 on every
    device, with no matmul for TF32 to enter."""
    return (points[..., :, None, :] * R[..., None, :, :]).sum(dim=-1)


def transform_points(T, points):
    """Apply (..., 4, 4) transform(s) to (..., N, 3) points, in full f32
    (see :func:`rotate_points`): a truncated product would cost about 1e-3
    of absolute error, far above the sub-mm accuracy registration and
    fusion need."""
    return rotate_points(T[..., :3, :3], points) + T[..., None, :3, 3]


def look_at_quat(eye, target, device=None):
    """Camera look-at orientation of the scan arc's poses.

    Z axis points from ``eye`` toward ``target``; the remaining axes are
    built from an arbitrary reference vector: x = normalize(cross([1,0,0]
    or [0,1,0], z)), y = cross(z, x), and the resulting matrix is
    *transposed* before use (a quirk of the original arc code, kept for
    roadmap parity). Returns the quaternion of euler ZYX (0, pitch, roll)
    of that transposed frame — i.e. with the yaw component zeroed.
    """
    eye = _tensor(eye, device).float()
    target = _tensor(target, device).float()
    z_axis = target - eye
    z_axis = z_axis / torch.linalg.norm(z_axis, dim=-1, keepdim=True)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=z_axis.dtype,
                      device=z_axis.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=z_axis.dtype,
                      device=z_axis.device)
    near_x = torch.linalg.norm(z_axis - ex, dim=-1, keepdim=True) < 1e-6
    arbit = torch.where(near_x, ey, ex)
    x_axis = _cross(arbit, z_axis)
    x_axis = x_axis / torch.linalg.norm(x_axis, dim=-1, keepdim=True)
    y_axis = _cross(z_axis, x_axis)
    rot = torch.stack([x_axis, y_axis, z_axis], dim=-2)  # column_stack(...).T
    euler = quat_to_euler(matrix_to_quat(rot), seq="ZYX")
    zeroed = torch.stack(
        [torch.zeros_like(euler[..., 0]), euler[..., 1], euler[..., 2]],
        dim=-1
    )
    return euler_to_quat(zeroed, seq="ZYX")
