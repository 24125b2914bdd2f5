"""Kinematic chains on torch tensors: FK and geometric Jacobians.

Port of ``reconplan_tpu.kin.chain``. The chain is static (parents / axes /
offsets fixed when the model is built), so FK unrolls over the parent
list into a short chain of 3x3 products. Everything is batch-first: a
joint vector of shape ``(..., L)`` gives ``R (..., L, 3, 3)`` and ``t (...,
L, 3)``, so one call serves a single configuration and a batch of any
shape, with no ``vmap``.

All arithmetic is f32, and no product goes through ``torch.matmul``:
3x3 products are broadcast multiplies and sums, full f32 whatever the TF32
flags say. A truncated product costs about a millimetre of FK accuracy
over the 13-link UR10 chain.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from reconplan_tpu_torch.kin.rob_parser import RobModel
from reconplan_tpu_torch.utils.device import resolve_device


class KinematicModel(NamedTuple):
    """Device-side chain description: the ``parents`` / ``prismatic``
    tuples are static (FK unrolls over them), the geometry is tensors on
    one device."""

    parents: tuple  # (L,) int, -1 root
    prismatic: tuple  # (L,) bool
    axes: torch.Tensor  # (L, 3)
    R_parent: torch.Tensor  # (L, 3, 3)
    t_parent: torch.Tensor  # (L, 3)
    qmin: torch.Tensor  # (L,)
    qmax: torch.Tensor  # (L,)


def kinematic_model_from_numpy(parents, prismatic, axes, R_parent, t_parent,
                               qmin, qmax, device=None) -> KinematicModel:
    """A model from numpy arrays (e.g. a JAX ``KinematicModel`` taken with
    ``np.asarray`` field by field), as f32 tensors on ``device`` (default:
    the card)."""
    device = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    return KinematicModel(
        parents=tuple(int(p) for p in parents),
        prismatic=tuple(bool(p) for p in prismatic),
        axes=f32(axes), R_parent=f32(R_parent), t_parent=f32(t_parent),
        qmin=f32(qmin), qmax=f32(qmax),
    )


def model_from_rob(rob: RobModel, device=None) -> KinematicModel:
    """The chain of a parsed ``.rob`` file on ``device`` (default: the
    card). Unbounded (cyclic) joints get limits of -1e9 / 1e9."""
    return kinematic_model_from_numpy(
        rob.parents, [t == "p" for t in rob.joint_types], rob.axes,
        rob.R_parent, rob.t_parent,
        np.nan_to_num(rob.qmin, neginf=-1e9),
        np.nan_to_num(rob.qmax, posinf=1e9), device=device,
    )


@functools.lru_cache(maxsize=None)
def _index(values: tuple, device: torch.device) -> torch.Tensor:
    """An int64 index tensor on ``device``, made once per (values, device):
    the solvers index with the same static tuples every iteration."""
    return torch.tensor(values, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _flags(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.bool, device=device)


def _matmul3(A, B):
    """(..., 3, 3) @ (..., 3, 3) as a multiply and a sum over k."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(dim=-2)


def _matvec3(A, v):
    """(..., 3, 3) @ (..., 3) as a multiply and a sum over k."""
    return (A * v[..., None, :]).sum(dim=-1)


def _axis_rotation(axis, angle):
    """Rodrigues rotation about unit axes (..., 3) by ``angle`` (...):
    (..., 3, 3)."""
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c = torch.cos(angle)
    s = torch.sin(angle)
    C = 1.0 - c
    rows = torch.stack(
        [
            x * x * C + c, x * y * C - z * s, x * z * C + y * s,
            y * x * C + z * s, y * y * C + c, y * z * C - x * s,
            z * x * C - y * s, z * y * C + x * s, z * z * C + c,
        ],
        dim=-1,
    )
    return rows.reshape(rows.shape[:-1] + (3, 3))


def fk_all(model: KinematicModel, q: torch.Tensor):
    """Forward kinematics of every link.

    Args:
        model: chain description.
        q: (..., L) full joint vectors (inactive joints at their fixed
            value).

    Returns:
        (R (..., L, 3, 3), t (..., L, 3)): world rotation and origin of
        each link frame, matching Klampt's ``link.getTransform()``.
    """
    L = len(model.parents)
    prismatic = _flags(model.prismatic, q.device)
    # every link's joint transform at once: a revolute joint turns about
    # its axis, a prismatic one (angle 0: the identity) slides along it
    R_joint = _axis_rotation(model.axes, torch.where(prismatic, 0.0, q))
    t_joint = model.axes * torch.where(prismatic, q, 0.0)[..., None]
    R_local = _matmul3(model.R_parent, R_joint)
    t_local = _matvec3(model.R_parent, t_joint) + model.t_parent
    Rs = []
    ts = []
    for i in range(L):
        p = model.parents[i]
        if p < 0:
            Rs.append(R_local[..., i, :, :])
            ts.append(t_local[..., i, :])
        else:
            Rs.append(_matmul3(Rs[p], R_local[..., i, :, :]))
            ts.append(_matvec3(Rs[p], t_local[..., i, :]) + ts[p])
    return torch.stack(Rs, dim=-3), torch.stack(ts, dim=-2)


def fk_link(model: KinematicModel, q: torch.Tensor, link: int):
    """World transform of a single link (computed via full FK)."""
    R, t = fk_all(model, q)
    return R[..., link, :, :], t[..., link, :]


def _ancestors(model: KinematicModel, link: int) -> set:
    out = set()
    node = link
    while node >= 0:
        out.add(node)
        node = model.parents[node]
    return out


def jacobian_from_fk(model: KinematicModel, R, t, link: int, active: tuple):
    """:func:`geometric_jacobian` from link transforms already computed by
    :func:`fk_all` for the same joint vector."""
    dev = R.device
    ancestors = _ancestors(model, link)
    idx = _index(tuple(active), dev)
    on_path = _flags(tuple(j in ancestors for j in active), dev)[:, None]
    slides = _flags(tuple(model.prismatic[j] for j in active), dev)[:, None]
    # world axis of each active joint, and the link origin seen from it
    z = _matvec3(R[..., idx, :, :], model.axes[idx])  # (..., A, 3)
    arm = t[..., link, :][..., None, :] - t[..., idx, :]
    lin = torch.where(slides, z, torch.linalg.cross(z, arm, dim=-1))
    ang = torch.where(slides, 0.0, z)
    cols = torch.where(on_path, torch.cat([lin, ang], dim=-1), 0.0)
    return cols.transpose(-1, -2)  # (..., 6, A)


def geometric_jacobian(model: KinematicModel, q: torch.Tensor, link: int,
                       active: tuple):
    """Geometric Jacobian of ``link``'s frame w.r.t. the ``active`` joints.

    ``q`` (..., L). Returns J (..., 6, A): rows = [linear velocity; angular
    velocity], columns in ``active`` order. Joints not on the path from
    root to ``link`` contribute zero columns (their axis never moves the
    link — detected statically via the parent chain). It is the geometric
    Jacobian, not autograd's.
    """
    R, t = fk_all(model, q)
    return jacobian_from_fk(model, R, t, link, active)
