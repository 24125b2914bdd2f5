"""Batched damped-least-squares inverse kinematics.

Port of ``reconplan_tpu.kin.ik``. The JAX solver is a ``lax.while_loop``
under ``vmap``: every lane of the batch runs the same Levenberg-Marquardt
loop and stops changing once its own iteration count or error says so,
while the others go on. Here that is one batched Python loop with a
``live`` mask: a lane's configuration, damping, error norm and
iteration count change only while the lane is live, and the loop ends
early when no lane is (asked of the device every ``CHECK_EVERY``
iterations, not every one: the question costs a host synchronisation).

Semantics kept from Klampt's solver, as in the JAX package:
  * ``max_iters``/``tolerance`` knobs with the same defaults (100, 1e-3).
  * joint limits clamped every step; cyclic joints are unbounded (limits
    of -1e9 / 1e9) and the caller wraps them to [-pi, pi) afterwards.
  * pose targets are position + full rotation; ``use_rotation=False``
    gives the position-only ("free") objective.

The 6x6 (or 3x3) normal equations go to ``torch.linalg.solve_ex``: a
numerically singular system then yields inf or NaN as
``jnp.linalg.solve`` does, the NaN fails the accept test and the step is
rejected; ``torch.linalg.solve`` would raise on the CPU instead. All
arithmetic is f32, and the small products are multiplies and sums, so no
TF32 enters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.kin.chain import (
    KinematicModel,
    _index,
    _matmul3,
    fk_all,
    jacobian_from_fk,
)


# iterations between two looks at whether any lane is still active
CHECK_EVERY = 4


class IKResult(NamedTuple):
    config: torch.Tensor  # (..., A) solution in active-joint coordinates
    success: torch.Tensor  # (...,) bool
    pos_err: torch.Tensor  # (...,) final position error norm
    rot_err: torch.Tensor  # (...,) final rotation error (rotvec norm, rad)
    iters: torch.Tensor  # (...,) iterations used


def _rotation_error(R_target, R_current):
    """Rotation error as a world-frame rotation vector (R_t @ R_c^T)."""
    R_err = _matmul3(R_target, R_current.transpose(-1, -2))
    return maths.quat_to_rotvec(maths.matrix_to_quat(R_err))


def dls_ik_batch(
    model: KinematicModel,
    active: tuple,
    ee_link: int,
    target_pos: torch.Tensor,  # (B, 3)
    target_rot: torch.Tensor,  # (B, 3, 3)
    init_config: torch.Tensor,  # (B, A)
    q_rest: torch.Tensor,  # (L,)
    max_iters: int = 100,
    tolerance: float = 1e-3,
    use_rotation: bool = True,
    damping: float = 0.1,
) -> IKResult:
    """Solve B IK problems with Levenberg-Marquardt damped least squares —
    the workhorse of roadmap construction: a whole frontier of targets
    solves in one batch.

    A fixed-damping DLS without step control converges far less often
    from distant seeds than Klampt's Newton-Raphson with its line search.
    This uses the standard LM accept/reject scheme: try a step at the
    current damping; accept and soften the damping if the error norm
    drops, otherwise keep the old iterate and stiffen. The error and link
    transforms of the current iterate are carried from the accepted try,
    so an iteration costs one FK.

    Args:
        model: kinematic chain.
        active: static tuple of active joint indices.
        ee_link: end-effector link index.
        target_pos: (B, 3) target positions.
        target_rot: (B, 3, 3) target rotation matrices (ignored when
            ``use_rotation=False``).
        init_config: (B, A) initial active-joint configurations.
        q_rest: (L,) full joint vector holding inactive joints' values.
        max_iters / tolerance: Klampt-compatible stop criteria — success
            when the stacked error norm falls below ``tolerance``.
        use_rotation: include the rotation rows of the Jacobian.
        damping: initial Levenberg damping (adapted per step in
            [1e-4, 1e3]).

    Returns: IKResult of (B, ...) tensors on the inputs' device.
    """
    dev = init_config.device
    B = init_config.shape[0]
    active_idx = _index(tuple(active), dev)
    qmin = model.qmin[active_idx]
    qmax = model.qmax[active_idx]
    err_dim = 6 if use_rotation else 3
    eye = torch.eye(err_dim, dtype=init_config.dtype, device=dev)

    def error_of(q_active):
        """The stacked error (B, err_dim) and the link transforms."""
        # a fresh full joint vector a call (``q_rest.at[idx].set``)
        q = q_rest.expand(B, -1).index_copy(1, active_idx, q_active)
        R, t = fk_all(model, q)
        e = target_pos - t[:, ee_link]
        if use_rotation:
            e = torch.cat([e, _rotation_error(target_rot, R[:, ee_link])],
                          dim=-1)
        return e, R, t

    q = init_config
    e, R, t = error_of(q)
    err_norm = torch.linalg.norm(e, dim=-1)
    lam = torch.full((B,), damping, dtype=q.dtype, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for step in range(max_iters):
        live = (iters < max_iters) & (err_norm >= tolerance)
        if step % CHECK_EVERY == 0 and not bool(live.any()):
            break
        J = jacobian_from_fk(model, R, t, ee_link, active)[:, :err_dim]
        # LM step: dq = J^T (J J^T + lambda^2 I)^{-1} e
        JJt = (J[:, :, None, :] * J[:, None, :, :]).sum(dim=-1)
        A = JJt + (lam**2)[:, None, None] * eye
        y = torch.linalg.solve_ex(A, e[:, :, None])[0]
        dq = (J * y).sum(dim=1)
        q_try = torch.clamp(q + dq, qmin, qmax)
        e_t, R_t, t_t = error_of(q_try)
        e_try = torch.linalg.norm(e_t, dim=-1)
        accept = live & (e_try < err_norm)  # a NaN error is never accepted
        q = torch.where(accept[:, None], q_try, q)
        e = torch.where(accept[:, None], e_t, e)
        R = torch.where(accept[:, None, None, None], R_t, R)
        t = torch.where(accept[:, None, None], t_t, t)
        lam_next = torch.where(accept, torch.clamp(lam * 0.5, min=1e-4),
                               torch.clamp(lam * 4.0, max=1e3))
        lam = torch.where(live, lam_next, lam)
        err_norm = torch.where(accept, e_try, err_norm)
        iters = iters + live.to(torch.int32)

    pos_err = torch.linalg.norm(e[:, :3], dim=-1)
    rot_err = (torch.linalg.norm(e[:, 3:6], dim=-1) if use_rotation
               else torch.zeros_like(pos_err))
    return IKResult(q, err_norm < tolerance, pos_err, rot_err, iters)


def dls_ik(
    model: KinematicModel,
    active: tuple,
    ee_link: int,
    target_pos: torch.Tensor,
    target_rot: torch.Tensor,
    init_config: torch.Tensor,
    q_rest: torch.Tensor,
    max_iters: int = 100,
    tolerance: float = 1e-3,
    use_rotation: bool = True,
    damping: float = 0.1,
) -> IKResult:
    """Solve one IK problem: :func:`dls_ik_batch` on a batch of one, with
    ``target_pos`` (3,), ``target_rot`` (3, 3) and ``init_config`` (A,).
    Returns an IKResult of scalars / vectors."""
    res = dls_ik_batch(
        model, active, ee_link, target_pos[None], target_rot[None],
        init_config[None], q_rest, max_iters=max_iters, tolerance=tolerance,
        use_rotation=use_rotation, damping=damping)
    return IKResult(*(x[0] for x in res))
