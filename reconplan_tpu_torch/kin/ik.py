"""Batched damped-least-squares inverse kinematics.

Port of ``reconplan_tpu.kin.ik``. The JAX solver is a ``lax.while_loop``
under ``vmap``: every lane of the batch runs the same Levenberg-Marquardt
loop and stops changing once its own iteration count or error says so,
while the others go on. Here that is one batched Python loop with a
``live`` mask: a lane's configuration, damping, error norm and
iteration count change only while the lane is live, and the loop ends
early when no lane is (asked of the device every ``CHECK_EVERY``
iterations, not every one: the question costs a host synchronisation).
On the card each chunk of ``CHECK_EVERY`` iterations is one CUDA graph,
captured at the first solve of a problem shape (lanes padded to a power
of two) and replayed: an iteration is about 270 small kernels, which the
host would otherwise issue one by one.

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

import collections
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
from reconplan_tpu_torch.utils.profiling import count, spanned, to_host


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


@spanned("ik.solve")
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
    count("ik.calls")
    dev = init_config.device
    B = init_config.shape[0]
    err_dim = 6 if use_rotation else 3
    lam = torch.full((B,), damping, dtype=init_config.dtype, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    if dev.type == "cuda" and max_iters >= CHECK_EVERY and B:
        # the chunks of CHECK_EVERY iterations replay a CUDA graph on
        # lanes padded to a power of two (the padding repeats the last
        # lane; each lane's answer is its own)
        n = max(16, 1 << (B - 1).bit_length())
        pad = [x if n == B else torch.cat([x, x[-1:].expand(
            (n - B,) + x.shape[1:])]) for x in (target_pos, target_rot,
                                               init_config, lam, iters)]
        graph = _chunk_graph(model, tuple(active), ee_link, n, use_rotation,
                             max_iters, tolerance, q_rest, dev)
        q, e, err_norm, iters = (x[:B] for x in graph.run(*pad))
    else:
        step = _LMStep(model, tuple(active), ee_link, target_pos,
                        target_rot, q_rest, max_iters, tolerance, err_dim)
        state = step.start(init_config, lam, iters)
        for it in range(max_iters):
            if it % CHECK_EVERY == 0:
                if not bool(to_host(step.live(state).any())):
                    break
                count("ik.chunks")
            state = step(state)
        q, e, _R, _t, err_norm, _lam, iters = state

    pos_err = torch.linalg.norm(e[:, :3], dim=-1)
    rot_err = (torch.linalg.norm(e[:, 3:6], dim=-1) if use_rotation
               else torch.zeros_like(pos_err))
    return IKResult(q, err_norm < tolerance, pos_err, rot_err, iters)


class _LMStep:
    """One Levenberg-Marquardt iteration of :func:`dls_ik_batch` on a
    state (q, e, R, t, err_norm, lam, iters), with no host read: a lane
    changes only while it is live."""

    def __init__(self, model, active, ee_link, target_pos, target_rot,
                 q_rest, max_iters, tolerance, err_dim):
        dev = target_pos.device
        self.model, self.active, self.ee_link = model, active, ee_link
        self.target_pos, self.target_rot = target_pos, target_rot
        self.q_rest, self.max_iters = q_rest, max_iters
        self.tolerance, self.err_dim = tolerance, err_dim
        self.active_idx = _index(active, dev)
        self.qmin = model.qmin[self.active_idx]
        self.qmax = model.qmax[self.active_idx]
        self.eye = torch.eye(err_dim, dtype=target_pos.dtype, device=dev)

    def error_of(self, q_active):
        """The stacked error (B, err_dim) and the link transforms."""
        # a fresh full joint vector a call (``q_rest.at[idx].set``)
        q = self.q_rest.expand(q_active.shape[0], -1).index_copy(
            1, self.active_idx, q_active)
        R, t = fk_all(self.model, q)
        e = self.target_pos - t[:, self.ee_link]
        if self.err_dim == 6:
            e = torch.cat([e, _rotation_error(self.target_rot,
                                              R[:, self.ee_link])], dim=-1)
        return e, R, t

    def start(self, q, lam, iters):
        e, R, t = self.error_of(q)
        return q, e, R, t, torch.linalg.norm(e, dim=-1), lam, iters

    def live(self, state):
        return (state[6] < self.max_iters) & (state[4] >= self.tolerance)

    def __call__(self, state):
        q, e, R, t, err_norm, lam, iters = state
        live = self.live(state)
        J = jacobian_from_fk(self.model, R, t, self.ee_link,
                             self.active)[:, :self.err_dim]
        # LM step: dq = J^T (J J^T + lambda^2 I)^{-1} e
        JJt = (J[:, :, None, :] * J[:, None, :, :]).sum(dim=-1)
        A = JJt + (lam**2)[:, None, None] * self.eye
        y = torch.linalg.solve_ex(A, e[:, :, None])[0]
        dq = (J * y).sum(dim=1)
        q_try = torch.clamp(q + dq, self.qmin, self.qmax)
        e_t, R_t, t_t = self.error_of(q_try)
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
        return q, e, R, t, err_norm, lam, iters


class _ChunkGraph:
    """CHECK_EVERY iterations of :class:`_LMStep` captured in one CUDA
    graph for one problem shape, on static buffers that the replays
    advance in place. The host issues one replay a chunk instead of about
    1,500 kernels, and reads the live flag between chunks as the eager
    loop does."""

    def __init__(self, model, active, ee_link, n, use_rotation, max_iters,
                 tolerance, q_rest, dev):
        A = len(active)
        self.target_pos = torch.zeros((n, 3), device=dev)
        self.target_rot = torch.eye(3, device=dev).expand(n, 3, 3).clone()
        self.step = _LMStep(model, active, ee_link, self.target_pos,
                             self.target_rot, q_rest, max_iters, tolerance,
                             6 if use_rotation else 3)
        self.state = self.step.start(
            torch.zeros((n, A), device=dev), torch.ones(n, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev))
        self.model = model  # keeps the captured tensors alive
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up: handles, caches, memory
            self._advance()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._advance()

    def _advance(self):
        state = self.state
        for _ in range(CHECK_EVERY):
            state = self.step(state)
        for dst, src in zip(self.state, state):
            dst.copy_(src)

    def run(self, target_pos, target_rot, q, lam, iters):
        """The solve from ``q`` with damping ``lam`` and counts ``iters``:
        (q, e, err_norm, iters) on the static buffers."""
        self.target_pos.copy_(target_pos)
        self.target_rot.copy_(target_rot)
        for dst, src in zip(self.state, self.step.start(q, lam, iters)):
            dst.copy_(src)
        for _ in range(self.step.max_iters // CHECK_EVERY):
            if not bool(to_host(self.step.live(self.state).any())):
                break
            count("ik.chunks")
            self.graph.replay()
        state = self.state
        for _ in range(self.step.max_iters % CHECK_EVERY):
            if not bool(to_host(self.step.live(state).any())):
                break
            state = self.step(state)
        q, e, _R, _t, err_norm, _lam, iters = state
        return q.clone(), e.clone(), err_norm.clone(), iters.clone()


# the most chunk graphs kept, least recently used dropped first
_GRAPHS_KEPT = 32
_graphs = collections.OrderedDict()


def _chunk_graph(model, active, ee_link, n, use_rotation, max_iters,
                 tolerance, q_rest, dev):
    """The :class:`_ChunkGraph` of one problem shape, captured at first
    use. Keyed by the model's and the rest vector's identity (an entry
    holds both, so neither is freed while it is kept)."""
    key = (id(model), active, ee_link, n, use_rotation, max_iters,
           tolerance, id(q_rest), str(dev))
    graph = _graphs.pop(key, None)
    if graph is None:
        count("ik.graph_captures")
        graph = _ChunkGraph(model, active, ee_link, n, use_rotation,
                            max_iters, tolerance, q_rest, dev)
        graph.q_rest = q_rest
    _graphs[key] = graph
    while len(_graphs) > _GRAPHS_KEPT:
        _graphs.popitem(last=False)
    return graph


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
