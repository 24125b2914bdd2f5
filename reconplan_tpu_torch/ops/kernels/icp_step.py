"""K9: one Gauss-Newton step of point-to-plane and colored ICP
(``csrc/icp_step.cu``).

A solve (:class:`IcpSolve`) holds its state, the transform ``T``, the
rmse at T, ``prev`` (the rmse before it), the live steps ``iters`` and
the stop test's ``live`` flag, and what a step reads. :func:`icp_solve`
starts one; :func:`icp_step` takes one step, which changes the state only
while ``live`` holds and then looks at the stop test again;
:func:`icp_result` gives the transform, its fitness and inlier rmse, and
the iterations. For CUDA tensors the solve is one buffer: a pack launch
compacts the valid targets and sources once, a step is two launches with
no host read (counted in ``kernel.icp_step``), and the result two more.
For CPU tensors each is the plain version: the plain step that
``ops/icp`` hands over (its neighbour search is ``ops/nn``'s, a layer
above this one) and ``ops/icp._solve``'s update around it, unchanged,
so every CPU solve keeps its bits. It replaces no TPU kernel: the JAX
solves are plain XLA.
"""

from __future__ import annotations

import torch

from reconplan_tpu_torch.ops.kernels.build import (
    FLT,
    INT,
    PTR,
    check_launch,
    check_tensor,
    entry,
    takes_plain,
)
from reconplan_tpu_torch.utils.profiling import count

# the solve's kind, the kernels' template argument; _RESULT is the match
# summed for the result
POINT_TO_PLANE, COLORED, _RESULT = 0, 1, 2
# kSourcesPerBlock, kStateWords and kPartialWords of csrc/icp_step.cu
SOURCES_PER_BLOCK = 32
STATE_WORDS = 32
PARTIAL_WORDS = 32
# the state's words: T (16), rmse, prev, iters (i32), live (i32); the
# result's fitness and inlier rmse
_RMSE, _PREV, _ITERS, _LIVE, _FITNESS, _INLIER_RMSE = 16, 17, 18, 19, 22, 23


class IcpSolve:
    """One solve's state (``T`` (4, 4), ``rmse``, ``prev``, ``iters``
    int32, ``live`` bool on the CPU and int32 0 or 1 on the card) and what
    a step reads. Plain, each state tensor is replaced every step; on the
    card they are views of the kernels' buffer, which a step updates in
    place."""

    __slots__ = ("T", "rmse", "prev", "iters", "live", "relative_rmse",
                 "plain_step", "plain_result", "kind", "buf", "launch",
                 "operands")


def _still_live(live, prev, rmse, relative_rmse):
    """``ops/icp._solve``'s stop test: the rmse still moves by more than
    ``relative_rmse`` of itself."""
    return live & ((prev - rmse).abs()
                   > relative_rmse * torch.clamp(rmse, min=1e-12))


def plain_solve(T0, relative_rmse, plain_step, plain_result):
    """The plain version's start of a solve at ``T0`` on its device:
    ``_solve``'s finite sentinels (with inf the first stop test would read
    inf > inf and the solve would never start) and the stop test's first
    verdict. ``plain_step(T)`` returns (T', rmse at T);
    ``plain_result(T)`` (fitness, inlier rmse)."""
    dev = T0.device
    s = IcpSolve()
    s.T = T0
    s.rmse = torch.tensor(1e30, device=dev)
    s.prev = torch.tensor(0.0, device=dev)
    s.iters = torch.zeros((), dtype=torch.int32, device=dev)
    s.live = _still_live(torch.ones((), dtype=torch.bool, device=dev),
                         s.prev, s.rmse, relative_rmse)
    s.relative_rmse = relative_rmse
    s.plain_step, s.plain_result = plain_step, plain_result
    s.kind = s.buf = s.launch = s.operands = None
    return s


def _operand(name, t, shape, device):
    """``t`` as the kernels read it: contiguous, of ``shape`` and f32
    (bool for a validity mask) on ``device``; raise otherwise."""
    dtype = torch.bool if len(shape) == 1 else torch.float32
    t = t.contiguous()
    check_tensor(name, t, dtype, shape, device)
    return t


def icp_solve(kind, source, target, T0, max_dist, relative_rmse,
              plain_step, plain_result, gradients=None,
              lambda_geometric=1.0):
    """A solve of ``kind`` (:data:`POINT_TO_PLANE` or :data:`COLORED`)
    from ``source`` to ``target`` (point clouds with ``points``,
    ``valid``, and ``normals``; colored: ``colors`` on both, and the
    target's intensity ``gradients``) at ``T0`` (4, 4). CPU tensors start
    :func:`plain_solve`; CUDA tensors allocate the solve's buffer and pack
    it in one launch; other devices raise."""
    if kind not in (POINT_TO_PLANE, COLORED):
        raise ValueError(f"icp_step: unknown kind {kind}")
    dev = T0.device
    N, M = source.points.shape[0], target.points.shape[0]
    if N < 1 or M < 1:
        raise ValueError(f"icp_step: needs a source and a target slot, got "
                         f"{N} and {M}")
    ops = [_operand("T0", T0, (4, 4), dev),
           _operand("source.points", source.points, (N, 3), dev),
           _operand("source.valid", source.valid, (N,), dev),
           _operand("target.points", target.points, (M, 3), dev),
           _operand("target.valid", target.valid, (M,), dev),
           _operand("target.normals", target.normals, (M, 3), dev)]
    if kind == COLORED:
        ops += [_operand("source.colors", source.colors, (N, 3), dev),
                _operand("target.colors", target.colors, (M, 3), dev),
                _operand("gradients", gradients, (M, 3), dev)]
    if takes_plain("icp_step", dev):
        return plain_solve(T0, relative_rmse, plain_step, plain_result)
    T0, src_pts, src_valid, tgt_pts, tgt_valid, tgt_nrm, *colored = ops
    blocks = -(-N // SOURCES_PER_BLOCK)
    buf = torch.empty(STATE_WORDS + 4 * M + N + PARTIAL_WORDS * blocks,
                      dtype=torch.float32, device=dev)
    err = entry("icp_pack_launch", (PTR,) * 5 + (INT, INT, FLT, PTR))(
        buf.data_ptr(), src_valid.data_ptr(), tgt_pts.data_ptr(),
        tgt_valid.data_ptr(), T0.data_ptr(), N, M, relative_rmse,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch("icp_pack_launch", err)
    src_cols, tgt_cols, grads = (t.data_ptr() for t in colored) if colored \
        else (None, None, None)
    s = IcpSolve()
    ints = buf.view(torch.int32)
    s.T, s.rmse, s.prev = buf[:16].view(4, 4), buf[_RMSE], buf[_PREV]
    s.iters, s.live = ints[_ITERS], ints[_LIVE]
    s.relative_rmse = relative_rmse
    s.plain_step, s.plain_result = plain_step, plain_result
    s.kind, s.buf = kind, buf
    s.launch = (buf.data_ptr(), src_pts.data_ptr(), src_cols,
                tgt_pts.data_ptr(), tgt_nrm.data_ptr(), tgt_cols, grads, N,
                M, max_dist, lambda_geometric, relative_rmse)
    s.operands = ops  # the launches read them
    return s


def _launch(kind, solve):
    dev = solve.buf.device
    err = entry("icp_step_launch", (INT,) + (PTR,) * 7 + (INT, INT)
                + (FLT,) * 3 + (PTR,))(
        kind, *solve.launch, torch.cuda.current_stream(dev).cuda_stream)
    check_launch("icp_step_launch", err)


def icp_step_reference(solve):
    """The plain version of a step: the plain step at ``solve.T`` and
    ``ops/icp._solve``'s update, which takes it only while ``live`` holds,
    then the stop test for the next step."""
    T_new, rmse_new = solve.plain_step(solve.T)
    live = solve.live
    solve.T = torch.where(live, T_new, solve.T)
    solve.prev = torch.where(live, solve.rmse, solve.prev)
    solve.rmse = torch.where(live, rmse_new, solve.rmse)
    solve.iters = solve.iters + live.to(torch.int32)
    solve.live = _still_live(live, solve.prev, solve.rmse,
                             solve.relative_rmse)


def icp_step(solve):
    """One step of ``solve`` (from :func:`icp_solve`): the plain version
    for CPU tensors; for CUDA tensors two launches (a call counted in
    ``kernel.icp_step``), which return at once while ``live``
    is off."""
    if takes_plain("icp_step", solve.T.device):
        icp_step_reference(solve)
        return
    _launch(solve.kind, solve)
    count("kernel.icp_step")


def icp_result_reference(solve):
    """(T, fitness, inlier rmse, iterations) of the plain version."""
    fitness, rmse = solve.plain_result(solve.T)
    return solve.T, fitness, rmse, solve.iters


def icp_result(solve):
    """(T (4, 4), fitness, inlier rmse, iterations) of ``solve`` at its
    T: the inliers over the valid source points and their point-to-point
    rmse. CUDA tensors: two launches."""
    if takes_plain("icp_step", solve.T.device):
        return icp_result_reference(solve)
    _launch(_RESULT, solve)
    return solve.T, solve.buf[_FITNESS], solve.buf[_INLIER_RMSE], solve.iters
