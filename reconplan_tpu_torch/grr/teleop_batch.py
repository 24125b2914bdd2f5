"""Device-batched teleop trajectory-quality benchmark engine.

Port of ``reconplan_tpu.grr.teleop_batch``. The reference's headline
experiment (``Expansion-GRR/experiment/trajectory_quality.py:147-199``)
tracks each trajectory tick by tick in a host loop. Here ALL N
trajectories of a kind advance one tick per batched step (the
``solve_batch`` pattern of ``resolution.py`` applied ACROSS trajectories
instead of along one path):

  * one batched tracking solve per tick (roadmap SE3 top-k -> joint-space
    closest seeds -> LM-IK -> floor/collision validity), mirroring
    ``resolution.solve`` tracking mode (``resolution.py:299-330``);
  * one batched fixed-depth bisection continuity check per tick;
  * the teleop fallback state machines — roadmap path-following on
    discontinuity and the nearest-node rescue on solve failure
    (``resolution.py:171-213``) — stay host-side per trajectory, but their
    continuity primitives batch over whichever trajectories need them.

Solver-arm semantics are the reference's, quirks included:
  * every arm cold-starts from ``resolution.solve(traj[0])`` and is marked
    failed outright when start OR end has no resolution solution
    (``trajectory_quality.py:72-80``);
  * the Newton arm steps toward the raw IK result whether or not it
    converged (``trajectory_quality.py:40-44``);
  * exactly ``converge_steps`` extra ticks at the goal, no early exit
    (``trajectory_quality.py:48-56``).

Where the JAX package jits a tick, scans a block of ticks or the whole
arm (``lax.scan``), the port runs torch ops on the roadmap's device in a
host loop over the ticks, with the state on the device. Configurations
are f32 on the device wherever the JAX package (without x64) makes them
f32. Batches are not padded to powers of two: PyTorch does not compile
per shape, and every lane of a batch is independent of the others.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.grr.solver import (
    _interp_config_batch,
    _interp_point_batch,
)
from reconplan_tpu_torch.kin.ik import dls_ik_batch
from reconplan_tpu_torch.ops.nn import _smallest, se3_pairwise
from reconplan_tpu_torch.utils.device import robot_device, scalar_tensor


# ---------------------------------------------------------------------------
# batched per-tick primitives
# ---------------------------------------------------------------------------


def _targets(robot, targets, dim=None):
    """(N, D) workspace targets as f32 on the robot's device, quaternions
    normalised when ``dim`` (default: the targets' width) exceeds 3."""
    pts = robot._tensor(targets)
    if (pts.shape[1] if dim is None else dim) > 3:
        pts = torch.cat([pts[:, :3], pts[:, 3:7] / torch.linalg.norm(
            pts[:, 3:7], dim=-1, keepdim=True)], dim=-1)
    return pts


def _ik_valid(robot, pts, seeds, max_iters, tolerance):
    """IK of (B, D) points from (B, A) seeds: wrapped configs and
    converged & valid flags."""
    pos, rotm, use_rot = robot._ik_targets(pts)
    res = dls_ik_batch(
        robot.model, robot._active_tuple, robot.ee_link,
        pos, rotm, seeds, robot._q_rest,
        max_iters=max_iters, tolerance=tolerance, use_rotation=use_rot,
    )
    q = torch.where(robot._cyclic_mask, maths.wrap_to_pi(res.config),
                    res.config)
    return q, res.success & robot._validate_batch(q)


def _roadmap_seeds(resolution, pts, qs, k, j):
    """The ``j`` joint-closest of the ``k`` SE3-nearest roadmap configs of
    each target: (N, j, A). Ties rank by index, as ``lax.top_k``."""
    road_pts = resolution.points_t
    qpts = pts[:, :3] if road_pts.shape[1] == 3 else pts
    idx = _smallest(se3_pairwise(qpts, road_pts), k)
    cfgs = resolution.configs_t[idx]  # (N, k, A)
    jd = resolution.robot.distance_batch(qs[:, None, :], cfgs)
    sidx = _smallest(jd, j)
    return torch.gather(cfgs, 1, sidx[:, :, None].expand(-1, -1,
                                                          cfgs.shape[2]))


def _best_of(robot, qs, q_j, ok_j):
    """Among converged+valid restarts (N, j, A), the one of least joint
    motion from ``qs`` (the first of equals): (q (N, A), ok (N,))."""
    dq_j = torch.where(ok_j, robot.distance_batch(qs[:, None, :], q_j),
                       torch.inf)
    best = torch.argmin(dq_j, dim=1)
    rows = torch.arange(q_j.shape[0], device=q_j.device)
    return q_j[rows, best], ok_j[rows, best]


def make_tracking_solver(resolution, max_iters=100, tolerance=1e-3,
                         n_seeds=4):
    """``(targets (N, D), qs (N, A)) -> (q (N, A), ok (N,))``
    implementing :meth:`RedundancyResolution.solve` tracking mode for N
    independent trajectories in one batch.

    Multi-seed divergence as in :meth:`RedundancyResolution.solve_batch`:
    the ``n_seeds`` joint-closest roadmap configs run as parallel IK
    restarts and the valid result with minimal joint motion wins."""
    robot = resolution.robot
    k = min(resolution.workspace.interpolate_num_neighbors,
            len(resolution.points))
    j = max(1, min(n_seeds, k))

    def solve_many(targets, qs):
        pts = _targets(robot, targets)
        qs = robot._tensor(qs)
        N, A = qs.shape
        seeds = _roadmap_seeds(resolution, pts, qs, k, j)
        q, ok = _ik_valid(robot, pts.repeat_interleave(j, dim=0),
                          seeds.reshape(N * j, A), max_iters, tolerance)
        return _best_of(robot, qs, q.reshape(N, j, A), ok.reshape(N, j))

    return solve_many


def make_grr_tick(resolution, target_dim, max_iters=100, tolerance=1e-3,
                  greedy_seed=False):
    """ONE batched GRR teleop tick.

    ``greedy_seed=True`` adds the CURRENT config as one more IK restart
    alongside the roadmap seeds (reference GRR seeds from the roadmap
    only, ``resolution.py:299-330``; a documented divergence of the JAX
    package for its DTW-gap experiment).

    The tracking solve, the FK of the current configs, and an inline
    fixed-depth-3 bisection continuity check (config distance <= 7*eps ~
    0.86 rad) in one function. Rows whose config distance needs a deeper
    subdivision come back flagged ``deep`` and re-check through the full
    :meth:`ExpansionSolver.is_continuous_batch` on host. Every level's IK
    runs on every row, as in the JAX package; a row's flags read only the
    levels its depth asks for.

    Returns ``tick(targets (N, D), qs (N, A)) ->
    (q_t, ok, curr_pts (N, target_dim), cont, deep)``, tensors on the
    roadmap's device.
    """
    robot = resolution.robot
    dev = resolution.device
    k = min(resolution.workspace.interpolate_num_neighbors,
            len(resolution.points))
    eps = scalar_tensor(float(np.sqrt(robot.num_joints) * 5e-2), dev)
    deviation = 1.8  # solver.py:317
    cyc = robot._cyclic_mask
    u_l0 = torch.tensor([0.5], device=dev)
    u_l1 = torch.tensor([0.25, 0.75], device=dev)
    u_l2 = torch.tensor([0.125, 0.375, 0.625, 0.875], device=dev)

    def _ik(pts, seeds):
        return _ik_valid(robot, pts, seeds, max_iters, tolerance)

    def _level_ok(qa, qb, qm, valid):
        ds = robot.distance_batch(qa, qb)
        return (valid & (robot.distance_batch(qa, qm) <= deviation * ds)
                & (robot.distance_batch(qm, qb) <= deviation * ds))

    def tick(targets, qs):
        pts = _targets(robot, targets, target_dim)
        qs32 = robot._tensor(qs)
        N, A = qs32.shape

        # tracking solve (resolution.py:299-330), multi-seed restarts as
        # in RedundancyResolution.solve_batch
        j = max(1, min(4, k))
        seeds = _roadmap_seeds(resolution, pts, qs32, k, j)
        if greedy_seed:
            seeds = torch.cat([qs32[:, None, :], seeds], dim=1)
            j = j + 1
        q_j, ok_j = _ik(pts.repeat_interleave(j, dim=0),
                        seeds.reshape(N * j, A))
        q_t, ok = _best_of(robot, qs32, q_j.reshape(N, j, A),
                           ok_j.reshape(N, j))

        # current workspace points
        curr_pts = robot.fk_point_batch(qs32)[:, :target_dim]
        tgt = pts[:, :target_dim]

        # inline continuity, S=4 segments (solver.py:304-363 semantics)
        dist = robot.distance_batch(qs32, q_t)
        n_divs = torch.ceil(dist / eps).to(torch.int32)
        depth = torch.ceil(torch.log2(torch.clamp(
            n_divs + 1, min=1).to(torch.float32))).to(torch.int32)
        deep = depth > 3

        Q0, Q4 = qs32, q_t
        # level 0: midpoint at u=0.5
        seeds0 = _interp_config_batch(Q0, Q4, 0.5, cyc)
        t0 = _interp_point_batch(curr_pts, tgt, u_l0)[:, 0]
        qm2, v2 = _ik(t0, seeds0)
        cont = ~(depth > 0) | _level_ok(Q0, Q4, qm2, v2)

        # level 1: midpoints at u=0.25, 0.75
        qa = torch.stack([Q0, qm2], dim=1)  # (N, 2, A)
        qb = torch.stack([qm2, Q4], dim=1)
        seeds1 = _interp_config_batch(qa, qb, 0.5, cyc)
        t1 = _interp_point_batch(curr_pts, tgt, u_l1)
        qm13, v13 = _ik(t1.reshape(N * 2, -1), seeds1.reshape(N * 2, A))
        qm13 = qm13.reshape(N, 2, A)
        ok1 = _level_ok(qa, qb, qm13, v13.reshape(N, 2)).all(dim=1)
        cont = cont & (~(depth > 1) | ok1)

        # level 2: midpoints of the four level-1 segments
        # (u = 0.125, 0.375, 0.625, 0.875)
        qa2 = torch.stack([Q0, qm13[:, 0], qm2, qm13[:, 1]], dim=1)
        qb2 = torch.stack([qm13[:, 0], qm2, qm13[:, 1], Q4], dim=1)
        seeds2 = _interp_config_batch(qa2, qb2, 0.5, cyc)
        t2 = _interp_point_batch(curr_pts, tgt, u_l2)
        qm2l, v2l = _ik(t2.reshape(N * 4, -1), seeds2.reshape(N * 4, A))
        ok2 = _level_ok(qa2, qb2, qm2l.reshape(N, 4, A),
                        v2l.reshape(N, 4)).all(dim=1)
        cont = cont & (~(depth > 2) | ok2)

        return q_t, ok, curr_pts, cont, deep

    return tick


def make_plan_helper(resolution, max_iters=100, tolerance=1e-3):
    """Batched ``resolution.plan(..., interpolation=1)`` for the teleop
    discontinuity fallback (``resolution.py:435-517``).

    The 2x4x8 entry-feasibility solves run as ONE roadmap-seeded IK
    batch, the shortest path comes from the native Dijkstra, and the
    interpolation=1 segment re-solves collapse to the roadmap configs
    themselves (solve() at a roadmap node is the exact-node match,
    ``resolution.py:313-318``). Divergence kept from the JAX package:
    entry feasibility seeds IK from the nearest roadmap config instead of
    the reference's recursive cold solve.

    Returns ``plan_fast(curr_pt, target_pt, q_goal)``; the GRR engine
    plans all of a tick's rows at once through :func:`_plan_many`."""
    plan_many = _plan_many(resolution, max_iters, tolerance)

    def plan_fast(curr_pt, target_pt, q_goal):
        """-> (T, A) config path [q(curr), roadmap configs..., q_goal] or
        None when no feasible entry/path exists."""
        return plan_many([curr_pt], [target_pt], [q_goal])[0]

    return plan_fast


def _plan_many(resolution, max_iters=100, tolerance=1e-3):
    """``plan_many(curr_pts (R, D), target_pts (R, D), q_goals (R, A))``:
    the plan of :func:`make_plan_helper` for R rows, their 2 x 4 x 8
    entry-feasibility solves in one IK batch (each row's lanes are its
    own, so a row's plan is what it would be alone)."""
    robot = resolution.robot
    n_div = 8  # resolution.py:448-474 num_div
    k_entry = min(4, len(resolution.points))

    def solve_points(pts):
        road_pts = resolution.points_t
        qpts = pts[:, :3] if road_pts.shape[1] == 3 else pts
        d = se3_pairwise(qpts, road_pts)
        seeds = resolution.configs_t[torch.argmin(d, dim=1)]
        return _ik_valid(robot, pts, seeds, max_iters, tolerance)

    def plan_many(curr_pts, target_pts, q_goals):
        R = len(curr_pts)
        pts2 = np.stack([np.asarray(curr_pts, dtype=np.float32),
                         np.asarray(target_pts, dtype=np.float32)],
                        axis=1).reshape(2 * R, -1)  # curr, target a row
        nbrs = resolution.workspace.get_workspace_neighbors(
            pts2, k=k_entry, points=resolution.points_t
        ).reshape(2 * R, k_entry)
        # robot.workspace_interpolate(pts2[e], node, kk / n_div) of every
        # endpoint e, neighbour node and step kk, in one batch
        subs = _interpolate_points(
            robot, np.repeat(pts2, k_entry * n_div, axis=0),
            np.repeat(resolution.points[nbrs.reshape(-1)], n_div, axis=0),
            np.tile(np.arange(n_div) / n_div, 2 * R * k_entry))
        _q, ok = solve_points(subs)
        ok = ok.cpu().numpy().reshape(R, 2, k_entry, n_div)
        nbrs = nbrs.reshape(R, 2, k_entry)
        paths = []
        for r in range(R):
            entry = [None, None]
            for e in range(2):
                for c in range(k_entry):
                    if ok[r, e, c].all():
                        entry[e] = int(nbrs[r, e, c])
                        break
            path = (None if entry[0] is None or entry[1] is None
                    else resolution._dijkstra(entry[0], entry[1]))
            if path is None:
                paths.append(None)
                continue
            c_path = [resolution.configs[p].astype(np.float64) for p in path]
            c_path.append(np.asarray(q_goals[r], dtype=np.float64))
            paths.append(np.asarray(c_path))
        return paths

    return plan_many


def _interpolate_points(robot, p1, p2, u):
    """``robot.workspace_interpolate`` of each row of ``p1`` (B, D1)
    toward ``p2`` (B, D2) by ``u`` (B,), in one batch on the robot's
    device: positions lerp, quaternions slerp, and where one side is
    position-only the other side's quaternion rides along."""
    p1, p2 = robot._tensor(p1), robot._tensor(p2)
    u = robot._tensor(u)
    pos = p1[:, :3] + u[:, None] * (p2[:, :3] - p1[:, :3])
    if p1.shape[1] > 3 and p2.shape[1] > 3:
        quat = maths.slerp(p1[:, 3:7], p2[:, 3:7], u)
    elif p1.shape[1] > 3 or p2.shape[1] > 3:
        quat = (p1 if p1.shape[1] > 3 else p2)[:, 3:7]
    else:
        return pos
    return torch.cat([pos, quat], dim=-1)


def make_newton_solver(robot, max_iters=100, tolerance=1e-3):
    """Plain-IK tick: seeds from the current configs, returns the raw
    LM-IK result regardless of convergence (reference Newton-arm
    semantics)."""

    def solve_many(targets, qs):
        pos, rotm, use_rot = robot._ik_targets(targets)
        res = dls_ik_batch(
            robot.model, robot._active_tuple, robot.ee_link,
            pos, rotm, robot._tensor(qs), robot._q_rest,
            max_iters=max_iters, tolerance=tolerance, use_rotation=use_rot,
        )
        return torch.where(robot._cyclic_mask, maths.wrap_to_pi(res.config),
                           res.config)

    return solve_many


def step_toward_batch(robot, qs, targets, max_change):
    """Vectorized ``teleop_towards`` (``resolution.py:215-228``): clamped
    shortest-path step of each row toward its target config (numpy f64)."""
    qs = np.asarray(qs, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.float64)
    cyc = robot._cyclic_mask.cpu().numpy()
    diff = targets - qs
    diff = np.where(cyc, np.mod(diff + np.pi, 2 * np.pi) - np.pi, diff)
    m = np.abs(diff).max(axis=1)
    u = np.where(m < max_change, 1.0, max_change / np.maximum(m, 1e-12))
    out = qs + u[:, None] * diff
    out = np.where(cyc, np.mod(out + np.pi, 2 * np.pi) - np.pi, out)
    return out


def _fk_points_batch(robot, qs):
    """Current workspace points of a config batch, dimensioned like the
    trajectory targets (pos-only unless the robot tracks rotation)."""
    pts = robot.fk_point_batch(np.asarray(qs, dtype=np.float32))
    pts = pts.cpu().numpy()
    if robot.rotation != "variable":
        return pts[:, :3]
    return pts


# ---------------------------------------------------------------------------
# arms
# ---------------------------------------------------------------------------


def grr_teleop_batch(
    resolution, trajs, q0s, alive, max_change=0.04, converge_steps=100,
    verbose=False, greedy_seed=False,
):
    """Track N same-length trajectories with GRR teleop, ticks batched.

    The config state and the config-history buffer live on the device
    across the whole loop; each tick is one batched tick (tracking solve
    + inline continuity + smooth step + history commit) plus one packed
    readback of the per-row flags. Rows that need the teleop fallback
    state machines (roadmap plan-following / nearest-node rescue,
    ``resolution.py:171-213``) are repaired on host and written back into
    the device state.

    While the regime is smooth the engine runs blocks of 16 ticks with one
    readback; a block is accepted only when every alive row stayed smooth
    in every tick, and is otherwise replayed tick by tick from the
    pre-block state.

    Args:
        resolution: loaded RedundancyResolution.
        trajs: (N, T, D) workspace trajectories.
        q0s: (N, A) start configs (from cold resolution.solve).
        alive: (N,) bool — rows with a valid start/end resolution solution.

    Returns list of N (T_i, A) config trajectories ([] where not alive),
    plus a dict of fallback-path statistics.
    """
    robot = resolution.robot
    dev = resolution.device
    trajs = np.asarray(trajs)
    N, T, D = trajs.shape
    A = q0s.shape[1]
    total = T + converge_steps
    tick = make_grr_tick(resolution, D, greedy_seed=greedy_seed)
    plan_many = _plan_many(resolution)
    traj_seq = torch.as_tensor(np.swapaxes(trajs, 0, 1), dtype=torch.float32,
                               device=dev)

    def tick_commit(qs, hist, t):
        """One tick: solve, check, auto-step the smooth rows, write
        hist[t+1]. Rows that are NOT plainly smooth keep their config
        (host repairs them). ``qs`` is never written in place (a rejected
        block leaves the pre-block state as it was). Returns the new
        state and the packed per-row info for the host:
        [ok, cont, deep, q_t (A), curr_pts (D)] as one f32 tensor."""
        targets = traj_seq[min(t, T - 1)]
        q_t, ok, curr_pts, cont, deep = tick(targets, qs)
        smooth = ok & cont & ~deep
        stepped = _step_toward_j(robot, qs, q_t, max_change)
        qs = torch.where(smooth[:, None], stepped, qs)
        hist[t + 1] = qs
        packed = torch.cat(
            [ok[:, None].float(), cont[:, None].float(),
             deep[:, None].float(), q_t.float(), curr_pts.float()], dim=1)
        return qs, packed

    S = 16  # ticks per block (see the driver below)

    def tick_block(qs, hist, t):
        """S ticks with one readback. The host accepts the block iff every
        tick was all-smooth for the alive rows; otherwise it replays the
        block tick by tick from the pre-block ``qs`` (the rows the block
        wrote into ``hist`` are written again by the replay)."""
        packs = []
        for s in range(S):
            qs, packed = tick_commit(qs, hist, t + s)
            packs.append(packed)
        return qs, torch.stack(packs)  # packed (S, N, 3+A+D)

    # the JAX package makes f32 of the f64 start configs (no x64)
    qs_d = torch.as_tensor(np.asarray(q0s), dtype=torch.float32, device=dev)
    hist_d = torch.zeros((total + 1, N, A), dtype=torch.float32, device=dev)
    hist_d[0] = qs_d

    plan_path = [None] * N
    plan_idx = [0] * N
    stats = {"ticks": 0, "continuous": 0, "plan_follow": 0, "rescue": 0,
             "stuck": 0, "deep_recheck": 0, "blocks": 0, "block_replays": 0}
    # per-tick workspace deviation |ee - target| (position, meters),
    # attributed to the regime that handled the row that tick
    dev_sum = {c: [0.0, 0] for c in ("smooth", "plan", "rescue", "stuck")}

    def _dev_add(cls, dists):
        dev_sum[cls][0] += float(np.sum(dists))
        dev_sum[cls][1] += int(np.size(dists))

    n_alive = int(alive.sum())
    streak = S  # optimistic: try a block first
    t = 0
    t_start = time.time()
    last_beat = t_start
    while t < total:
        # wall-time heartbeat: fallback-surgery regions can take seconds
        # per tick
        if verbose and time.time() - last_beat > 30:
            last_beat = time.time()
            print(f"  [heartbeat] tick {t}/{total} "
                  f"elapsed {last_beat - t_start:.0f}s "
                  f"rescue={stats['rescue']} plan={stats['plan_follow']} "
                  f"stuck={stats['stuck']} deep={stats['deep_recheck']}",
                  flush=True)
        # ---- S-tick block when the recent regime is smooth ----
        if streak >= S and t + S <= total:
            stats["blocks"] += 1
            qs_b, packed_b = tick_block(qs_d, hist_d, t)
            packed_b = packed_b.cpu().numpy()  # (S, N, C) one readback
            okb = (packed_b[..., 0] > 0.5) & alive[None, :]
            contb = packed_b[..., 1] > 0.5
            deepb = packed_b[..., 2] > 0.5
            smoothb = okb & contb & ~deepb
            if bool((smoothb | ~alive[None, :]).all()):
                qs_d = qs_b
                stats["ticks"] += S * n_alive
                stats["continuous"] += S * n_alive
                tgt_b = trajs[:, np.minimum(np.arange(t, t + S), T - 1), :3]
                cp_b = packed_b[..., 3 + A : 3 + A + 3]  # (S, N, 3)
                _dev_add("smooth", np.linalg.norm(
                    np.swapaxes(cp_b, 0, 1)[alive] - tgt_b[alive], axis=-1
                ))
                for i in np.flatnonzero(alive):
                    plan_path[i] = None
                    plan_idx[i] = 0
                if verbose and (t // S) % 4 == 0:
                    print(f"  tick {t}/{total}  smooth {n_alive}/{n_alive} "
                          "(block)")
                t += S
                continue
            # the block had a non-smooth tick: drop it (qs_d is the
            # pre-block state) and replay per tick
            stats["block_replays"] += 1
            streak = 0

        qs_d, packed = tick_commit(qs_d, hist_d, t)
        packed = packed.cpu().numpy()  # ONE small readback per tick
        ok = packed[:, 0] > 0.5
        cont = packed[:, 1] > 0.5
        deep = packed[:, 2] > 0.5
        q_t = packed[:, 3 : 3 + A].astype(np.float64)
        curr_pts = packed[:, 3 + A :].astype(np.float64)
        ok &= alive
        smooth_auto = ok & cont & ~deep
        stats["ticks"] += int(alive.sum())
        stats["continuous"] += int(smooth_auto.sum())
        tick_dev = np.linalg.norm(
            curr_pts[:, :3] - trajs[:, min(t, T - 1), :3], axis=-1
        )
        _dev_add("smooth", tick_dev[smooth_auto])
        # rows auto-stepped on device drop any plan state
        for i in np.flatnonzero(smooth_auto):
            plan_path[i] = None
            plan_idx[i] = 0

        attention = np.flatnonzero(alive & ~smooth_auto)
        if len(attention) == 0:
            if verbose and t % 50 == 0:
                print(f"  tick {t}/{total}  smooth {int(smooth_auto.sum())}"
                      f"/{int(alive.sum())}")
            t += 1
            streak += 1
            continue
        streak = 0

        # ---- host surgery for the rows the device didn't step ----
        qs_host = qs_d.cpu().numpy().astype(np.float64)
        targets = trajs[:, min(t, T - 1)]

        cont = cont.copy()
        deep_rows = np.flatnonzero(deep & ok)
        if len(deep_rows):
            stats["deep_recheck"] += len(deep_rows)
            cont[deep_rows] = np.asarray(
                resolution.solver.is_continuous_batch(
                    qs_host[deep_rows], q_t[deep_rows],
                    curr_pts[deep_rows], targets[deep_rows],
                )
            )

        new_rows = {}
        rescue_rows = []
        plan_rows = []
        for i in attention:
            if ok[i] and cont[i]:
                # deep row re-checked continuous: take the smooth step
                plan_path[i] = None
                plan_idx[i] = 0
                new_rows[i] = step_toward_batch(
                    robot, qs_host[i][None], q_t[i][None], max_change
                )[0]
                stats["continuous"] += 1
                _dev_add("smooth", tick_dev[i])
            elif ok[i]:
                # discontinuity: follow a roadmap plan
                # (resolution.py:171-195)
                stats["plan_follow"] += 1
                _dev_add("plan", tick_dev[i])
                if plan_path[i] is None:
                    plan_rows.append(int(i))  # planned below, in one batch
                else:
                    plan_idx[i] += 1
                    if plan_idx[i] < len(plan_path[i]):
                        new_rows[i] = step_toward_batch(
                            robot, qs_host[i][None],
                            plan_path[i][plan_idx[i]][None], max_change,
                        )[0]
                    else:
                        plan_path[i] = None
                        plan_idx[i] = 0
            else:
                rescue_rows.append(int(i))

        if plan_rows:
            paths = plan_many(curr_pts[plan_rows], targets[plan_rows],
                              q_t[plan_rows])
            for i, c_path in zip(plan_rows, paths):
                if c_path is not None and len(c_path) > 1:
                    plan_path[i] = np.asarray(c_path, dtype=np.float64)
                    plan_idx[i] = 1
                    new_rows[i] = step_toward_batch(
                        robot, qs_host[i][None], plan_path[i][1][None],
                        max_change,
                    )[0]
                else:
                    stats["stuck"] += 1

        if rescue_rows:
            # solve-failure fallback: nearest 5 roadmap nodes, first whose
            # config is continuous from here (resolution.py:197-213)
            stats["rescue"] += len(rescue_rows)
            _dev_add("rescue", tick_dev[rescue_rows])
            nbrs = resolution.workspace.get_workspace_neighbors(
                targets[rescue_rows].astype(np.float32),
                k=min(5, len(resolution.points)), points=resolution.points_t,
            )  # (F, 5)
            F, K5 = nbrs.shape
            qn = resolution.configs[nbrs.reshape(-1)]  # (F*5, A)
            pn = resolution.points[nbrs.reshape(-1)]
            qrep = np.repeat(qs_host[rescue_rows], K5, axis=0)
            prep = np.repeat(curr_pts[rescue_rows], K5, axis=0)
            cont5 = np.asarray(
                resolution.solver.is_continuous_batch(qn, qrep, pn, prep)
            ).reshape(F, K5)
            for r, i in enumerate(rescue_rows):
                hit = np.flatnonzero(cont5[r])
                if len(hit):
                    new_rows[i] = step_toward_batch(
                        robot, qs_host[i][None],
                        resolution.configs[nbrs[r, hit[0]]][None].astype(
                            np.float64
                        ),
                        max_change,
                    )[0]
                else:
                    stats["stuck"] += 1

        if new_rows:
            # host-repaired rows -> device state; the tick already wrote
            # hist[t + 1], where these rows land
            idx = torch.as_tensor(np.fromiter(new_rows.keys(), np.int64),
                                  device=dev)
            vals = torch.as_tensor(np.stack(list(new_rows.values())),
                                   dtype=torch.float32, device=dev)
            qs_d = qs_d.index_copy(0, idx, vals)
            hist_d[t + 1, idx] = vals
        if verbose and t % 50 == 0:
            print(f"  tick {t}/{total}  smooth "
                  f"{int(smooth_auto.sum()) + sum(1 for i in attention if ok[i] and cont[i])}"
                  f"/{int(alive.sum())}")
        t += 1

    hist = hist_d.cpu().numpy().astype(np.float64)  # one readback at the end
    c_trajs = [
        hist[:, i] if alive[i] else np.zeros((0, A)) for i in range(N)
    ]
    stats["deviation_by_class_mm"] = {
        c: (round(1000.0 * s / n, 3) if n else None)
        for c, (s, n) in dev_sum.items()
    }
    stats["deviation_ticks"] = {c: n for c, (s, n) in dev_sum.items()}
    return c_trajs, stats


def _step_toward_j(robot, qs, targets, max_change):
    """``teleop_towards`` (``resolution.py:215-228``) on device tensors."""
    cyc = robot._cyclic_mask
    diff = targets - qs
    diff = torch.where(cyc, maths.wrap_to_pi(diff), diff)
    m = diff.abs().amax(dim=-1)
    # a 0-d tensor over m: ``scalar / tensor`` would multiply by the
    # reciprocal, which rounds twice
    u = torch.where(m < max_change, 1.0,
                    scalar_tensor(max_change, m.device)
                    / torch.clamp(m, min=1e-12))
    out = qs + u[..., None] * diff
    return torch.where(cyc, maths.wrap_to_pi(out), out)


def _history(q0s, alive, hist):
    """Per-row config trajectories [q0, hist...] of a scanned arm, f64,
    empty where the row is not alive."""
    hist = hist.cpu().numpy()
    return [
        np.concatenate([q0s[i][None], hist[:, i]]) if alive[i]
        else np.zeros((0, q0s.shape[1]))
        for i in range(len(alive))
    ]


def newton_teleop_batch(robot, trajs, q0s, alive, max_change=0.04,
                        converge_steps=100):
    """Plain-IK tracking arm (reference ``newton_teleop_solver``
    semantics: step toward the raw IK result).

    A host loop over the T + converge_steps ticks with the state on the
    device (the JAX package's one ``lax.scan``): the Newton arm has no
    host-side fallback state machine, so no tick reads its result."""
    trajs = np.asarray(trajs)
    N, T, D = trajs.shape
    total = T + converge_steps
    dev = robot.device
    traj_seq = torch.as_tensor(np.swapaxes(trajs, 0, 1), dtype=torch.float32,
                               device=dev)
    solve = make_newton_solver(robot)
    qs = torch.as_tensor(np.asarray(q0s), dtype=torch.float32, device=dev)
    hist = torch.empty((total, N, qs.shape[1]), dtype=torch.float32,
                       device=dev)
    for t in range(total):
        q_t = solve(traj_seq[min(t, T - 1)], qs)
        qs = _step_toward_j(robot, qs, q_t, max_change)
        hist[t] = qs
    return _history(np.asarray(q0s), alive, hist)


def relaxed_teleop_batch(robot, trajs, q0s, alive, max_change=0.04,
                         converge_steps=100):
    """RelaxedIK arm: like the Newton arm, a host loop over the ticks with
    the state on the device, one batched ``_relaxed_step`` a tick (the
    JAX package's vmap inside one ``lax.scan``)."""
    from reconplan_tpu_torch.kin.relaxed import _relaxed_step

    trajs = np.asarray(trajs)
    N, T, D = trajs.shape
    total = T + converge_steps
    dev = robot.device
    weights = torch.tensor([50.0, 10.0, 1.0, 1.0], dtype=torch.float32,
                           device=dev)

    if robot.rotation == "fixed" and robot.fixed_rotation is not None:
        fixed_quat = np.asarray(robot.fixed_rotation, dtype=np.float32)
    else:
        fixed_quat = np.asarray([0, 0, 0, 1], dtype=np.float32)

    traj_seq = torch.as_tensor(np.swapaxes(trajs, 0, 1), dtype=torch.float32,
                               device=dev)
    qs = torch.as_tensor(np.asarray(q0s), dtype=torch.float32, device=dev)
    if D <= 3:
        quat = robot._tensor(fixed_quat).expand(N, 4)
    hist = torch.empty((total, N, qs.shape[1]), dtype=torch.float32,
                       device=dev)
    for t in range(total):
        targets = traj_seq[min(t, T - 1)]
        if D > 3:
            quat = targets[:, 3:7] / torch.linalg.norm(
                targets[:, 3:7], dim=-1, keepdim=True)
        q_t = _relaxed_step(robot.model, robot._active_tuple, robot.ee_link,
                            qs, targets[:, :3], quat, robot._q_rest, weights)
        qs = _step_toward_j(robot, qs, q_t, max_change)
        hist[t] = qs
    return _history(np.asarray(q0s), alive, hist)


# ---------------------------------------------------------------------------
# metrics (experiment/utils.py semantics, batched)
# ---------------------------------------------------------------------------


def interpolated_configs(robot, c_traj, num_div):
    """All ``num_div`` interpolation steps between consecutive configs,
    flattened: (T-1)*num_div rows (``experiment/utils.py:48-60,72-84``)."""
    c = np.asarray(c_traj, dtype=np.float64)
    qa = np.repeat(c[:-1], num_div, axis=0)
    qb = np.repeat(c[1:], num_div, axis=0)
    u = np.tile((np.arange(num_div) + 1) / num_div, len(c) - 1)[:, None]
    cyc = robot._cyclic_mask.cpu().numpy()
    diff = qb - qa
    diff = np.where(cyc, np.mod(diff + np.pi, 2 * np.pi) - np.pi, diff)
    out = qa + u * diff
    return np.where(cyc, np.mod(out + np.pi, 2 * np.pi) - np.pi, out)


def _goal_rotation_ok(robot, ee_quat, goal):
    """Whether the final orientation is within 0.1 rad of the goal's (or
    of ``fixed_rotation``); always true for rotation-free robots."""
    if robot.rotation == "free":
        return True
    if len(goal) > 3:
        ref_quat = goal[3:7]
    elif robot.fixed_rotation is not None:
        ref_quat = np.asarray(robot.fixed_rotation)
    else:
        return True
    ang = 2 * np.arccos(min(1.0, abs(float(np.dot(ee_quat, ref_quat)))))
    return ang <= 0.1


def check_c_traj_batch(robot, goal, c_traj, num_div=8, chunk=4096):
    """Reference validity (``experiment/utils.py:30-63``): the final config
    reaches the goal (position within 0.1; rotation within 0.1 rad when the
    robot tracks rotation) AND no self-collision along the num_div-times
    interpolated path.

    Divergence (documented, as in the JAX package): for variable-rotation
    problems the rotation is checked against the GOAL's own quaternion;
    the reference compares against ``fixed_rotation``
    (``utils.py:37-44``), which is only correct for rot_fixed problems."""
    if len(c_traj) == 0:
        return False
    c_traj = np.asarray(c_traj, dtype=np.float32)
    ee = robot.fk_point_batch(c_traj[-1:])[0].cpu().numpy()
    goal = np.asarray(goal)
    if np.linalg.norm(ee[:3] - goal[:3]) > 0.1:
        return False
    if not _goal_rotation_ok(robot, ee[3:7], goal):
        return False
    qi = interpolated_configs(robot, c_traj, num_div)
    for s in range(0, len(qi), chunk):
        if robot.check_self_collision_batch(qi[s : s + chunk]).any():
            return False
    return True


def ws_traj_batch(robot, start, c_traj, num_div=4):
    """FK-resampled workspace trajectory (``experiment/utils.py:66-84``):
    starts at the input start point, then FK of every interpolated config."""
    qi = interpolated_configs(robot, c_traj, num_div)
    pts = _fk_points_batch(robot, qi)
    start = np.asarray(start, dtype=np.float64)[: pts.shape[1]]
    return np.concatenate([start[None], pts], axis=0)


def se3_cost_matrix(a, b, device=None):
    """(n, D) x (m, D) -> (n, m) workspace SE3 distances, computed on
    ``device`` (default: the card)."""
    return se3_pairwise(maths._tensor(np.asarray(a), device),
                        maths._tensor(np.asarray(b), device)).cpu().numpy()


def dtw_reference(traj1, traj2, device=None):
    """Reference DTW (``experiment/utils.py:87-144``): DP matrix with
    inf-filled first row/column, backtracked index pairs, distance = sum of
    pairwise costs along the path normalized by ``len(traj1)``."""
    a = np.asarray(traj1)
    b = np.asarray(traj2)
    cost = se3_cost_matrix(a, b, device).astype(np.float64)
    return _dtw_from_cost(cost) / len(a)


def _dtw_from_cost(cost):
    """DTW dynamic program + backtrack on a precomputed cost matrix.

    The row recurrence D[i,j] = c[j] + min(D[i-1,j], D[i-1,j-1], D[i,j-1])
    vectorizes via prefix sums: unrolling horizontal moves gives
    D[i,j] = S[j] + min_{k<=j}(m'[k] - S[k-1]) with m' = min of the two
    upper entries and S = cumsum(c) — an O(m) ``minimum.accumulate`` per
    row instead of an O(m) Python loop."""
    n, m = cost.shape
    D = np.full((n, m), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n):
        up = D[i - 1]
        mprime = np.minimum(up, np.concatenate([[np.inf], up[:-1]]))
        c = cost[i]
        S = np.cumsum(c)
        S_prev = S - c
        with np.errstate(invalid="ignore"):
            D[i] = S + np.minimum.accumulate(mprime - S_prev)

    # backtrack (utils.py:105-129)
    i, j = n - 1, m - 1
    pairs = []
    while i > 0 and j > 0:
        pairs.append((i, j))
        step = int(np.argmin([D[i - 1, j], D[i, j - 1], D[i - 1, j - 1]]))
        if step == 0:
            i -= 1
        elif step == 1:
            j -= 1
        else:
            i -= 1
            j -= 1
    if i == 0:
        pairs.extend((0, jj) for jj in range(j + 1))
    else:
        pairs.extend((ii, 0) for ii in range(i + 1))

    return float(sum(cost[i, j] for i, j in pairs))


def config_lengths(robot, c_traj):
    c = np.asarray(c_traj)
    if len(c) < 2:
        return 0.0
    d = robot.distance_batch(robot._tensor(c[:-1]), robot._tensor(c[1:]))
    return float(d.cpu().numpy().sum())


def ws_length(w_traj, device=None):
    """Summed SE3 length of a workspace path, on ``device`` (default: the
    card)."""
    w = np.asarray(w_traj)
    if len(w) < 2:
        return 0.0
    seg = maths.se3_distance(w[:-1], w[1:], device=device).cpu().numpy()
    return float(seg.sum())


# ---------------------------------------------------------------------------
# the full benchmark
# ---------------------------------------------------------------------------


def cold_starts(resolution, trajs):
    """Per-trajectory q0 via cold resolution.solve of start AND end
    (``trajectory_quality.py:72-80``). Returns (q0s (N, A), alive (N,)).

    Batched: the cold-start semantics of :meth:`RedundancyResolution.solve`
    (k-NN -> exact-node match -> largest-connected-component weighted
    average seed, ``resolution.py:313-433``) run host-side per point, and
    ALL the IK solves go in one ``solve_ik_batch``."""
    robot = resolution.robot
    N = len(trajs)
    A = robot.num_joints
    q0s = np.zeros((N, A), dtype=np.float64)
    alive = np.zeros(N, dtype=bool)
    if N == 0 or len(resolution.points) == 0:
        return q0s, alive

    pts = np.stack(
        [np.asarray(t[0], dtype=np.float64) for t in trajs]
        + [np.asarray(t[-1], dtype=np.float64) for t in trajs]
    )  # (2N, D) starts then ends
    if pts.shape[1] > 3:
        pts[:, 3:] /= np.linalg.norm(pts[:, 3:], axis=-1, keepdims=True)
    k = resolution.workspace.interpolate_num_neighbors
    nbrs = resolution.workspace.get_workspace_neighbors(
        pts.astype(np.float32), k=min(k, len(resolution.points)),
        points=resolution.points_t,
    )  # (2N, k)
    seeds = np.zeros((2 * N, A), dtype=np.float32)
    for m in range(2 * N):
        neighbors = [int(n) for n in np.atleast_1d(nbrs[m])]
        p = robot._tensor(pts[m])[None]
        # exact node match (resolution.py:313-318)
        d0 = maths.se3_distance(p, resolution.points_t[neighbors])
        d0 = d0.cpu().numpy()
        if d0.min() < 1e-3:
            seeds[m] = resolution.configs[neighbors[int(d0.argmin())]]
            continue
        # largest-connected-component weighted average (resolution.py:369-433)
        component = resolution._component_containing(neighbors, neighbors[0])
        comp = sorted(component)
        q_nbrs = resolution.configs[comp]
        d = maths.se3_distance(p, resolution.points_t[comp]).cpu().numpy()
        workspace_w = (d.max() / np.maximum(d, 1e-12)) ** 2
        weights = (1.0 / (workspace_w + 1e-6)) ** 2  # resolution.py:424 quirk
        seeds[m] = np.asarray(robot.average(q_nbrs, weights))

    q, ok = robot.solve_ik_batch(pts.astype(np.float32), seeds)
    q = q.cpu().numpy()
    ok = ok.cpu().numpy()
    alive = ok[:N] & ok[N:]
    q0s[alive] = q[:N][alive].astype(np.float64)
    return q0s, alive


def analyze_arm(robot, trajs, c_trajs, num_div=4):
    """Per-trajectory metrics rows (``analyze_results`` semantics).

    Rows of equal length (the engine's output shape) batch every device
    stage across ALL trajectories — final-config FK, interpolated
    self-collision, workspace-trajectory FK, and the DTW cost matrices
    each run as ONE batch instead of one per row. The DTW dynamic
    program itself stays on host (vectorized rows, ``dtw_reference``)."""
    live = [i for i, c in enumerate(c_trajs) if len(c)]
    lens = {len(c_trajs[i]) for i in live}
    if len(live) >= 2 and len(lens) == 1:
        return _analyze_arm_batched(robot, trajs, c_trajs, live, num_div)
    rows = []
    for traj, c_traj in zip(trajs, c_trajs):
        ok = check_c_traj_batch(robot, traj[-1], c_traj)
        row = {"success": bool(ok)}
        if len(c_traj):
            w_traj = ws_traj_batch(robot, traj[0], c_traj, num_div)
            c_len = config_lengths(robot, c_traj)
            w_len = ws_length(w_traj, robot.device)
            row.update(
                dtw=dtw_reference(traj, w_traj, robot.device),
                c_length=c_len,
                w_length=w_len,
                ratio=c_len / max(w_len, 1e-9),
            )
        rows.append(row)
    return rows


def _analyze_arm_batched(robot, trajs, c_trajs, live, num_div=4,
                         check_div=8):
    """Batched ``analyze_arm`` core for equal-length live rows."""
    C = np.stack([c_trajs[i] for i in live])  # (M, L, A)
    M, L, A = C.shape
    goals = np.stack([np.asarray(trajs[i][-1]) for i in live])

    # --- goal reach: FK of every final config in one batch ---
    ee_fin = robot.fk_point_batch(C[:, -1].astype(np.float32)).cpu().numpy()
    reach = np.linalg.norm(ee_fin[:, :3] - goals[:, :3], axis=-1) <= 0.1
    for m in np.flatnonzero(reach):
        reach[m] = _goal_rotation_ok(robot, ee_fin[m, 3:7], goals[m])

    # --- interpolated self-collision: all rows, in chunks ---
    qi_chk = np.stack(
        [interpolated_configs(robot, C[m], check_div) for m in range(M)]
    )  # (M, (L-1)*check_div, A)
    flat = qi_chk.reshape(-1, A).astype(np.float32)
    coll = np.zeros(len(flat), dtype=bool)
    # a chunk's sphere clearances are (CH, 192, 192) f32 for the UR10,
    # 1.2 GB at 8,192 configurations (XLA fused the JAX package's 2^17)
    CH = 1 << 13
    for s in range(0, len(flat), CH):
        coll[s : s + CH] = robot.check_self_collision_batch(flat[s : s + CH])
    collided = coll.reshape(M, -1).any(axis=1)
    success = reach & ~collided

    # --- workspace trajectories: one FK batch over all rows ---
    qi_ws = np.stack(
        [interpolated_configs(robot, C[m], num_div) for m in range(M)]
    )  # (M, (L-1)*num_div, A)
    W = qi_ws.shape[1]
    pts = _fk_points_batch(robot, qi_ws.reshape(-1, A))
    D = pts.shape[1]
    pts = pts.reshape(M, W, D)
    starts = np.stack(
        [np.asarray(trajs[i][0], dtype=np.float64)[:D] for i in live]
    )
    w_trajs = np.concatenate([starts[:, None], pts], axis=1)  # (M, W+1, D)

    # --- DTW cost matrices: one batched call ---
    in_trajs = np.stack([np.asarray(trajs[i])[:, :D] for i in live])
    cost_all = se3_pairwise(robot._tensor(in_trajs),
                            robot._tensor(w_trajs)).cpu().numpy()
    cost_all = cost_all.astype(np.float64)

    # --- lengths: batched distances ---
    cd = robot.distance_batch(
        robot._tensor(C[:, :-1].reshape(-1, A)),
        robot._tensor(C[:, 1:].reshape(-1, A)),
    ).cpu().numpy().reshape(M, L - 1)
    c_lens = cd.sum(axis=1)
    wd = maths.se3_distance(
        robot._tensor(w_trajs[:, :-1].reshape(-1, D)),
        robot._tensor(w_trajs[:, 1:].reshape(-1, D)),
    ).cpu().numpy().reshape(M, W)
    w_lens = wd.sum(axis=1)

    by_live = {}
    for mi, i in enumerate(live):
        dtw = _dtw_from_cost(cost_all[mi]) / len(in_trajs[mi])
        by_live[i] = {
            "success": bool(success[mi]),
            "dtw": dtw,
            "c_length": float(c_lens[mi]),
            "w_length": float(w_lens[mi]),
            "ratio": float(c_lens[mi] / max(w_lens[mi], 1e-9)),
        }
    return [
        by_live.get(i, {"success": False}) for i in range(len(c_trajs))
    ]


def summarize(rows, success_only=True):
    n = len(rows)
    if n == 0:
        return {}
    succ = [r for r in rows if r["success"]]
    vals = succ if success_only else [r for r in rows if "dtw" in r]
    out = {
        "success_rate": len(succ) / n,
        "n": n,
        "n_valid": len(vals),
    }
    for key in ("dtw", "ratio", "c_length", "w_length"):
        xs = [r[key] for r in vals if key in r]
        out[f"mean_{key}"] = float(np.mean(xs)) if xs else None
    return out


def run_reference_benchmark(
    resolution,
    trajectories_by_kind,
    random_resolution=None,
    include_relaxed=True,
    max_change=0.04,
    converge_steps=100,
    verbose=True,
    checkpoint_path=None,
    initial_results=None,
    greedy_seed=False,
    arms=("grr", "random_grr", "newton", "relaxed"),
    device=None,
):
    """All arms x all kinds at the reference protocol, ticks batched.

    ``trajectories_by_kind``: {kind: list of (T, D) paths}. Returns
    {kind: {arm: summary}} plus {kind: {arm: GRR fallback statistics,
    "seconds": {stage: wall seconds}}}, the stages being the cold starts
    and each arm's tracking and analysis (each ends in a host read, so
    the device work is inside).

    ``checkpoint_path``: write the accumulated {kind: {arm: summary}}
    JSON after EVERY completed kind, so a crash or timeout does not lose
    the finished kinds. ``initial_results``: {kind: {arm: summary}} from a
    prior partial run (a ``checkpoint_path`` dump); kinds already present
    are skipped. ``arms``: which arms to run.

    Everything runs on the resolution's device, which ``device`` names
    (``None``: the card; ``"cpu"`` asks for the CPU).
    """
    robot = resolution.robot
    robot_device(robot, device)
    results = dict(initial_results) if initial_results else {}
    stats_out = {}
    for kind, trajs in trajectories_by_kind.items():
        if results.get(kind):
            if verbose:
                print(f"[{kind}] resumed from checkpoint, skipping",
                      flush=True)
            continue
        if not len(trajs):
            results[kind] = {}
            continue
        trajs = np.stack(trajs)
        t_kind = time.time()

        def _phase(msg):
            if verbose:
                print(f"[{kind}] +{time.time() - t_kind:.0f}s {msg}",
                      flush=True)

        seconds = {}
        t_stage = time.perf_counter()

        def _lap(stage):
            nonlocal t_stage
            now = time.perf_counter()
            seconds[stage] = now - t_stage
            t_stage = now

        q0s, alive = cold_starts(resolution, trajs)
        _lap("cold_starts")
        _phase(f"{int(alive.sum())}/{len(trajs)} alive starts")
        kind_res = {}
        stats_out[kind] = {"seconds": seconds}

        if "grr" in arms:
            _phase("grr: tracking")
            grr_c, grr_stats = grr_teleop_batch(
                resolution, trajs, q0s, alive, max_change, converge_steps,
                verbose=verbose, greedy_seed=greedy_seed,
            )
            _phase("grr: analysis")
            kind_res["grr"] = summarize(analyze_arm(robot, trajs, grr_c))
            stats_out[kind]["grr"] = grr_stats
            _lap("grr")

        if random_resolution is not None and "random_grr" in arms:
            _phase("random_grr: cold starts")
            rq0, ralive = cold_starts(random_resolution, trajs)
            _phase("random_grr: tracking")
            rand_c, rand_stats = grr_teleop_batch(
                random_resolution, trajs, rq0, ralive, max_change,
                converge_steps, verbose=verbose,
            )
            _phase("random_grr: analysis")
            kind_res["random_grr"] = summarize(analyze_arm(robot, trajs, rand_c))
            stats_out[kind]["random_grr"] = rand_stats
            _lap("random_grr")

        if "newton" in arms:
            _phase("newton: tracking")
            newton_c = newton_teleop_batch(
                robot, trajs, q0s, alive, max_change, converge_steps
            )
            _phase("newton: analysis")
            kind_res["newton"] = summarize(analyze_arm(robot, trajs, newton_c))
            _lap("newton")

        if include_relaxed and "relaxed" in arms:
            _phase("relaxed: tracking")
            relaxed_c = relaxed_teleop_batch(
                robot, trajs, q0s, alive, max_change, converge_steps
            )
            _phase("relaxed: analysis")
            kind_res["relaxed"] = summarize(analyze_arm(robot, trajs, relaxed_c))
            _lap("relaxed")
        _phase("kind done")

        results[kind] = kind_res
        if checkpoint_path:
            import json

            tmp = f"{checkpoint_path}.tmp"
            with open(tmp, "w") as f:
                json.dump({"results": results, "complete": False}, f,
                          indent=1)
            os.replace(tmp, checkpoint_path)
        if verbose:
            for arm, row in kind_res.items():
                if row:
                    print(
                        f"  {arm:<11} success {row['success_rate']:.2f} "
                        f"dtw {row['mean_dtw'] if row['mean_dtw'] is not None else float('nan'):.4f} "
                        f"ratio {row['mean_ratio'] if row['mean_ratio'] is not None else float('nan'):.2f} "
                        f"(n={row['n']}, valid={row['n_valid']})"
                    )
    return results, stats_out
