"""Experiment layer: trajectory generation, teleop solvers, quality metrics.

Port of ``reconplan_tpu.grr.experiment``, the rebuild of
``Expansion-GRR/experiment/`` (the reference's de-facto test suite):
  - trajectory_generator.py -> :func:`generate_trajectories` (random/self
    lines, random/outward circles, IK-validated endpoints)
  - trajectory_quality.py   -> :func:`grr_teleop_solver`,
    :func:`newton_teleop_solver`, :func:`run_teleop_benchmark`
  - experiment/utils.py     -> :func:`check_c_traj`, :func:`get_ws_traj`,
    :func:`dynamic_time_warping`

The teleop comparison reproduces the reference's benchmark protocol:
per-step max joint change 0.04, 100 convergence steps at the goal,
success = goal within 0.1 and collision-free along the interpolated
path, deviation = DTW distance between workspace trajectories.

The random draws are numpy's (``np.random.default_rng``), as in the JAX
package, so a seed gives the same trajectories in both packages; the
quaternion maths and the IK run on the robot's device.
"""

from __future__ import annotations

import numpy as np
import torch

from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.grr.teleop_batch import _interpolate_points


# ---------------------------------------------------------------------------
# trajectory generation (trajectory_generator.py:20-249)
# ---------------------------------------------------------------------------


def _batch_reachable(robot, points, rounds=3, rng=None):
    """Reference endpoint-validity test (``robot.solve_ik(point) is not
    None``, ``trajectory_generator.py:36-46``) run as batched IK with
    ``rounds`` random restarts."""
    pts = np.asarray(points, dtype=np.float32)
    gen = rng if rng is not None else np.random.default_rng(0)
    ok = np.zeros(len(pts), dtype=bool)
    for _ in range(rounds):
        if ok.all():
            break
        inits = robot.sample(len(pts), rng=gen)
        _q, good = robot.solve_ik_batch(pts, inits)
        ok |= good.cpu().numpy()
    return ok


def _unit_vector(rng):
    v = rng.normal(0, 1, 3)
    n = np.linalg.norm(v)
    return v / n if n > 1e-6 else _unit_vector(rng)


def _line_path(robot, start, goal, n_points):
    """Straight-line interpolation incl. both endpoints
    (``trajectory_generator.py:176-187``: n_points+1 samples), every
    sample of ``robot.workspace_interpolate`` in one batch."""
    n = n_points + 1
    return _interpolate_points(
        robot, np.repeat(np.asarray(start)[None], n, axis=0),
        np.repeat(np.asarray(goal)[None], n, axis=0),
        np.arange(n) / n_points).cpu().numpy()


def _circle_path(start, goal, n_points, rng, device=None):
    """Reference circle construction (``trajectory_generator.py:192-245``):
    start and goal are diameter endpoints; the circle plane comes from a
    random up-vector; rotation slerps start->goal->start; the loop closes
    back at start. The rotations of all samples go to ``device``
    (default: the card) in one batch."""
    center = (np.asarray(start[:3]) + np.asarray(goal[:3])) / 2
    diameter_dir = np.asarray(goal[:3]) - np.asarray(start[:3])
    dn = diameter_dir / max(np.linalg.norm(diameter_dir), 1e-9)
    up = _unit_vector(rng)
    while np.isclose(abs(np.dot(up, dn)), 1.0):
        up = _unit_vector(rng)
    base_dir = np.cross(diameter_dir, up)
    base_dir /= max(np.linalg.norm(base_dir), 1e-9)
    angles = np.linspace(0, 2 * np.pi, n_points + 1, endpoint=True)
    arm = np.asarray(start[:3]) - center

    R = maths.quat_to_matrix(maths.rotvec_to_quat(
        (base_dir[None] * angles[:, None]).astype(np.float32),
        device=device)).cpu().numpy()
    path = center + np.einsum("kij,j->ki", R.astype(np.float64), arm)
    if len(start) > 3:
        u = 2 * np.arange(n_points + 1) / n_points
        u = np.where(u > 1, 2 - u, u)
        shape = (n_points + 1, 4)
        q1 = maths._tensor(np.asarray(start[3:7]), device)
        q2 = maths._tensor(np.asarray(goal[3:7]), device)
        rot = maths.slerp(q1.expand(shape), q2.expand(shape),
                          torch.as_tensor(u, dtype=torch.float32,
                                          device=q1.device)).cpu().numpy()
        path = np.concatenate([path, rot], axis=-1)
    # closed loop (trajectory_generator.py:244-245)
    return np.concatenate([path, path[:1]])


def generate_trajectories(
    robot,
    kind="line_random",
    n_trajectories=10,
    duration=4.0,
    hz=50,
    seed=0,
    max_tries=200,
    batch=256,
):
    """Generate task trajectories per the reference protocol
    (``trajectory_generator.py:20-249``), endpoint validation batched.

    kinds (4 s @ 50 Hz default -> 201-point lines, 202-point circles):
      * line_random — both endpoints random ``workspace_sample``s, both
        IK-reachable.
      * line_self — goal position is the ANTIPODE ``-start[:3]`` (same
        rotation): the path crosses the robot base.
      * circle_random — goal within 0.2*min-domain-extent of start; circle
        through both as diameter endpoints; both reachable.
      * circle_out — same circle but EXACTLY ONE endpoint reachable (the
        valid one becomes start): the sweep exits the reachable space.

    Returns list of (T, D) float32 workspace paths.
    """
    rng = np.random.default_rng(seed)
    n_points = max(int(duration * hz), 1)
    domain_size = min(b - a for a, b in robot.domain)
    thresh = 0.2 * domain_size
    out = []
    tries = 0
    while len(out) < n_trajectories and tries < max_tries * n_trajectories:
        tries += batch
        starts = np.stack(
            [robot.workspace_sample(rng=rng) for _ in range(batch)]
        )
        if kind == "line_random":
            goals = np.stack(
                [robot.workspace_sample(rng=rng) for _ in range(batch)]
            )
        elif kind == "line_self":
            goals = starts.copy()
            goals[:, :3] = -starts[:, :3]
        elif kind in ("circle_random", "circle_out"):
            others = np.stack(
                [robot.workspace_sample(rng=rng) for _ in range(batch)]
            )
            goals = others.copy()
            dist = rng.uniform(0, thresh, size=batch)
            dirs = np.stack([_unit_vector(rng) for _ in range(batch)])
            goals[:, :3] = starts[:, :3] + dist[:, None] * dirs
        else:
            raise ValueError(f"unknown trajectory kind {kind}")

        sv = _batch_reachable(robot, starts, rng=rng)
        gv = _batch_reachable(robot, goals, rng=rng)
        for i in range(batch):
            if len(out) >= n_trajectories:
                break
            if kind == "circle_out":
                # exactly one endpoint valid; put the valid one at start
                if sv[i] and not gv[i]:
                    s, g = starts[i], goals[i]
                elif gv[i] and not sv[i]:
                    s, g = goals[i], starts[i]
                else:
                    continue
            else:
                if not (sv[i] and gv[i]):
                    continue
                s, g = starts[i], goals[i]
            if kind.startswith("line"):
                traj = _line_path(robot, s, g, n_points)
            else:
                traj = _circle_path(s, g, n_points, rng, device=robot.device)
            out.append(traj.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# teleop solvers (trajectory_quality.py:24-144)
# ---------------------------------------------------------------------------


def _step_toward(robot, curr, target, max_change=0.04):
    """Clamped joint step (trajectory_quality.py per-step limit)."""
    diff = np.asarray(target) - np.asarray(curr)
    for i in robot.cyclic_joints:
        diff[i] = float(maths.wrap_to_pi(robot._tensor(diff[i])))
    m = np.abs(diff).max()
    if m <= max_change:
        return np.asarray(target, dtype=np.float64)
    return np.asarray(robot.interpolate(curr, target, max_change / m))


def newton_teleop_solver(robot, trajectory, q0, max_change=0.04,
                         converge_steps=100):
    """Track a workspace trajectory with plain DLS-IK seeded from the
    current config (trajectory_quality.py:24-65)."""
    q = np.asarray(q0, dtype=np.float64)
    c_traj = [q]
    for point in trajectory:
        target = robot.solve_ik(point, q, none_on_fail=False)
        q = _step_toward(robot, q, target, max_change)
        c_traj.append(q)
    for _ in range(converge_steps):
        target = robot.solve_ik(trajectory[-1], q, none_on_fail=False)
        q_new = _step_toward(robot, q, target, max_change)
        if np.allclose(q_new, q, atol=1e-6):
            break
        q = q_new
        c_traj.append(q)
    return np.asarray(c_traj)


def grr_teleop_solver(resolution, trajectory, q0, max_change=0.04,
                      converge_steps=100):
    """Track a workspace trajectory with GRR teleop
    (trajectory_quality.py:68-107)."""
    q = np.asarray(q0, dtype=np.float64)
    c_traj = [q]
    for point in trajectory:
        q_new = resolution.teleop_solve(point, q, max_change)
        if q_new is not None:
            q = np.asarray(q_new, dtype=np.float64)
        c_traj.append(q)
    for _ in range(converge_steps):
        q_new = resolution.teleop_solve(trajectory[-1], q, max_change)
        if q_new is None or np.allclose(q_new, q, atol=1e-6):
            break
        q = np.asarray(q_new, dtype=np.float64)
        c_traj.append(q)
    return np.asarray(c_traj)


def make_random_resolution(resolution, seed=0):
    """Random-GRR ablation roadmap (trajectory_quality.py:336-355 loads a
    prebuilt ``experiment/rgrr`` graph): the SAME workspace graph, but each
    node's configuration comes from an INDEPENDENT randomly-seeded IK solve
    — no continuity-driven expansion. Edge continuity is then measured
    honestly, so the ablation shows how much of GRR's quality is the
    expansion itself rather than the roadmap lookup machinery."""
    from reconplan_tpu_torch.grr.resolution import RedundancyResolution
    from reconplan_tpu_torch.grr.solver import ExpansionSolver

    robot = resolution.robot
    rand = RedundancyResolution(robot, resolution.device)
    rand.workspace = resolution.workspace
    rand.solver = ExpansionSolver(rand.workspace, robot, resolution.device)
    rng = np.random.default_rng(seed)
    robot._rng = rng
    pts = rand.workspace.points
    inits = robot.sample(len(pts))
    q, ok = robot.solve_ik_batch(pts, inits)
    q, ok = q.cpu().numpy(), ok.cpu().numpy()
    rand.solver.configs[ok] = q[ok].astype(np.float32)
    rand.solver.has_config[:] = ok
    rand.solver.check_connections(list(np.flatnonzero(ok)))
    rand.build_resolution_graph_and_nn()
    return rand


# ---------------------------------------------------------------------------
# metrics (experiment/utils.py)
# ---------------------------------------------------------------------------


def config_traj_length(robot, c_traj):
    """Total joint-space length (experiment/utils.py trajectory length)."""
    if len(c_traj) < 2:
        return 0.0
    c = np.asarray(c_traj)
    d = robot.distance_batch(robot._tensor(c[:-1]), robot._tensor(c[1:]))
    return float(d.cpu().numpy().sum())


def workspace_traj_length(w_traj):
    if len(w_traj) < 2:
        return 0.0
    return float(
        np.linalg.norm(np.diff(np.asarray(w_traj)[:, :3], axis=0), axis=-1).sum()
    )


def get_ws_traj(robot, c_traj):
    """FK-resample a config trajectory to workspace
    (experiment/utils.py:66-84)."""
    pts = robot.fk_point_batch(np.asarray(c_traj, dtype=np.float32))
    pts = pts.cpu().numpy()
    if robot.rotation != "variable":
        return pts[:, :3]
    return pts


def check_c_traj(robot, c_traj, goal_point, goal_tolerance=0.1,
                 collision_samples=4):
    """Trajectory validity (experiment/utils.py:30-63): final pose within
    ``goal_tolerance`` of the goal AND no self-collision along the
    interpolated path."""
    c_traj = np.asarray(c_traj)
    ee = robot.fk_point_batch(c_traj[-1:].astype(np.float32))[0]
    ee = ee.cpu().numpy()
    if np.linalg.norm(ee[:3] - np.asarray(goal_point)[:3]) > goal_tolerance:
        return False
    for qa, qb in zip(c_traj[:-1], c_traj[1:]):
        for u in np.linspace(0, 1, collision_samples, endpoint=False):
            q = robot.interpolate(qa, qb, float(u))
            if robot.check_self_collision(q):
                return False
    return True


def dynamic_time_warping(traj1, traj2):
    """DTW distance between two workspace paths (positions), the pure-python
    fastdtw replacement (experiment/utils.py:87-144). O(N*M) vectorized."""
    a = np.asarray(traj1)[:, :3]
    b = np.asarray(traj2)[:, :3]
    n, m = len(a), len(b)
    dist = np.linalg.norm(a[:, None] - b[None], axis=-1)
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        # rolling update along j (dependency on D[i, j-1])
        row = np.empty(m)
        prev = np.inf
        for j in range(m):
            best = min(D[i - 1, j + 1], D[i - 1, j], prev)
            prev = dist[i - 1, j] + best
            row[j] = prev
        D[i, 1:] = row
    return float(D[n, m])


def run_teleop_benchmark(resolution, trajectories, seed=0, max_change=0.04,
                         include_relaxed=True, random_resolution=None):
    """Compare GRR teleop vs Random-GRR vs Newton-IK vs RelaxedIK tracking
    over generated trajectories (trajectory_quality.py:147-285, incl. the
    RandomGRR arm at :336-355). Returns per-method dicts of success rate,
    mean DTW deviation, and config/workspace length ratio.

    Pass ``random_resolution`` (see :func:`make_random_resolution`) to run
    the random-assignment ablation arm."""
    from reconplan_tpu_torch.kin.relaxed import relaxed_teleop_solver

    robot = resolution.robot
    results = {"grr": [], "newton": []}
    if random_resolution is not None:
        results["random_grr"] = []
    if include_relaxed:
        results["relaxed"] = []
    for traj in trajectories:
        q0 = robot.solve_ik(traj[0])
        for retry in range(8):
            if q0 is not None:
                break
            robot._rng = np.random.default_rng(retry)
            q0 = robot.solve_ik(traj[0], robot.sample(1)[0])
        if q0 is None:
            continue
        methods = [
            ("grr", lambda: grr_teleop_solver(resolution, traj, q0, max_change)),
            ("newton", lambda: newton_teleop_solver(robot, traj, q0, max_change)),
        ]
        if random_resolution is not None:
            methods.append(
                ("random_grr",
                 lambda: grr_teleop_solver(
                     random_resolution, traj, q0, max_change))
            )
        if include_relaxed:
            methods.append(
                ("relaxed",
                 lambda: relaxed_teleop_solver(robot, traj, q0, max_change))
            )
        for name, solver in methods:
            c_traj = solver()
            w_traj = get_ws_traj(robot, c_traj)
            ok = check_c_traj(robot, c_traj, traj[-1])
            results[name].append(
                {
                    "success": ok,
                    "dtw": dynamic_time_warping(w_traj, traj),
                    "ratio": config_traj_length(robot, c_traj)
                    / max(workspace_traj_length(w_traj), 1e-9),
                }
            )
    summary = {}
    for name, rows in results.items():
        if not rows:
            summary[name] = {}
            continue
        summary[name] = {
            "success_rate": float(np.mean([r["success"] for r in rows])),
            "mean_dtw": float(np.mean([r["dtw"] for r in rows])),
            "mean_ratio": float(np.mean([r["ratio"] for r in rows])),
            "n": len(rows),
        }
    return summary
