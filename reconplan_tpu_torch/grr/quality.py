"""Roadmap quality metrics (``experiment/roadmap_quality.py`` parity).

Port of ``reconplan_tpu.grr.quality``: the disconnection ratio and the
rad/m distance ratio over the solver graph, printed after every build
(``redundancy.py:148``), and the reachability census. Distances and IK
run on the resolution's device.
"""

from __future__ import annotations

import numpy as np

from reconplan_tpu_torch.core import maths


def evaluate_roadmap(resolution, verbose=True):
    """Evaluate solver-graph quality (``roadmap_quality.py:12-54``).

    Returns dict(disconnection_ratio [%], distance_ratio [rad/m],
    n_nodes, n_edges, n_configured).
    """
    solver = resolution.solver
    ws = solver.workspace
    robot = resolution.robot

    both = solver.has_config[ws.edges[:, 0]] & solver.has_config[ws.edges[:, 1]]
    num_edges = int(both.sum())
    num_disconnected = int((both & ~solver.edge_connected).sum())
    disconnection_ratio = (
        100.0 * num_disconnected / num_edges if num_edges else float("nan")
    )

    if num_edges:
        sel = np.flatnonzero(both)
        i, j = ws.edges[sel, 0], ws.edges[sel, 1]
        c_dist = solver._distance(solver.configs[i], solver.configs[j])
        w_dist = maths.se3_distance(
            solver._tensor(ws.points[i]), solver._tensor(ws.points[j])
        ).cpu().numpy()
        distance_ratio = float(np.mean(c_dist / np.maximum(w_dist, 1e-12)))
    else:
        distance_ratio = float("nan")

    out = {
        "n_nodes": ws.num_nodes,
        "n_edges": len(ws.edges),
        "n_configured": int(solver.has_config.sum()),
        "disconnection_ratio": disconnection_ratio,
        "distance_ratio": distance_ratio,
    }
    if verbose:
        print("\nRoadmap quality:")
        print("Number of nodes:", out["n_nodes"])
        print("Number of edges:", out["n_edges"])
        print("Configured nodes:", out["n_configured"])
        print(f"Disconnection Ratio: {disconnection_ratio} %")
        print(f"Distance Ratio: {distance_ratio} rad/m")
    return out


def census_reachability(resolution, restarts=8, seed=0, verbose=True):
    """Reachability census of the workspace graph.

    For every workspace node, batched IK decides whether ANY valid
    configuration reaches it: one restart seeded from the nearest
    CONFIGURED node's config (keeps witnesses basin-aligned with the
    existing field), then ``restarts`` random restarts. A node is
    *reachable* if any round converges to a valid config; the witness
    kept is from the earliest round (nearest-seed preferred).

    Returns dict(reachable (N,) bool, witness (N, A) f32, and the
    counts: n_nodes, n_reachable, n_configured,
    coverage_of_reachable [%]).
    """
    solver = resolution.solver
    ws = solver.workspace
    robot = resolution.robot
    n = ws.num_nodes
    pts = ws.points

    reachable = solver.has_config.copy()
    witness = solver.configs.copy()

    def solve(todo, seeds):
        q, ok = robot.solve_ik_batch(pts[todo], seeds)
        q, ok = q.cpu().numpy(), ok.cpu().numpy()
        witness[todo[ok]] = q[ok]
        reachable[todo[ok]] = True

    # round 0: seed from the nearest configured node's config
    cfg_nodes = np.flatnonzero(solver.has_config)
    todo = np.flatnonzero(~reachable)
    if len(cfg_nodes) and len(todo):
        d = np.linalg.norm(
            pts[todo, None, :3] - pts[None, cfg_nodes, :3], axis=-1
        )
        solve(todo, solver.configs[cfg_nodes[np.argmin(d, axis=1)]])

    rng = np.random.default_rng(seed)
    for r in range(restarts):
        todo = np.flatnonzero(~reachable)
        if not len(todo):
            break
        solve(todo, robot.sample(len(todo), rng=rng))
        if verbose:
            print(f"census restart {r + 1}/{restarts}: "
                  f"{int(reachable.sum())}/{n} reachable")

    n_reach = int(reachable.sum())
    n_cfg = int(solver.has_config.sum())
    out = {
        "reachable": reachable,
        "witness": witness,
        "n_nodes": n,
        "n_reachable": n_reach,
        "n_configured": n_cfg,
        "coverage_of_reachable": 100.0 * n_cfg / max(n_reach, 1),
    }
    if verbose:
        print(f"census: {n_reach}/{n} reachable "
              f"({100.0 * n_reach / n:.1f}% of domain); "
              f"{n_cfg} configured = "
              f"{out['coverage_of_reachable']:.1f}% of reachable")
    return out
