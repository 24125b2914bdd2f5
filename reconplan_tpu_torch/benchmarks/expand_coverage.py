"""Coverage expansion: configure more of the REACHABLE workspace.

VERDICT r4 weak #5 / next-step #6: the ur10 rot_variable_yaw roadmap
configures 80.7% of reachable nodes (2481 of 3073; census in
``grr.quality.census_reachability``), and unconfigured-but-reachable
nodes are pure detour cost for full-domain teleop targets — line_random
success is capped at 0.39. Target: >= 90% of reachable nodes.

Pipeline:

  1. census — batched-IK reachability witness per unconfigured node,
     seeded first from the nearest configured node's config (basin-
     aligned witnesses), then random restarts;
  2. island seeding — greedily adopt witnesses at reachable-unconfigured
     nodes that are >= ``--spacing`` graph layers from any already-
     adopted seed (pockets the BFS expansion never reached get local
     seeds instead of one global retry);
  3. re-expansion — ``global_expansion`` grows the field from both the
     old configs and the new islands (project_neighbors keeps growth
     coherent);
  4. repair — ``fix_boundary`` + ``repair_edges`` align the island/field
     boundaries (cross-seed re-basing);
  5. re-census + ``evaluate_roadmap`` + save.

The reference has no analog (its expansion runs once from 8 global
seeds, ``redundancy.py:55-113``); this is a rebuild-side extension and
is documented as such.

Port of the repo's ``benchmarks/expand_coverage.py``, with its flags
less ``--platform`` (``--device`` takes its place: by default the CUDA
card). ``--out`` is required, and a folder under the committed
``graph/`` is refused: no run rewrites a committed roadmap. Usage:

  python -m reconplan_tpu_torch.benchmarks.expand_coverage \\
      graph/ur10/rot_variable_yaw --rotation-type rot_variable_yaw \\
      --out expanded_rvy
"""

import argparse
import os
import time

import numpy as np

from reconplan_tpu_torch.benchmarks import device_label, refuse_under


def seed_islands(res, census, spacing=3, verbose=True):
    """Adopt basin-aligned witnesses at spaced reachable-unconfigured
    nodes. Returns the list of adopted node ids."""
    solver = res.solver
    ws = solver.workspace
    cand = np.flatnonzero(census["reachable"] & ~solver.has_config)
    # farthest-from-field first: pockets far from any configured node
    # are the ones expansion cannot reach on its own
    cfg = np.flatnonzero(solver.has_config)
    if len(cfg):
        d_field = np.min(np.linalg.norm(
            ws.points[cand, None, :3] - ws.points[None, cfg, :3], axis=-1
        ), axis=1)
        cand = cand[np.argsort(-d_field)]
    blocked = set()
    adopted = []
    for i in cand:
        i = int(i)
        if i in blocked:
            continue
        solver.configs[i] = census["witness"][i]
        solver.has_config[i] = True
        adopted.append(i)
        # block a BFS ball of ``spacing`` layers around the seed
        layer = {i}
        seen = {i}
        for _ in range(spacing):
            nxt = set()
            for u in layer:
                nxt.update(ws.adjacency[u])
            nxt -= seen
            seen |= nxt
            layer = nxt
        blocked |= seen
    if adopted:
        solver.check_connections(adopted)
    if verbose:
        print(f"seeded {len(adopted)} islands "
              f"(spacing {spacing}, {len(cand)} candidates)")
    return adopted


def main(argv=None):
    """Expand, save to ``--out``, print and return ``evaluate_roadmap``'s
    metrics and the last census."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("graph_dir")
    ap.add_argument("--robot", default="ur10")
    ap.add_argument("--rotation-type", default="rot_variable_yaw")
    ap.add_argument("--restarts", type=int, default=8)
    ap.add_argument("--spacing", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=3,
                    help="census->seed->expand rounds (later rounds "
                    "re-census against the grown field)")
    ap.add_argument("--smooth-iters", type=int, default=2)
    ap.add_argument("--out", required=True,
                    help="save dir (required; not under the repo's graph/)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    args = ap.parse_args(argv)
    refuse_under(args.out, "graph")

    from reconplan_tpu_torch.grr import (
        RedundancyResolution, census_reachability, evaluate_roadmap,
    )
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin.robot import make_robot

    opts = load_problem(args.robot, args.rotation_type)
    robot = make_robot(opts, device=args.device)
    print(f"device: {device_label(robot.device)}")
    res = RedundancyResolution(robot, robot.device)
    res.load_workspace_graph(os.path.join(args.graph_dir, "workspace.npz"))
    res.load_solver_graph(os.path.join(args.graph_dir, "solver.npz"))
    solver = res.solver
    print(f"loaded: {int(solver.has_config.sum())} configured")

    t0 = time.time()
    for rnd in range(args.rounds):
        census = census_reachability(res, restarts=args.restarts, seed=rnd)
        n_gap = int((census["reachable"] & ~solver.has_config).sum())
        print(f"round {rnd + 1}: {n_gap} reachable-unconfigured")
        if not n_gap:
            break
        adopted = seed_islands(res, census, spacing=args.spacing)
        if not adopted:
            break
        solver.global_expansion(
            np.zeros((0, robot.num_joints), np.float32), verbose=True
        )
        solver.fix_boundary(1, 2)
        solver.repair_edges()
        print(f"round {rnd + 1} end: {int(solver.has_config.sum())} "
              f"configured ({time.time() - t0:.0f}s)")
    if args.smooth_iters:
        solver.smooth_field(n_iter=args.smooth_iters)
        solver.repair_edges()

    out = args.out
    os.makedirs(out, exist_ok=True)
    res.save_solver_graph(os.path.join(out, "solver.npz"))
    if os.path.realpath(out) != os.path.realpath(args.graph_dir):
        res.save_workspace_graph(os.path.join(out, "workspace.npz"))
    res.build_resolution_graph_and_nn()
    res.save_resolution_graph(os.path.join(out, "resolution.npz"))
    print(f"expand total {time.time() - t0:.0f}s -> {out}")
    metrics = evaluate_roadmap(res, verbose=True)
    census = census_reachability(res, restarts=args.restarts, seed=99)
    return metrics, census


if __name__ == "__main__":
    main()
