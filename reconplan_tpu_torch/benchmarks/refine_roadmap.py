"""Roadmap refinement: smooth -> repair -> anneal to the reference
artifact's end-state (0.0% disconnection at max configured nodes).

The reference's shipped graphs measure 0.0% disconnection because its
quality metric only counts edges between CONFIGURED nodes
(``experiment/roadmap_quality.py:22-35``) and its fix_boundary scrubs
the configs it cannot repair. This script drives a built roadmap to the
same end-state while keeping (or growing) the configured count:

  1. ``smooth_field`` — Gauss-Seidel coherence relaxation (solver.py);
  2. one extra expansion pass (a smoother field IK-configures boundary
     nodes the rough field could not);
  3. ``fix_boundary`` + ``repair_edges``;
  4. ANNEAL loop: scrub to 0% disconnection, then try to re-configure
     every scrubbed node from the now-coherent field, adopting a node
     only if ALL its incident configured edges re-check continuous —
     each round ends at 0% disconnection with monotonically growing
     configured count; stops at fixpoint.

Port of the repo's ``benchmarks/refine_roadmap.py``, with its flags less
``--platform`` (``--device`` takes its place: by default the CUDA card).
``--out`` is required, and a folder under the committed ``graph/`` is
refused: no run rewrites a committed roadmap.

Usage: python -m reconplan_tpu_torch.benchmarks.refine_roadmap <graph_dir>
           --out <dir> [--no-smooth]
"""

import argparse
import os
import time

import numpy as np

from reconplan_tpu_torch.benchmarks import device_label, refuse_under


def anneal(res, max_rounds=8, verbose=True):
    solver = res.solver
    ws = res.workspace
    best = None
    for rnd in range(max_rounds):
        solver.scrub_disconnected(verbose=verbose)
        n_cfg = int(solver.has_config.sum())
        if best is not None and n_cfg <= best:
            break
        best = n_cfg
        if verbose:
            print(f"anneal round {rnd + 1}: {n_cfg} configured at 0% "
                  "disconnection")
        # try to re-adopt scrubbed/unconfigured nodes from the coherent
        # field, but ONLY when every incident configured edge re-checks
        # continuous (strict: never re-introduce disconnection)
        todo = [
            int(i) for i in np.flatnonzero(~solver.has_config)
            if any(solver.has_config[j] for j in ws.adjacency[i])
        ]
        if not todo:
            break
        q, ok = solver.project_neighbors_batch(todo, 4)
        cand = [(i, q[b]) for b, i in enumerate(todo) if ok[b]]
        if not cand:
            break
        # batched continuity of every (candidate, configured-neighbor)
        q1, q2, p1, p2, owner = [], [], [], [], []
        for ci, (i, qi) in enumerate(cand):
            for j in ws.adjacency[i]:
                if solver.has_config[j]:
                    q1.append(qi)
                    q2.append(solver.configs[j])
                    p1.append(ws.points[i])
                    p2.append(ws.points[j])
                    owner.append((ci, j))
        cont = solver.is_continuous_batch(
            np.asarray(q1), np.asarray(q2), np.asarray(p1), np.asarray(p2)
        )
        good = {}
        for (ci, j), ct in zip(owner, cont):
            good.setdefault(ci, []).append(bool(ct))
        adopted = []
        taken_adjacent = set()
        for ci, (i, qi) in enumerate(cand):
            if i in taken_adjacent:
                continue
            checks = good.get(ci, [])
            if checks and all(checks):
                solver.configs[i] = qi
                solver.has_config[i] = True
                adopted.append(i)
                # adjacent adoptions were continuity-checked against the
                # field WITHOUT each other; skip neighbors this round
                taken_adjacent.update(ws.adjacency[i])
        if adopted:
            solver.check_connections(adopted)
        if verbose:
            print(f"  re-adopted {len(adopted)} nodes")
        if not adopted:
            break
    solver.scrub_disconnected(verbose=verbose)


def main(argv=None):
    """Refine, save to ``--out``, print and return ``evaluate_roadmap``'s
    metrics."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("graph_dir")
    ap.add_argument("--robot", default="ur10")
    ap.add_argument("--rotation-type", default="rot_fixed")
    ap.add_argument("--no-floor-check", action="store_true")
    ap.add_argument("--no-smooth", action="store_true")
    ap.add_argument("--smooth-iters", type=int, default=5)
    ap.add_argument("--out", required=True,
                    help="save dir (required; not under the repo's graph/)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    args = ap.parse_args(argv)
    refuse_under(args.out, "graph")

    from reconplan_tpu_torch.grr import RedundancyResolution, evaluate_roadmap
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin.robot import make_robot

    opts = load_problem(args.robot, args.rotation_type)
    robot = make_robot(
        opts, floor_check=False if args.no_floor_check else None,
        device=args.device,
    )
    print(f"device: {device_label(robot.device)}")
    res = RedundancyResolution(robot, robot.device)
    res.load_workspace_graph(os.path.join(args.graph_dir, "workspace.npz"))
    res.load_solver_graph(os.path.join(args.graph_dir, "solver.npz"))
    solver = res.solver
    print(f"loaded: {int(solver.has_config.sum())} configured, "
          f"{int(solver.edge_connected.sum())}/{len(res.workspace.edges)} "
          "connected")

    t0 = time.time()
    if not args.no_smooth:
        solver.smooth_field(n_iter=args.smooth_iters)
        print(f"smooth: {time.time()-t0:.0f}s, "
              f"{int(solver.edge_connected.sum())} connected")
    # extra expansion pass from the smoother field
    solver.global_expansion(np.zeros((0, robot.num_joints), np.float32))
    solver.fix_boundary(1, 2)
    solver.repair_edges()
    anneal(res)

    out = args.out
    os.makedirs(out, exist_ok=True)
    res.save_solver_graph(os.path.join(out, "solver.npz"))
    if os.path.realpath(out) != os.path.realpath(args.graph_dir):
        res.save_workspace_graph(os.path.join(out, "workspace.npz"))
    res.build_resolution_graph_and_nn()
    res.save_resolution_graph(os.path.join(out, "resolution.npz"))
    print(f"refine total {time.time()-t0:.0f}s -> {out}")
    return evaluate_roadmap(res, verbose=True)


if __name__ == "__main__":
    main()
