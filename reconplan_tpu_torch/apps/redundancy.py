"""Roadmap build CLI — port of ``reconplan_tpu.apps.redundancy``.

Pipeline (reference ``redundancy.py:16-148``):
  1. load the problem JSON, build the robot on ``device``;
  2. sample the workspace (arc mode by default, as modified upstream);
  3. discover up to 8 spaced seed configurations by IK over the graph's
     nodes with joint-distance gating (``--seeds auto``), or take the
     problem's ``init_configs`` (any other value);
  4. global expansion; boundary repair (1 layer, 2 iterations,
     ``redundancy.py:128``);
  5. build + save the resolution roadmap (npz);
  6. evaluate roadmap quality.

Usage: python -m reconplan_tpu_torch.apps.redundancy <robot> <rotation_type>
           [--nodes N] [--seeds auto|json] [--out DIR] [--device DEV]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from reconplan_tpu_torch.grr import RedundancyResolution, evaluate_roadmap
from reconplan_tpu_torch.io.config import load_problem
from reconplan_tpu_torch.kin.robot import make_robot

DEFAULT_OBJ_POS = [0.75, 0.75, 0.0]  # main.py:45


def discover_seed_configs(robot, workspace, n_seeds=8, min_joint_distance=4.0,
                          seed=0, verbose=True):
    """Auto-select spaced seed configurations (``redundancy.py:67-101``):
    batched IK over all workspace nodes from random inits, then greedily
    keep solutions whose joint distance to every kept seed exceeds the
    gate. One IK batch on the robot's device, then one row of joint
    distances a kept seed."""
    pts = workspace.points
    rng = np.random.default_rng(seed)
    robot._rng = rng
    inits = robot.sample(len(pts))
    q, ok = robot.solve_ik_batch(pts, inits)
    q = q[ok]
    # the joint distance of every solution to its nearest kept seed; the
    # next seed is the first solution after the last one kept that is far
    # enough from all of them
    nearest = np.full(len(q), np.inf)
    kept = []
    while len(kept) < n_seeds:
        start = kept[-1] + 1 if kept else 0
        far = np.flatnonzero(nearest[start:] >= min_joint_distance)
        if not len(far):
            break
        kept.append(start + int(far[0]))
        nearest = np.minimum(nearest, robot.distance_batch(
            q[kept[-1]][None], q).cpu().numpy())
    if verbose:
        print(f"Discovered {len(kept)} seed configurations")
    return q[kept].cpu().numpy().reshape(-1, robot.num_joints)


def build_roadmap(
    robot_name="ur10",
    rotation_type="rot_variable_yaw",
    n_pos_points=None,
    obj_pos=DEFAULT_OBJ_POS,
    sampling_method="random",
    seeds="auto",
    out_dir=None,
    resume=False,
    verbose=True,
    floor_check=None,
    fix_boundary_layers=1,
    fix_boundary_iters=2,
    repair_edges=True,
    scrub=False,
    coherent=False,
    device=None,
):
    """Build (or ``resume`` an interrupted build of) a roadmap on
    ``device`` (default: the card).

    The solver graph is checkpointed to ``solver.npz`` after every
    expansion sweep; with ``resume=True`` an existing
    ``workspace.npz``/``solver.npz`` pair in ``out_dir`` is loaded and
    expansion continues from the saved frontier (reference
    ``redundancy.py:37-52`` ``load_existed_{ws,solver}_graph``).
    """
    opts = load_problem(robot_name, rotation_type)
    robot = make_robot(opts, floor_check=floor_check, device=device)
    res = RedundancyResolution(robot, robot.device)

    if out_dir is None:
        out_dir = os.path.join("graph", robot_name, rotation_type)
    os.makedirs(out_dir, exist_ok=True)
    ws_path = os.path.join(out_dir, "workspace.npz")
    solver_path = os.path.join(out_dir, "solver.npz")

    resumed = False
    if resume and os.path.exists(ws_path):
        res.load_workspace_graph(ws_path)
        if os.path.exists(solver_path):
            res.load_solver_graph(solver_path)
            resumed = True
        if verbose:
            print(
                f"Resumed workspace: {res.workspace.num_nodes} nodes, "
                f"{len(res.workspace.edges)} edges"
            )
    else:
        n_pos = n_pos_points or opts.get("number_of_position_points", 1000)
        n_rot = opts.get("number_of_rotation_points", 1)
        t0 = time.time()
        res.sample_workspace(obj_pos, n_pos, n_rot, sampling_method)
        if verbose:
            print(
                f"Workspace: {res.workspace.num_nodes} nodes, "
                f"{len(res.workspace.edges)} edges ({time.time()-t0:.1f}s)"
            )
        res.save_workspace_graph(ws_path)

    if seeds == "auto":
        seed_configs = discover_seed_configs(robot, res.workspace, verbose=verbose)
    else:
        seed_configs = np.asarray(opts["init_configs"], dtype=np.float32)

    t0 = time.time()
    res.solver.global_expansion(
        seed_configs,
        on_sweep=lambda s: res.save_solver_graph(solver_path),
        coherent=coherent,
    )
    if verbose:
        print(f"Expansion: {time.time()-t0:.1f}s" + (" (resumed)" if resumed else ""))
    # reference default: fix_boundary(1, 2) (redundancy.py:128); more
    # iterations/layers repair more of the discontinuous boundary at the
    # cost of extra IK waves
    res.fix_boundary(fix_boundary_layers, fix_boundary_iters)
    if repair_edges:
        # targeted cross-seed repair of the edges fix_boundary left
        # disconnected (documented divergence — see solver.repair_edges)
        res.solver.repair_edges(verbose=verbose)
    if scrub:
        # reference-artifact end-state: 0.0% disconnection by dropping
        # the configs of unrepairable nodes
        res.solver.scrub_disconnected(verbose=verbose)
    res.save_solver_graph(solver_path)
    res.build_resolution_graph_and_nn()

    res.save_resolution_graph(os.path.join(out_dir, "resolution.npz"))
    if verbose:
        print(f"Saved roadmap to {out_dir}")

    metrics = evaluate_roadmap(res, verbose=verbose)
    return res, metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("robot", nargs="?", default="ur10")
    ap.add_argument("rotation_type", nargs="?", default="rot_variable_yaw")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--seeds", choices=["auto", "json"], default="auto")
    ap.add_argument("--method", default="random",
                    choices=["random", "grid", "uniform_random"])
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--resume", action="store_true",
        help="continue an interrupted build from workspace.npz/solver.npz",
    )
    ap.add_argument("--fix-boundary-layers", type=int, default=1)
    ap.add_argument("--fix-boundary-iters", type=int, default=2)
    ap.add_argument("--no-repair-edges", action="store_true",
                    help="skip the targeted cross-seed edge repair pass")
    ap.add_argument("--scrub", action="store_true",
                    help="drop configs of unrepairable nodes until 0%% "
                    "disconnection (the reference artifact's end-state)")
    ap.add_argument("--coherent", action="store_true",
                    help="FIFO-coherent expansion: direct-neighbor-first "
                    "frontier + graph-colored independent sets within "
                    "each wave (see ExpansionSolver.global_expansion)")
    ap.add_argument(
        "--no-floor-check", action="store_true",
        help="disable the UR10 floor check (reference-ARTIFACT parity: the "
        "shipped graph/ur10/rot_fixed roadmap predates the as-modified "
        "floor check)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    args = ap.parse_args(argv)
    build_roadmap(
        args.robot,
        args.rotation_type,
        n_pos_points=args.nodes,
        sampling_method=args.method,
        seeds=args.seeds,
        out_dir=args.out,
        resume=args.resume,
        floor_check=False if args.no_floor_check else None,
        fix_boundary_layers=args.fix_boundary_layers,
        fix_boundary_iters=args.fix_boundary_iters,
        repair_edges=not args.no_repair_edges,
        scrub=args.scrub,
        coherent=args.coherent,
        device=args.device,
    )


if __name__ == "__main__":
    main()
