"""Benchmark: teleop trajectory-quality comparison (the reference's
headline experiment, ``experiment/trajectory_quality.py:288-420``).

Port of the repo's ``benchmarks/bench_teleop.py``, with the same flags;
``--device`` (default: the card) takes the place of ``--platform``.

Protocol (reference parity): N trajectories per kind x 4 kinds
(line_random, line_self, circle_random, circle_out; 4 s @ 50 Hz,
``trajectory_generator.py:156-249``), tracked by four methods:

  * Expansion-GRR teleop on the built roadmap
  * Random-GRR teleop (same workspace graph, random per-node IK —
    the continuity ablation, ``trajectory_quality.py:336-355``)
  * Newton/DLS IK
  * RelaxedIK (damped-GN soft-objective port)

Metrics per method: success rate (goal < 0.1, valid path), mean DTW
deviation between workspace trajectories, and config/workspace length
ratio (lower = less joint motion per task motion).

    python -m reconplan_tpu_torch.benchmarks.bench_teleop \\
        --graph-dir graph/ur10/rot_variable_yaw \\
        --rotation-type rot_variable_yaw --kinds circle_random
"""

import argparse
import json
import os
import tempfile
import time

KINDS = ["line_random", "line_self", "circle_random", "circle_out"]


def load_random_resolution(res, rgrr_dir):
    """The Random-GRR roadmap cached in ``rgrr_dir`` over ``res``'s
    workspace graph."""
    from reconplan_tpu_torch.grr import RedundancyResolution
    from reconplan_tpu_torch.grr.solver import ExpansionSolver

    robot = res.robot
    random_res = RedundancyResolution(robot, res.device)
    random_res.workspace = res.workspace
    random_res.solver = ExpansionSolver(random_res.workspace, robot,
                                        res.device)
    random_res.load_solver_graph(os.path.join(rgrr_dir, "solver.npz"))
    random_res.load_resolution_graph(os.path.join(rgrr_dir, "resolution.npz"))
    return random_res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--robot", default="ur10")
    ap.add_argument("--rotation-type", default="rot_free")
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--per-kind", type=int, default=100,
                    help="trajectories per kind (reference protocol: 100)")
    ap.add_argument("--graph-dir", default=None,
                    help="load a prebuilt roadmap instead of building")
    ap.add_argument("--no-relaxed", action="store_true")
    ap.add_argument("--engine", choices=["batch", "host"], default="batch",
                    help="batch = ticks batched across trajectories "
                    "(teleop_batch.py); host = reference-shaped per-"
                    "trajectory loop")
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help="comma-separated trajectory kinds, in run order")
    ap.add_argument("--arms", default="grr,random_grr,newton,relaxed",
                    help="comma-separated arms to run (batch engine)")
    ap.add_argument("--grr-greedy-seed", action="store_true",
                    help="add the current config as an extra GRR IK seed "
                    "(documented divergence from the reference's "
                    "roadmap-only seeding)")
    ap.add_argument("--resume", action="store_true",
                    help="load <out>.partial (written after every finished "
                    "kind) and skip kinds already present")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    args = ap.parse_args(argv)

    from reconplan_tpu_torch.apps.redundancy import build_roadmap
    from reconplan_tpu_torch.grr import RedundancyResolution
    from reconplan_tpu_torch.grr.experiment import (
        generate_trajectories,
        make_random_resolution,
        run_teleop_benchmark,
    )
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin.robot import make_robot

    graph_dir = args.graph_dir
    if graph_dir:
        opts = load_problem(args.robot, args.rotation_type)
        robot = make_robot(opts, device=args.device)
        res = RedundancyResolution(robot, robot.device)
        res.load_workspace_graph(os.path.join(graph_dir, "workspace.npz"))
        res.load_resolution_graph(os.path.join(graph_dir, "resolution.npz"))
        sv = os.path.join(graph_dir, "solver.npz")
        if os.path.exists(sv):
            res.load_solver_graph(sv)
    else:
        graph_dir = os.path.join(tempfile.gettempdir(), "bench_teleop_graph")
        t0 = time.time()
        res, _metrics = build_roadmap(
            args.robot, args.rotation_type, n_pos_points=args.nodes,
            out_dir=graph_dir, verbose=True, device=args.device,
        )
        print(f"roadmap build: {time.time()-t0:.1f}s")

    robot = res.robot
    t0 = time.time()
    # the random-GRR ablation graph is deterministic given the roadmap:
    # cache it beside the graph (the reference ships its prebuilt
    # experiment/rgrr graph the same way)
    rgrr_dir = os.path.join(graph_dir, "rgrr")
    if os.path.exists(os.path.join(rgrr_dir, "resolution.npz")):
        random_res = load_random_resolution(res, rgrr_dir)
        print(f"random-GRR roadmap: loaded cache ({time.time()-t0:.1f}s)")
    else:
        random_res = make_random_resolution(res)
        os.makedirs(rgrr_dir, exist_ok=True)
        random_res.save_solver_graph(os.path.join(rgrr_dir, "solver.npz"))
        random_res.save_resolution_graph(
            os.path.join(rgrr_dir, "resolution.npz"))
        print(f"random-GRR roadmap: built {time.time()-t0:.1f}s "
              f"(cached to {rgrr_dir})")

    all_results = {}
    fallback_stats = {}
    kinds = [k.strip() for k in args.kinds.split(",") if k.strip()]
    if args.engine == "batch":
        from reconplan_tpu_torch.grr.teleop_batch import (
            run_reference_benchmark,
        )

        initial = None
        if args.resume and args.out and os.path.exists(args.out + ".partial"):
            with open(args.out + ".partial") as f:
                initial = json.load(f).get("results") or None
            if initial:
                print(f"resuming: {sorted(k for k, v in initial.items() if v)}"
                      " already complete in checkpoint")
        by_kind = {
            kind: ([] if (initial and initial.get(kind)) else
                   generate_trajectories(
                       robot, kind=kind, n_trajectories=args.per_kind, seed=7
                   ))
            for kind in kinds
        }
        t0 = time.time()
        all_results, fallback_stats = run_reference_benchmark(
            res, by_kind,
            random_resolution=random_res,
            include_relaxed=not args.no_relaxed,
            verbose=True,
            checkpoint_path=(args.out + ".partial") if args.out else None,
            initial_results=initial,
            greedy_seed=args.grr_greedy_seed,
            arms=tuple(a.strip() for a in args.arms.split(",") if a.strip()),
            device=res.device,
        )
        print(f"\nbatched benchmark wall time: {time.time()-t0:.1f}s")
    else:
        for kind in kinds:
            trajs = generate_trajectories(
                robot, kind=kind, n_trajectories=args.per_kind, seed=7
            )
            t0 = time.time()
            summary = run_teleop_benchmark(
                res, trajs,
                include_relaxed=not args.no_relaxed,
                random_resolution=random_res,
            )
            all_results[kind] = summary
            print(f"\n== {kind} ({len(trajs)} trajectories, "
                  f"{time.time()-t0:.1f}s) ==")
            for method, row in summary.items():
                if row:
                    print(
                        f"  {method:<11} success {row['success_rate']:.2f}  "
                        f"DTW {row['mean_dtw']:.3f}  ratio {row['mean_ratio']:.2f}"
                        f"  (n={row['n']})"
                    )

    # aggregate over kinds (methods with no valid rows anywhere -> None)
    agg = {}
    for method in next(iter(all_results.values()), {}):
        rows = [r[method] for r in all_results.values() if r.get(method)]
        if not rows:
            agg[method] = None
            continue

        def _mean(key):
            # skip None AND nan (an arm with zero valid rows in one kind
            # reports nan there but may have real numbers elsewhere)
            xs = [r[key] for r in rows
                  if r.get(key) is not None and r[key] == r[key]]
            return sum(xs) / len(xs) if xs else None

        agg[method] = {
            "success_rate": sum(r["success_rate"] for r in rows) / len(rows),
            "mean_dtw": _mean("mean_dtw"),
            "mean_ratio": _mean("mean_ratio"),
        }
    print("\n== aggregate ==")
    nan = float("nan")
    for method, row in agg.items():
        if row is None:
            print(f"  {method:<11} (no valid rows)")
            continue
        print(
            f"  {method:<11} success {row['success_rate']:.2f}  "
            f"DTW {row['mean_dtw'] if row['mean_dtw'] is not None else nan:.3f}"
            f"  ratio "
            f"{row['mean_ratio'] if row['mean_ratio'] is not None else nan:.2f}"
        )
    out = {"per_kind": all_results, "aggregate": agg,
           "fallback_stats": fallback_stats,
           "config": {"robot": args.robot, "nodes": args.nodes,
                      "per_kind": args.per_kind, "engine": args.engine,
                      "rotation_type": args.rotation_type,
                      "graph_dir": args.graph_dir,
                      "device": str(res.device)}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    grr_row = agg.get("grr")
    print(json.dumps({"metric": "teleop success rate (GRR aggregate)",
                      "value": round(grr_row["success_rate"], 3)
                      if grr_row else None,
                      "unit": "fraction"}))
    return out


if __name__ == "__main__":
    main()
