"""DTW-gap experiment: where does GRR's tracking-fidelity deficit vs
Newton/RelaxedIK come from, and does greedy re-seeding close it?

Round-4 VERDICT (weak #4): GRR's aggregate DTW is 3-5x Newton's wherever
both survive (kinova 0.151 vs 0.048; ur10 rvy 0.297 vs 0.117), and asks
whether the gap is inherent to roadmap-following or an artifact of this
rebuild stepping through roadmap-seeded IK solutions on smooth ticks.

Two instruments, GRR arm only (the other arms' numbers are already
landed in benchmarks/results/*.json from the full protocol):

  1. per-tick workspace deviation attributed to the regime that handled
     the tick (``grr_teleop_batch`` stats ``deviation_by_class_mm``):
     smooth continuous steps vs roadmap plan-following vs rescue
     re-entry. If detour ticks dominate the deviation mass, the gap is
     the price of the global structure (inherent); if smooth ticks do,
     it is seeding granularity (fixable).

  2. the fix candidate: ``greedy_seed=True`` adds the CURRENT config as
     one extra IK restart on every tick (reference GRR seeds from the
     roadmap only, ``resolution.py:299-330``). On ticks where greedy
     continuation is feasible it wins the min-joint-motion selection and
     tracks like the Newton arm; roadmap seeds still carry the rest.

Same trajectories as the landed tables (generator seed 7, first N of
each kind), so rows are comparable across files.

Port of the repo's ``benchmarks/dtw_gap.py``, with its flags and lines
plus ``--device`` (default: the CUDA card; the JAX script forced the
CPU) and the output's ``"device"``. ``--out`` refuses a path under the
committed ``benchmarks/results/``, which holds the JAX package's tables.
The port's GRR engine writes back every host repair of a tick (the JAX
engine's padded write loses one), so its rows are held against those
tables within a tolerance, not equal to them.

Usage:
  python -m reconplan_tpu_torch.benchmarks.dtw_gap \\
      --graph-dir graph/ur10/rot_variable_yaw \\
      --rotation-type rot_variable_yaw --per-kind 25 --out dtw_gap.json
"""

import argparse
import json
import os
import time

import numpy as np

from reconplan_tpu_torch.benchmarks import device_label, refuse_under


def main(argv=None):
    """Print one line an arm and kind; return the JSON document."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--robot", default="ur10")
    ap.add_argument("--rotation-type", default="rot_variable_yaw")
    ap.add_argument("--graph-dir", default="graph/ur10/rot_variable_yaw")
    ap.add_argument("--per-kind", type=int, default=25)
    ap.add_argument("--kinds", default="line_random,circle_random")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    args = ap.parse_args(argv)
    if args.out:
        refuse_under(args.out, os.path.join("benchmarks", "results"))

    from reconplan_tpu_torch.grr import RedundancyResolution
    from reconplan_tpu_torch.grr.experiment import generate_trajectories
    from reconplan_tpu_torch.grr.teleop_batch import (
        analyze_arm,
        cold_starts,
        grr_teleop_batch,
        summarize,
    )
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin.robot import make_robot

    opts = load_problem(args.robot, args.rotation_type)
    robot = make_robot(opts, device=args.device)
    label = device_label(robot.device)
    res = RedundancyResolution(robot, robot.device)
    res.load_workspace_graph(os.path.join(args.graph_dir, "workspace.npz"))
    res.load_resolution_graph(os.path.join(args.graph_dir, "resolution.npz"))
    sv = os.path.join(args.graph_dir, "solver.npz")
    if os.path.exists(sv):
        res.load_solver_graph(sv)

    out = {"config": vars(args), "device": label, "kinds": {}}
    for kind in [k.strip() for k in args.kinds.split(",") if k.strip()]:
        trajs = np.stack(generate_trajectories(
            robot, kind=kind, n_trajectories=args.per_kind, seed=7
        ))
        q0s, alive = cold_starts(res, trajs)
        rows = {}
        for label_, greedy in (("roadmap_seeds", False),
                               ("greedy_seed", True)):
            t0 = time.time()
            c, st = grr_teleop_batch(
                res, trajs, q0s, alive, greedy_seed=greedy, verbose=False
            )
            summ = summarize(analyze_arm(robot, trajs, c))
            rows[label_] = {
                "success_rate": summ["success_rate"],
                "mean_dtw": summ["mean_dtw"],
                "mean_ratio": summ["mean_ratio"],
                "deviation_by_class_mm": st["deviation_by_class_mm"],
                "deviation_ticks": st["deviation_ticks"],
                "wall_s": round(time.time() - t0, 1),
            }
            print(f"[{kind}] {label_}: success {summ['success_rate']:.2f} "
                  f"dtw {summ['mean_dtw'] if summ['mean_dtw'] is None else round(summ['mean_dtw'], 4)} "
                  f"dev/tick mm {st['deviation_by_class_mm']} "
                  f"ticks {st['deviation_ticks']} "
                  f"({rows[label_]['wall_s']}s)", flush=True)
        out["kinds"][kind] = rows

    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
