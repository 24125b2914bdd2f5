"""Read a cell's compared numbers for the program and for its control,
seed after seed, in one process: the readings its limits are set from.

    python3 -m perfcells.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed: the cell's set-up, a window of ``--seconds`` at the cell's
own size and load, then the judge twice: once over what the program
produced, once over the control in the program's place (the plain
reference computed in bfloat16 for a fusion cell; the program's joint
answers rounded to bfloat16 for a cell judged by forward kinematics).
Prints one JSON line a seed and one of the largest program reading and
the smallest control reading of each number. The benchmark's own runs
never run this.
"""

import argparse
import gc
import json
import sys

import torch

from perfcells import run as harness
from perfcells.common import no_span


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.cache_env()
    bench = harness.Bench()
    cell = bench.cell(args.workload)
    config = bench.config(bench.workload(args.workload)["config"])
    driver = bench.driver(cell["driver"])
    device = torch.device(args.device)
    prog, ctrl = {}, {}
    for seed in args.seeds:
        s = driver.setup(cell, config, seed, device)
        out = driver.window(s, args.seconds, no_span)
        driver.release(s)
        gc.collect()
        _, work = driver.judge(s, out)
        _, cwork = driver.judge(s, out, control=True)
        p, c = work["readings"], cwork["readings"]
        for k in p:
            prog[k] = max(prog.get(k, float("-inf")), p[k])
            ctrl[k] = min(ctrl.get(k, float("inf")), c[k])
        print(json.dumps({"seed": seed, "program": p, "control": c,
                          "metrics": out["metrics"],
                          "counts": out["counts"]}), flush=True)
        del s
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "program_max": prog, "control_min": ctrl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
