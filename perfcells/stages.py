"""One traced run of a cell, laid out by the program's stages.

    python3 -m perfcells.stages --workload <cell> --seed <n> --seconds <s>

Runs ``perfcells.run`` with ``--trace 1`` and prints its line with more
keys: ``counters`` (the program's), ``spans`` (per program span: calls,
host seconds, self seconds, seconds of card idle with the span innermost,
launch calls inside), ``idle_gaps_by_stage`` (each idle gap of the card
put down to the innermost open span, the harness's or the program's, as
``breakdown`` puts it down to the harness's alone), ``harness_idle_moved``
(the share of the idle put down to a harness span that a program span
now takes), ``tail_stages`` (for each harness span called 20 times or
more, the program's self seconds by span inside those at or above the
95th percentile of their durations: what the tail is made of), ``mask_launches_per_chunk`` (launch calls inside
``tsdf.active_set`` per ``tsdf.chunk``) and ``clock_skew_ns`` (the median,
largest and smallest gap between a program span's ``time.time_ns()``
start and its profiler range's). The numbers of ``metrics`` are the run's own.
"""

from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import numpy as np

from perfcells import program
from perfcells import run as harness
from perfcells import trace as tr


def _launch_and_range_starts(prof):
    """Host start ns of every launch call, and of every program range by
    name, from the profiler's raw events."""
    from torch.autograd import DeviceType

    launches, ranges = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            continue
        name = e.name()
        if name.startswith("reconplan:"):
            ranges.setdefault(name[len("reconplan:"):], []).append(
                e.start_ns())
        elif name.startswith("cu") and any(c in name
                                           for c in tr.LAUNCH_CALLS):
            launches.append(e.start_ns())
    return np.asarray(launches, dtype=np.int64), ranges


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    seen = {}
    reduce = tr.reduce

    def reduce_and_keep(prof, t0_ns, t1_ns):
        seen["launch_ns"], seen["ranges"] = _launch_and_range_starts(prof)
        seen["t0"], seen["t1"] = t0_ns, t1_ns
        seen["trace"] = reduce(prof, t0_ns, t1_ns)
        return seen["trace"]

    tr.reduce = reduce_and_keep
    try:
        code, result = harness.run(argv + ["--trace", "1"])
    finally:
        tr.reduce = reduce
    rec = program.recorded()
    if result is None or rec is None or "trace" not in seen:
        print(json.dumps({"code": code, "recorded": rec is not None}))
        return code or 1
    trace = seen["trace"]
    # a counter the window never reached reads 0
    result["counters"] = dict({"ik.graph_captures": 0}, **rec.counters)
    result["spans"] = program.table(trace, rec, seen["launch_ns"])
    gaps = program.stage_gaps(trace, rec, seen["t0"], seen["t1"])
    result["idle_gaps_by_stage"] = sorted(
        ([k, v / 1e9] for k, v in gaps.items()), key=lambda kv: -kv[1])
    harness_names = set(trace.spans)
    before = sum(v for k, v in trace.gaps.items() if k in harness_names)
    after = sum(v for k, v in gaps.items() if k in harness_names)
    result["harness_idle_moved"] = 1 - after / before if before else None
    result["tail_stages"] = {}
    for name, iv in trace.spans.items():
        tail = program.tail_windows(trace, name)
        if len(iv) < 20 or tail is None:
            continue
        rows = program.table(trace, SimpleNamespace(
            spans=program.inside(rec, tail)))
        result["tail_stages"][name] = {
            "spans": len(tail),
            "host_s": int((tail[:, 1] - tail[:, 0]).sum()) / 1e9,
            "self_s": {k: v["self_s"] for k, v in sorted(
                rows.items(), key=lambda kv: -kv[1]["self_s"])}}
    chunks = result["spans"].get("tsdf.chunk", {}).get("calls", 0)
    if chunks:
        result["mask_launches_per_chunk"] = \
            result["spans"]["tsdf.active_set"]["launches"] / chunks
    skew = []
    for name, starts in seen["ranges"].items():
        mine = np.sort(program.intervals(rec, name)[:, 0])
        theirs = np.sort(np.asarray(starts, dtype=np.int64))
        if len(mine) == len(theirs):
            skew.append(mine - theirs)
    skew = np.concatenate(skew) if skew else np.zeros(0, np.int64)
    result["clock_skew_ns"] = ([int(np.median(skew)), int(skew.max()),
                                int(skew.min())] if len(skew) else None)
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
