"""% of the host time of the slowest ticks spent planning: of the
harness's ``teleop.tick`` spans at or above the window's 95th percentile
of their durations, the share inside the program's ``grr.plan`` spans
(``teleop_solve``'s roadmap plan when the step is not continuous)."""

from perfcells import program
from perfcells.trace import clip_length, merge


def read(ctx):
    rec = program.recorded()
    tail = program.tail_windows(ctx.trace, "teleop.tick")
    if rec is None or tail is None:
        return None
    plans = merge(program.intervals(rec, "grr.plan"))
    inside = clip_length(plans, tail) if len(plans) else 0
    return 100.0 * inside / int((tail[:, 1] - tail[:, 0]).sum())
