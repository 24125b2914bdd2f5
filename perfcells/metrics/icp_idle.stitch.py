"""% of the traced window in which the card sat idle while the host was
inside an ICP solve (the program's ``icp.*`` spans: each point-to-plane
and colored solve of ``ops/icp``, its host-read loop control included)."""

from perfcells import program


def read(ctx):
    rec = program.recorded()
    if rec is None or ctx.trace.window_ns <= 0:
        return None
    iv = program.intervals(rec, {n for n, _, _ in rec.spans
                                 if n.startswith("icp.")})
    if not len(iv):
        return None
    return 100.0 * program.idle_inside(ctx.trace, iv) / ctx.trace.window_ns
