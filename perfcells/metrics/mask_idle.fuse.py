"""% of the traced window in which the card sat idle while the host was
inside ``chunk_active_set`` (the program's ``tsdf.active_set`` spans,
which hold its stages: occupancy mip, K2, refine, compaction)."""

from perfcells import program


def read(ctx):
    rec = program.recorded()
    if rec is None or ctx.trace.window_ns <= 0:
        return None
    iv = program.intervals(rec, "tsdf.active_set")
    if not len(iv):
        return None
    return 100.0 * program.idle_inside(ctx.trace, iv) / ctx.trace.window_ns
