"""Share of the roofline of the TSDF update inside the fusion calls.

The bound is the reference's count of the scan's work (the bricks each
frame updates in band, their two planes read and written once, every
depth pixel read once, 42 f32 operations a voxel-frame) against the
H100's published peaks; the time is the union of the card's busy
intervals inside the harness's ``fuse.integrate`` spans, which end with a
synchronise. It reads the same work whatever kernels do it."""


def read(ctx):
    busy = ctx.trace.span_busy_ns("fuse.integrate") / 1e9
    scans = len(ctx.trace.spans.get("fuse.integrate", ()))
    if busy <= 0 or scans == 0:
        return None
    return 100.0 * ctx.work["bound_s"] * scans / busy
