"""Host launch and copy calls per stitched picture (every picture of
every whole sequence in the traced window)."""

from perfcells.metrics_lib import launches_per


def read(ctx):
    return launches_per(ctx, "frames")
