"""Host launch and copy calls per fused frame."""

from perfcells.metrics_lib import launches_per


def read(ctx):
    return launches_per(ctx, "frames")
