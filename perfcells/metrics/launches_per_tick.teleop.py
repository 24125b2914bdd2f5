"""Host launch and copy calls per teleop tick."""

from perfcells.metrics_lib import launches_per


def read(ctx):
    return launches_per(ctx, "ticks")
