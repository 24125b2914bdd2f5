"""Reads of the card by the host per planned waypoint (the program's
``host.reads`` under ``grr_plan``: the IK's early-exit checks, the seed
ranking's tie checks and the path's results)."""

from perfcells.program import per_unit


def read(ctx):
    return per_unit(ctx, "host.reads", "waypoints")
