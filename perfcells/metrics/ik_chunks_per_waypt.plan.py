"""Chunks of ``CHECK_EVERY`` IK iterations per planned waypoint (the
program's ``ik.chunks``: each CUDA graph replay, and each eager chunk)."""

from perfcells.program import per_unit


def read(ctx):
    return per_unit(ctx, "ik.chunks", "waypoints")
