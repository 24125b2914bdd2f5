"""Reads of the card by the host per teleop tick (the program's
``host.reads``: every ``to_host`` under ``teleop_solve``, the IK's
early-exit checks among them)."""

from perfcells.program import per_unit


def read(ctx):
    return per_unit(ctx, "host.reads", "ticks")
