"""Reads of the card by the host per stitched picture (the program's
``host.reads`` under ``stitch_sequence``: the ICPs' live-flag checks, the
neighbour searches' tie checks, the outlier step's count and the
sequence's results)."""

from perfcells.program import per_unit


def read(ctx):
    return per_unit(ctx, "host.reads", "frames")
