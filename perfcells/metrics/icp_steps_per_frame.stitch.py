"""ICP steps the host issued per stitched picture (the program's
``icp.steps``: every step of ``ops/icp._solve``, the frozen ones between
two looks at the live flag included)."""

from perfcells.program import per_unit


def read(ctx):
    return per_unit(ctx, "icp.steps", "frames")
