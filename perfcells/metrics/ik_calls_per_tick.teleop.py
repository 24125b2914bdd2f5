"""Batched IK solves (``kin/ik.dls_ik_batch``) per teleop tick (the
program's ``ik.calls``)."""

from perfcells.program import per_unit


def read(ctx):
    return per_unit(ctx, "ik.calls", "ticks")
