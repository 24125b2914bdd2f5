"""Idle share of the card over the traced window of a stitch cell."""

from perfcells.metrics_lib import device_idle as read  # noqa: F401
