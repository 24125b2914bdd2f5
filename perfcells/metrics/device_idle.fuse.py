"""Idle share of the card over the traced window of a fusion cell."""

from perfcells.metrics_lib import device_idle as read  # noqa: F401
