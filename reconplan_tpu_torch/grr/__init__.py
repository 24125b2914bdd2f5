"""Global redundancy resolution. Ported so far: the Cartesian path
generators (``grr.paths``)."""

from reconplan_tpu_torch.grr.paths import (
    arc_interpolate,
    get_arc_path,
    get_linear_path,
    linear_interpolate,
    scan_arc,
)

__all__ = [
    "arc_interpolate",
    "get_arc_path",
    "get_linear_path",
    "linear_interpolate",
    "scan_arc",
]
