"""Device and profiling helpers."""

from reconplan_tpu_torch.utils.device import (
    card_summary,
    resolve_device,
    scalar_tensor,
)
from reconplan_tpu_torch.utils.profiling import StageTimer, maybe_trace, trace

__all__ = ["StageTimer", "card_summary", "maybe_trace", "resolve_device",
           "scalar_tensor", "trace"]
