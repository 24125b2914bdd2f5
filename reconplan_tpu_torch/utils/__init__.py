"""Device helpers."""

from reconplan_tpu_torch.utils.device import (
    card_summary,
    resolve_device,
    scalar_tensor,
)

__all__ = ["card_summary", "resolve_device", "scalar_tensor"]
