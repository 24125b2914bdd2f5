"""Hand-written CUDA kernels of the brick TSDF path, with their plain
PyTorch versions and launch counters.

=====  ========================  ===================================
 K     wrapper                   replaces (reconplan_tpu/ops/...)
=====  ========================  ===================================
 K1    ``brick_integrate``       ``tsdf_brick.py:682`` ``_integrate_kernel_dyn``
 K2    ``active_mask``           ``tsdf_brick.py:278`` ``_active_mask_kernel``
 K3    ``brick_integrate_fixed`` ``tsdf_brick.py:503`` ``_integrate_kernel``
=====  ========================  ===================================
"""

from reconplan_tpu_torch.ops.kernels.active_mask import (
    active_mask,
    active_mask_reference,
)
from reconplan_tpu_torch.ops.kernels.brick_integrate import (
    brick_integrate,
    brick_integrate_reference,
)
from reconplan_tpu_torch.ops.kernels.brick_integrate_fixed import (
    brick_integrate_fixed,
    brick_integrate_fixed_reference,
)

__all__ = [
    "active_mask",
    "active_mask_reference",
    "brick_integrate",
    "brick_integrate_fixed",
    "brick_integrate_fixed_reference",
    "brick_integrate_reference",
]
