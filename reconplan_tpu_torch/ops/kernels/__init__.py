"""Hand-written CUDA kernels of the brick TSDF path, with their plain
PyTorch versions and launch counters.

=====  ========================  ===================================
 K     wrapper                   replaces
=====  ========================  ===================================
 K1    ``brick_integrate``       ``tsdf_brick.py:682`` ``_integrate_kernel_dyn``
 K2    ``active_mask``           ``tsdf_brick.py:278`` ``_active_mask_kernel``
 K3    ``brick_integrate_fixed`` ``tsdf_brick.py:503`` ``_integrate_kernel``
 K4/5  ``brick_ablate``          ``benchmarks/profile_brick.py:320`` / ``:75``
 K6    ``gather_probe``          ``benchmarks/probe_sublane_ops.py:35``
 K7    ``refine_bits``           no kernel: XLA ops, ``tsdf_brick.py:431``
 K8    ``occupancy_bits``        no kernel: XLA ops, ``tsdf_brick.py:215``
=====  ========================  ===================================

K1-K3 replace TPU kernels of ``reconplan_tpu/ops``, K4-K6 those of the
repo's ``benchmarks/`` folder. K7 and K8 replace eager chains of the mask
pipeline, the refine and the occupancy mip; their plain versions are
``ops/tsdf_brick._exact_frame_bits_dilated`` and
``ops/tsdf_brick._build_depth_occupancy``.
"""

from reconplan_tpu_torch.ops.kernels.active_mask import (
    active_mask,
    active_mask_reference,
)
from reconplan_tpu_torch.ops.kernels.brick_ablate import (
    brick_ablate,
    brick_ablate_reference,
)
from reconplan_tpu_torch.ops.kernels.brick_integrate import (
    brick_integrate,
    brick_integrate_reference,
)
from reconplan_tpu_torch.ops.kernels.brick_integrate_fixed import (
    brick_integrate_fixed,
    brick_integrate_fixed_reference,
)
from reconplan_tpu_torch.ops.kernels.gather_probe import (
    gather_probe,
    gather_probe_reference,
)
from reconplan_tpu_torch.ops.kernels.occupancy_bits import occupancy_bits
from reconplan_tpu_torch.ops.kernels.refine_bits import refine_bits

__all__ = [
    "active_mask",
    "active_mask_reference",
    "brick_ablate",
    "brick_ablate_reference",
    "brick_integrate",
    "brick_integrate_fixed",
    "brick_integrate_fixed_reference",
    "brick_integrate_reference",
    "gather_probe",
    "gather_probe_reference",
    "occupancy_bits",
    "refine_bits",
]
