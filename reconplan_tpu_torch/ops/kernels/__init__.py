"""Hand-written CUDA kernels of the brick TSDF path and the ICP step,
each behind one wrapper module with its plain PyTorch version.

=====  ================================  ======================================
 K     wrapper, counter                  replaces
=====  ================================  ======================================
 K1    ``brick_integrate``               ``tsdf_brick.py:682``
       ``kernel.brick_integrate``        ``_integrate_kernel_dyn``
 K2    ``active_mask``                   ``tsdf_brick.py:278``
       ``kernel.active_mask``            ``_active_mask_kernel``
 K3    ``brick_integrate_fixed``         ``tsdf_brick.py:503``
       ``kernel.brick_integrate_fixed``  ``_integrate_kernel``
 K4/5  ``brick_ablate``                  ``benchmarks/profile_brick.py:320``
       ``kernel.brick_ablate.<arm>``     / ``:75``
 K6    ``gather_probe``                  ``benchmarks/probe_sublane_ops.py:35``
       ``kernel.gather_probe.<arm>``
 K7    ``refine_bits``                   no kernel: XLA ops,
       ``kernel.refine_bits``            ``tsdf_brick.py:431``
 K8    ``occupancy_bits``                no kernel: XLA ops,
       ``kernel.occupancy_bits``         ``tsdf_brick.py:215``
 K9    ``icp_step``                      no kernel: XLA ops, ``icp.py``
       ``kernel.icp_step``               ``icp_point_to_plane``,
                                         ``colored_icp``
=====  ================================  ======================================

K1-K3 replace TPU kernels of ``reconplan_tpu/ops``, K4-K6 those of the
repo's ``benchmarks/`` folder. K7 and K8 replace eager chains of the mask
pipeline, the refine and the occupancy mip; K9 the eager Gauss-Newton
step of the point-to-plane and colored ICP solves, whose plain step
``ops/icp`` hands to the wrapper (it searches with ``ops/nn``).

Each wrapper ``<name>`` is the kernel's one seam: it checks its
arguments, takes ``<name>_reference``, the plain version beside it, for
CPU tensors, launches the kernel for CUDA tensors and raises for any
other device. It types its entry point of ``csrc/<name>.cu`` where it
calls it (``build.entry``) and counts each call that launched in its
counter (``utils.profiling.count``: K3 counts its launches, one for each
32 frames), which a ``profiling.recording()`` or a profiler session
reads. A new kernel is its ``.cu`` source, its wrapper here and its call
site, and their tests.
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
from reconplan_tpu_torch.ops.kernels.icp_step import (
    icp_step,
    icp_step_reference,
)
from reconplan_tpu_torch.ops.kernels.occupancy_bits import (
    occupancy_bits,
    occupancy_bits_reference,
)
from reconplan_tpu_torch.ops.kernels.refine_bits import (
    refine_bits,
    refine_bits_reference,
)

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
    "icp_step",
    "icp_step_reference",
    "occupancy_bits",
    "occupancy_bits_reference",
    "refine_bits",
    "refine_bits_reference",
]
